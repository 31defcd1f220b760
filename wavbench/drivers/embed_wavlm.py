"""The WavLM embed driver: closed-loop requests of whole utterances to the
port's WavLM serving entry.

Set-up draws the benchmark's seeded WavLM weights under ``transformers``'
names (``reference/wavlm.make_weights``), loads them into
``api/runtime.RuntimeWavLM`` through the port's own loader
(``api/convert.state_dict_from_hf_wavlm``), in the configuration's serving
dtype, draws the pool of requests (``request_pool``) and sends each once,
which warms every padded length the window will send. In the window one
client sends the pool's requests in turn, each ``get_scene_embeddings``
with its result copied to the host, timed from the call until the
embeddings are there, until ``seconds`` have passed. A traced run profiles
``trace_requests`` more requests (the pool once over) with the program's
spans and counters recorded (``count/tail.py``). Then a sample of the
window's requests, drawn from the seed with a request holding the 35-s
utterance among them, is embedded again by the plain reference, each
utterance alone at its own length, and compared utterance by utterance
(``embed_gap``, as ``base-embed`` defines it), and the frames the runtime
averaged for each utterance against the reference's (``frames_off``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from wavbench import harness, traffic
from wavbench.count import relbias, tail
from wavbench.reference import embed as E
from wavbench.reference import wavlm as RW

SPANS = ("embed.request", "embed.prepare", "embed.h2d", "embed.encode", "wavlm.frontend",
         "wavlm.pos_conv", "wavlm.encoder")


def utterance_seconds(t: dict, rng: np.random.Generator, longest: bool) -> np.ndarray:
    """A request's durations, as ``data/synthetic.librispeech_durations``
    fits them to LibriSpeech's published mean and maximum: evenly spaced
    over the mean ± the spread, in an order drawn from the seed, the last
    of them the maximum in a request that holds it."""
    n = t["utterances_per_request"]
    d = t["mean_s"] + t["spread_s"] * ((2 * np.arange(n) + 1) / n - 1)
    if longest:
        d[-1] = t["max_s"]
    return np.round(rng.permutation(d), 3)


def request_pool(t: dict, seed: int) -> list:
    """``pool`` requests, each a list of (samples,) float32 utterances of
    ``traffic.mixture_clips``; request i holds the maximum when i is a
    multiple of ``longest_every``."""
    pool = []
    for i in range(t["pool"]):
        rng = traffic._rng(seed, 5, i)
        secs = utterance_seconds(t, rng, i % t["longest_every"] == 0)
        pool.append([traffic.mixture_clips(rng, 1, int(round(s * t["sample_rate"])),
                                           t["sample_rate"], t)[0] for s in secs])
    return pool


def serving_config(cell: dict):
    from wavjepa_tpu_torch.models.wavlm import WavLMConfig

    m, pre = cell["config"]["model"], cell["config"]["preprocessor"]
    keys = ("conv_bias", "feat_extract_norm", "hidden_size", "num_hidden_layers",
            "num_attention_heads", "intermediate_size", "layer_norm_eps",
            "num_conv_pos_embeddings", "num_conv_pos_embedding_groups", "num_buckets",
            "max_bucket_distance", "do_stable_layer_norm")
    return WavLMConfig(conv_dim=tuple(m["conv_dim"]), conv_kernel=tuple(m["conv_kernel"]),
                       conv_stride=tuple(m["conv_stride"]), **{k: m[k] for k in keys},
                       sample_rate=pre["sampling_rate"], do_normalize=pre["do_normalize"],
                       dtype=getattr(torch, cell["config"]["serving"]["dtype"]))


def reference_readings(cell: dict, seed: int, sampled: list, device, precision: str = "exact",
                       bias: bool = True) -> list:
    """Each sampled request's reference: (scene embeddings (B, D), frames)."""
    m, pre = cell["config"]["model"], cell["config"]["preprocessor"]
    w = RW.make_weights(m, seed, device)
    out = [RW.scene_embeddings(req, w, m, pre, device, precision, bias) for req in sampled]
    del w
    return out


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from wavjepa_tpu_torch.api.convert import state_dict_from_hf_wavlm
    from wavjepa_tpu_torch.api.runtime import RuntimeWavLM

    t, m = cell["traffic"], cell["config"]["model"]
    if t["clients"] != 1:
        raise ValueError(f"the embed driver sends from one client, not {t['clients']}")
    marks = {"imported": time.perf_counter() - t_start}
    weights = RW.make_weights(m, seed, device)
    runtime = RuntimeWavLM(serving_config(cell), state_dict_from_hf_wavlm(weights), device)
    del weights
    pool = request_pool(t, seed)
    marks["weights_and_pool"] = time.perf_counter() - t_start
    for req in pool:  # every padded length the window sends
        runtime.get_scene_embeddings(req).cpu()
    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    answers, lat = [], []
    failed = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds or not answers:
        k = len(answers) % t["pool"]
        c0 = time.perf_counter()
        emb = runtime.get_scene_embeddings(pool[k]).cpu()
        lat.append(time.perf_counter() - c0)
        ok = emb.shape == (len(pool[k]), m["hidden_size"]) and bool(torch.isfinite(emb).all())
        failed += not ok
        answers.append((k, emb))
    window_s = time.perf_counter() - t0
    sr = t["sample_rate"]
    lengths = [[len(x) for x in req] for req in pool]
    audio_s = sum(sum(lengths[k]) / sr for k, _ in answers)
    record = {"driver": "embed_wavlm", "requests": len(answers), "window_s": window_s,
              "audio_s": audio_s,
              "useful_flops": sum(relbias.utterance_flops(m, n) for k, _ in answers
                                  for n in lengths[k])}
    if trace:
        traced = [j % t["pool"] for j in range(t["trace_requests"])]
        with tail.profiled(device, SPANS) as tr:
            for k in traced:
                runtime.get_scene_embeddings(pool[k]).cpu()
        record["trace"] = tr
        record["traced_requests"] = len(traced)
        record["traced_audio_s"] = sum(sum(lengths[k]) / sr for k in traced)
        record["relbias_bound_s"] = sum(
            relbias.request_seconds(m, len(pool[k]), relbias.frames(max(lengths[k]), m))
            for k in traced)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rng = np.random.default_rng((seed % (2**64), 7))
    longest = next(j for j, (k, _) in enumerate(answers) if k % t["longest_every"] == 0)
    rest = [j for j in range(len(answers)) if j != longest]
    pick = [longest] + list(rng.choice(rest, min(len(rest), t["sample_requests"] - 1),
                                       replace=False))
    sampled = [pool[answers[j][0]] for j in pick]
    counted = [runtime.valid_frames(req) for req in sampled]
    del runtime
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    refs = reference_readings(cell, seed, sampled, device)
    marks["reference_s"] = time.perf_counter() - r0
    gaps = [E.answer_gap(answers[j][1].to(device), ref) for j, (ref, _) in zip(pick, refs)]
    frames_off = sum(a != b for c, (_, n) in zip(counted, refs) for a, b in zip(c, n))
    correct, checks = harness.judge({"embed_gap": max(gaps), "frames_off": frames_off},
                                    cell["workload"]["limits"])
    lat_ms = np.asarray(lat) * 1000.0
    return {"correct": correct and failed == 0, "attempted": len(answers), "failed": failed,
            "checks": checks, "memory_peak_bytes": int(memory_peak), "record": record,
            "end_to_end": {"embed_audio_s_per_s": audio_s / window_s,
                           "embed_p95_ms": float(np.percentile(lat_ms, 95)),
                           "setup_s": setup_s},
            "notes": {"marks": marks, "gaps": gaps, "requests": len(answers),
                      "trace": {k: v for k, v in record.get("trace", {}).items()
                                if k in ("trace_bytes", "read_s", "kernels", "counters")}}}
