"""The embed driver: closed-loop requests to the port's serving entry.

Set-up builds ``api.runtime.RuntimeJEPA`` for the configuration's serving
model (its training configuration as the runtime serves a checkpoint: no
token packing, in the configuration's dtype) with the benchmark's seeded
encoder weights, draws the request pool, and sends one request of each
duration. In the window one client (the traffic's ``clients``, which has
to be 1) sends requests one after another, each ``get_scene_embeddings``
with its result copied to the host, timed from the call until the
embeddings are there, until ``seconds`` have passed. A traced run profiles
``trace_requests`` more requests after it. Then a sample of the window's
requests, drawn from the seed with a longest one in it, is embedded again
by the plain reference and compared clip by clip.
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from wavbench import harness, traffic
from wavbench.count import attention, flops
from wavbench.drivers.train import port_config
from wavbench.reference import embed as E
from wavbench.reference import model as M


def serving_config(cell: dict, seed: int):
    cfg = port_config(cell, seed).build_model_config()
    dtype = getattr(torch, cell["config"]["model"]["dtype"])
    return dataclasses.replace(cfg, pack_encoder=None, pack_decoder=None, dtype=dtype)


def reference_gaps(cell: dict, seed: int, answers: list, pool: dict, device,
                   precision: str = "exact") -> list:
    """Each sampled answer's gap (``reference/embed.answer_gap``):
    ``answers`` are (duration, pool index, program embeddings)."""
    m = cell["config"]["model"]
    w = M.make_weights(m, seed, device, training=False)
    cache, gaps = {}, []
    for dur, i, emb in answers:
        if (dur, i) not in cache:
            cache[dur, i] = E.scene_embeddings(pool[dur][i], w, m, device,
                                               cell["traffic"]["reference_block"], precision)
        gaps.append(E.answer_gap(torch.as_tensor(emb).to(device), cache[dur, i]))
    return gaps


def windows_of(cell: dict, dur: float) -> int:
    m = cell["config"]["model"]
    return E.window_layout(int(round(dur * m["sample_rate"])), m)[1] * \
        cell["traffic"]["clips_per_request"]


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from wavjepa_tpu_torch.api.runtime import RuntimeJEPA

    t, m = cell["traffic"], cell["config"]["model"]
    if t["clients"] != 1:
        raise ValueError(f"the embed driver sends from one client, not {t['clients']}")
    weights = M.make_weights(m, seed, device, training=False)
    runtime = RuntimeJEPA(serving_config(cell, seed), state_dict=weights, device=device)
    del weights
    pool = traffic.request_pool(t, seed)
    for dur in t["durations_s"]:  # warm every shape the traffic sends
        runtime.get_scene_embeddings(pool[dur][0]).cpu()
    harness.sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    durations = traffic.request_durations(t, seed)
    answers, lat = [], []
    failed = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds or not answers:
        dur, k = next(durations), len(answers) % t["pool"]
        c0 = time.perf_counter()
        emb = runtime.get_scene_embeddings(pool[dur][k]).cpu()
        lat.append(time.perf_counter() - c0)
        ok = emb.shape == (t["clips_per_request"], m["encoder_dim"]) and bool(
            torch.isfinite(emb).all())
        failed += not ok
        answers.append((dur, k, emb))
    window_s = time.perf_counter() - t0
    served = sum(windows_of(cell, d) for d, _, _ in answers)
    record = {"driver": "embed", "requests": len(answers), "window_s": window_s,
              "windows": served, "flops_per_window": sum(flops.encoder_path_flops(m))}
    if trace:
        with harness.profiled(device) as tr:
            traced = [next(durations) for _ in range(t["trace_requests"])]
            for j, dur in enumerate(traced):
                runtime.get_scene_embeddings(pool[dur][j % t["pool"]]).cpu()
        record["trace"] = tr
        record["traced_windows"] = sum(windows_of(cell, d) for d in traced)
        record["attention_bound_s"] = attention.serve_seconds(m, record["traced_windows"])
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del runtime
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rng = np.random.default_rng((seed % (2**64), 7))
    longest = max(range(len(answers)), key=lambda j: (answers[j][0], -j))
    rest = [j for j in range(len(answers)) if j != longest]
    pick = [longest] + list(rng.choice(rest, min(len(rest), t["sample_requests"] - 1),
                                       replace=False))
    gaps = reference_gaps(cell, seed, [answers[j] for j in pick], pool, device)
    correct, checks = harness.judge({"embed_gap": max(gaps)}, cell["workload"]["limits"])
    audio_s = sum(d * t["clips_per_request"] for d, _, _ in answers)
    lat_ms = np.asarray(lat) * 1000.0
    return {"correct": correct and failed == 0, "attempted": len(answers), "failed": failed,
            "checks": checks, "memory_peak_bytes": int(memory_peak), "record": record,
            "end_to_end": {"embed_audio_s_per_s": audio_s / window_s,
                           "embed_p95_ms": float(np.percentile(lat_ms, 95)),
                           "setup_s": setup_s}}
