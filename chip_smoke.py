#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. build    compile every CUDA source of ``wavjepa_tpu_torch/csrc`` with nvcc
            (one process each, all at once) and print the card and its power
            limit;
2. kernels  hold each kernel against its plain PyTorch version on the card at
            the shapes the serving path gives it, in bf16 and f32, and time
            kernel, plain version, one PyTorch library call, and the bound;
3. serve    load the HEAR runtime at base width with seeded random weights
            and answer requests: scene embeddings of 8 clips of 10 s,
            timestamp embeddings of a ragged batch (1.0, 2.01, 4.3, 30 s) and
            of one clip of exactly one window (32159 samples), and the whole-clip config (T=999) on
            4 clips of 10 s; check shapes, finiteness and that the attention
            kernel ran exactly once per encoder layer per request;
4. parity   the same weights in f32 on the card (TF32 off) and on the CPU, and
            bf16 on the card against that f32 result.

It imports nothing of JAX. The last two lines of standard output are the
``kernels`` JSON line and ``{"ok": true, "device": {...}}``; the full record
goes to ``build/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak
BF16_ATOL = 1e-2   # bf16 output: ~1 ulp at |o| < 2, plus P rounded in another order
F32_ATOL = 1e-5    # f32: the same maths, summed in another order
CARD_CPU_ATOL = 1e-3  # f32 model, card vs CPU, 12 layers of reordered sums
BF16_REL_FRO = 5e-2   # bf16 model vs f32 model on the card, relative Frobenius

# (name, B, H, T): the windowed batch of 8 clips of 10 s (40 windows of 200
# tokens), the whole-clip batch of 4 clips of 10 s (each gains a fully padded
# second window: 8 rows of 999), 4 whole clips, and the large model's heads
ATTN_SHAPES = [
    ("windowed", 40, 12, 200),
    ("whole_clip", 8, 12, 999),
    ("whole_clip_b4", 4, 12, 999),
    ("large_windowed", 4, 16, 200),
]
HEAD_DIM = 64


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(b: int, h: int, t: int, d: int, elem: int) -> tuple[float, str]:
    """Least time for the work: q, k, v read once, o written once, the mask
    read once, against 4·B·H·T²·d operations (QKᵀ and PV)."""
    bytes_moved = 4 * b * h * t * d * elem + b * t
    ops = 4 * b * h * t * t * d
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_inputs(b, h, t, d, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(b, h, t, d, generator=g) for _ in range(3))
    mask = torch.rand(b, t, generator=g) < 0.3
    mask[0] = True    # a fully masked row: uniform weights over the T keys
    mask[-1] = False  # a clean row
    return [x.to(device) for x in (q, k, v, mask)]


def phase_kernels(fa) -> list[dict]:
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention_reference

    results = []
    for i, (name, b, h, t) in enumerate(ATTN_SHAPES):
        q, k, v, mask = attention_inputs(b, h, t, HEAD_DIM, seed=i, device="cuda")
        row = {"shape": name, "B": b, "H": h, "T": t, "d": HEAD_DIM}
        for dtype, atol, key in ((torch.float32, F32_ATOL, "f32"),
                                 (torch.bfloat16, BF16_ATOL, "bf16")):
            qq, kk, vv = (x.to(dtype).contiguous() for x in (q, k, v))
            out = fa(qq, kk, vv, mask)
            ref = flash_attention_reference(qq, kk, vv, mask)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            if not torch.isfinite(out).all() or not err <= atol:
                raise AssertionError(f"{name} {key}: max |kernel - plain| {err} > {atol}")
            row[f"max_abs_err_{key}"] = err
            if dtype == torch.float32:  # fully masked row = mean of v over real keys
                uni = vv[0].mean(dim=1, keepdim=True).expand_as(vv[0])
                uerr = (out[0] - uni).abs().max().item()
                if not uerr <= 1e-5:
                    raise AssertionError(f"{name}: fully masked row not uniform ({uerr})")
        qq, kk, vv = (x.to(torch.bfloat16).contiguous() for x in (q, k, v))
        keep = ~mask[:, None, None, :]
        row["ms"] = cuda_ms(lambda: fa(qq, kk, vv, mask))
        row["plain_ms"] = cuda_ms(lambda: flash_attention_reference(qq, kk, vv, mask))
        row["library_ms"] = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qq, kk, vv, attn_mask=keep)
        )
        row["bound_ms"], row["bound_by"] = attention_bound(b, h, t, HEAD_DIM, 2)
        print(f"[kernels] flash_attention_fwd {name} (B={b}, H={h}, T={t}, d={HEAD_DIM}): "
              f"err f32 {row['max_abs_err_f32']:.3g} bf16 {row['max_abs_err_bf16']:.3g}; "
              f"bf16 kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"sdpa {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        results.append(row)
    return results


def make_clips(seconds: list[float], seed: int, sr: int = 16000) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(int(round(s * sr))).astype(np.float32) * 0.1
            for s in seconds]


def phase_serve(fa, load_model, chunk_padding) -> tuple[dict, object]:
    windowed = load_model("", model_size="base", seed=0)
    whole = load_model("", model_size="base", process_seconds=10.0, seed=0)
    layers = windowed.config.encoder_layers
    requests = [
        ("scene_8x10s", windowed, "scene", make_clips([10.0] * 8, 1)),
        ("timestamps_ragged", windowed, "timestamps", make_clips([1.0, 2.01, 4.3, 30.0], 2)),
        # exactly one window of samples: a whole padding window follows it
        ("timestamps_exact_window", windowed, "timestamps",
         make_clips([windowed.unit_frames / 16000], 3)),
        ("whole_clip_4x10s", whole, "timestamps", make_clips([10.0] * 4, 4)),
    ]

    def run(rt, kind, clips):
        if kind == "scene":
            return rt.get_scene_embeddings(clips), None
        return rt.get_timestamp_embeddings(clips)

    record = {}
    fa.launches = 0  # the main path's run starts here
    for name, rt, kind, clips in requests:
        before = fa.launches
        emb, ts = run(rt, kind, clips)
        torch.cuda.synchronize()
        if fa.launches - before != layers:
            raise AssertionError(f"{name}: {fa.launches - before} kernel launches, "
                                 f"expected {layers} (one per encoder layer)")
        n = max(len(c) for c in clips)
        _, n_chunks, cut_off, _ = chunk_padding(n, rt.unit_frames, rt.sample_rate,
                                                rt.output_steps)
        width = rt.embedding_size
        if kind == "scene":
            expect = (len(clips), width)
        else:
            expect = (len(clips), cut_off, width)
            if tuple(ts.shape) != expect[:2]:
                raise AssertionError(f"{name}: timestamps {tuple(ts.shape)} != {expect[:2]}")
            step = n / rt.sample_rate / cut_off * 1000.0
            if ts[0, 0].item() != 0.0 or abs(ts[0, 1].item() - step) > 1e-9:
                raise AssertionError(f"{name}: timestamps not a {step}-ms grid")
        if tuple(emb.shape) != expect or emb.dtype != torch.float32:
            raise AssertionError(f"{name}: embeddings {tuple(emb.shape)} != {expect}")
        if not torch.isfinite(emb).all():
            raise AssertionError(f"{name}: non-finite embeddings")
        if n % rt.unit_frames == 0 and n_chunks != n // rt.unit_frames + 1:
            raise AssertionError(f"{name}: exact multiple of the window lacks its pad window")
        times = []
        for i in range(12):
            t0 = time.perf_counter()
            run(rt, kind, clips)
            torch.cuda.synchronize()
            if i >= 2:  # two warm-up requests
                times.append((time.perf_counter() - t0) * 1e3)
        record[name] = {
            "shape": list(emb.shape), "windows": len(clips) * n_chunks,
            "tokens_per_window": rt.output_steps,
            "p50_ms": statistics.median(times), "n": len(times),
        }
        print(f"[serve] {name}: out {tuple(emb.shape)}, {len(clips) * n_chunks} windows of "
              f"{rt.output_steps} tokens, p50 {record[name]['p50_ms']:.3f} ms "
              f"over {len(times)} requests", flush=True)
    launches = fa.launches  # read just after the main path
    expected = layers * 13 * len(requests)
    if launches != expected:
        raise AssertionError(f"main path launched the kernel {launches} times, not {expected}")
    record["launches"] = launches
    record["launches_per_encoder_forward"] = layers
    return record, windowed


def phase_parity(load_model, JEPAConfig, bf16_runtime) -> dict:
    cfg = JEPAConfig(dtype=torch.float32)
    clips = make_clips([2.01, 1.0], 5)
    card = load_model("", config=cfg, device="cuda", seed=0)
    cpu = load_model("", config=cfg, device="cpu", seed=0)
    e_card = card.get_timestamp_embeddings(clips)[0].cpu()
    e_cpu = cpu.get_timestamp_embeddings(clips)[0]
    err = (e_card - e_cpu).abs().max().item()
    if not torch.allclose(e_card, e_cpu, atol=CARD_CPU_ATOL, rtol=CARD_CPU_ATOL):
        raise AssertionError(f"f32 card vs CPU: max abs err {err}")
    e_bf16 = bf16_runtime.get_timestamp_embeddings(clips)[0].cpu()
    rel = (torch.linalg.norm(e_bf16 - e_card) / torch.linalg.norm(e_card)).item()
    if not rel <= BF16_REL_FRO:
        raise AssertionError(f"bf16 vs f32 on the card: relative Frobenius {rel} > {BF16_REL_FRO}")
    print(f"[parity] f32 card vs CPU max abs err {err:.3g} (atol {CARD_CPU_ATOL}); "
          f"bf16 vs f32 card relative Frobenius {rel:.4g} (limit {BF16_REL_FRO})", flush=True)
    return {"f32_card_vs_cpu_max_abs_err": err, "bf16_vs_f32_rel_fro": rel,
            "shape": list(e_card.shape)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this runs on the card",
              file=sys.stderr)
        return 1
    from wavjepa_tpu_torch.api.runtime import chunk_padding, load_model
    from wavjepa_tpu_torch.models.jepa import JEPAConfig
    from wavjepa_tpu_torch.ops import _build
    from wavjepa_tpu_torch.ops.flash_attention import flash_attention as fa

    # f32 comparisons hold the maths in full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    card = card_line()
    print(f"[build] {len(_build.build_logs)} CUDA sources built in {build_s:.2f} s "
          f"for {torch.cuda.get_device_name(0)}", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    kernel_rows = phase_kernels(fa)
    serve, bf16_runtime = phase_serve(fa, load_model, chunk_padding)
    parity = phase_parity(load_model, JEPAConfig, bf16_runtime)

    head = kernel_rows[0]  # the windowed HEAR batch, the default serving shape
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "wavjepa_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "wavjepa_tpu/ops/flash_attention.py:39",
        "launches": serve["launches"],
        "max_abs_err": head["max_abs_err_bf16"],
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": kernel_rows,
    }]
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "build_s": build_s, "kernels": kernels, "serve": serve,
                   "parity": parity, "torch": torch.__version__,
                   "cuda": torch.version.cuda}, f, indent=1)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
