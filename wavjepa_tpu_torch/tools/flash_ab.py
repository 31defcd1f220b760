"""The flash-attention kernels of this checkout against those of another, on
one card, in turns.

    python -m wavjepa_tpu_torch.tools.flash_ab OTHER_CHECKOUT

builds ``csrc/flash_attention_{fwd,bwd}.cu`` of both checkouts with the same
nvcc flags (the other's into a temporary directory under this checkout's
build directory), then at each shape times the forward and the backward of
each side with CUDA events in the order other, this, this, other, other,
this, and compares their outputs: equal bits, or else the largest
difference, which must stay within ``REL`` of max(1, max |other|) (two
kernels that sum in another order round bf16 differently). Both entry
points must keep the C signature of ``ops/flash_attention.py``'s bindings.
Prints the card's name and power limit, one line per kernel and shape, and
a JSON object last; exits 1 if an output differs past the tolerance.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from wavjepa_tpu_torch.ops import _build

SHAPES = [(1024, 12, 128, 32), (256, 12, 200, 64), (256, 12, 88, 64), (40, 12, 200, 64),
          # the backward's two-pass route (T > 128): WavJEPA-Nat's decoder and
          # encoder microbatches, the denoiser's student, and one row past 128
          (64, 12, 256, 32), (32, 12, 200, 64), (16, 12, 176, 64), (16, 12, 129, 64)]
ORDER = ("other", "this", "this", "other", "other", "this")
REL = 1e-2  # bf16 outputs: about one bf16 ulp of the largest value


def _bind(fwd_lib: ctypes.CDLL, bwd_lib: ctypes.CDLL):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = fwd_lib.wavjepa_flash_attention_fwd
    fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, p]
    bwd = bwd_lib.wavjepa_flash_attention_bwd
    bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, p]
    fwd.restype = bwd.restype = i
    return fwd, bwd


def _build_other(checkout: Path, name: str, out_dir: Path) -> ctypes.CDLL:
    out = out_dir / f"lib{name}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out),
           str(checkout / "wavjepa_tpu_torch" / "csrc" / f"{name}.cu")]
    subprocess.run(cmd, check=True, capture_output=True)
    return ctypes.CDLL(str(out))


def _cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(sides: dict, b: int, h: int, t: int, d: int) -> list[dict]:
    """Both kernels of both sides at (B, H, T, d) in bf16, a random mask."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    mask = torch.rand(b, t, generator=gen, device="cuda") < 0.3
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    stats = torch.empty(b, h, t, 2, device="cuda")
    dsum = torch.empty(b, h, t, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1 / math.sqrt(d)
    ptr = [a.data_ptr() for a in (q, k, v, mask)]

    def launch(side: str, which: str):
        fwd, bwd = sides[side]
        if which == "fwd":
            err = fwd(*ptr, o.data_ptr(), stats.data_ptr(), b, h, t, d, 1, scale, stream)
        else:
            err = bwd(*ptr, do.data_ptr(), stats.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(), b, h, t, d, 1, scale, stream)
        if err:
            raise RuntimeError(f"{side} flash {which}: cudaError_t {err}")

    rows = []
    for which in ("fwd", "bwd"):
        times = {"other": [], "this": []}
        for side in ORDER:
            times[side].append(_cuda_ms(lambda: launch(side, which)))
        outs = []
        for side in ("other", "this"):
            launch(side, "fwd")  # the backward reads the forward's row statistics
            launch(side, which)
            torch.cuda.synchronize()
            outs.append(torch.cat([a.flatten() for a in ((o,) if which == "fwd" else (dq, dk, dv))]))
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        limit = REL * max(1.0, outs[0].float().abs().max().item())
        rows.append({"kernel": which, "shape": [b, h, t, d], "other_ms": times["other"],
                     "this_ms": times["this"], "equal_bits": torch.equal(*outs),
                     "max_abs_diff": diff, "within_tolerance": diff <= limit})
    return rows


def main(argv: list[str]) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_ab needs a CUDA card", file=sys.stderr)
        return 1
    other = Path(argv[0]).resolve()
    names = ["flash_attention_fwd", "flash_attention_bwd"]
    _build.build_all(names)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        sides = {"this": _bind(*(_build.load(n) for n in names)),
                 "other": _bind(*(_build_other(other, n, Path(tmp)) for n in names))}
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card)
        rows = []
        for shape in SHAPES:
            for row in compare(sides, *shape):
                print(f"flash {row['kernel']} {tuple(row['shape'])}: other "
                      f"{[round(x, 4) for x in row['other_ms']]} ms, this "
                      f"{[round(x, 4) for x in row['this_ms']]} ms, equal bits "
                      f"{row['equal_bits']}, max |this - other| {row['max_abs_diff']:.3g}",
                      flush=True)
                rows.append(row)
    print(json.dumps({"card": card, "other": str(other), "rows": rows}))
    return 0 if all(r["within_tolerance"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
