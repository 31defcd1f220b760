"""Host time against device time of the flash-attention kernels, on one card.

    python -m wavjepa_tpu_torch.tools.flash_host [B,H,T,d ...]

At each bf16 shape (default: the training microbatches and the student
encoder's full batch) it measures, for the forward and the backward:
  * the time a call takes on the host clock, without waiting for the card
    (``host_ms``: the Python wrapper; ``c_host_ms``: the C entry point
    alone, which encodes the TMA maps and launches);
  * the kernel's own time on the card, from ``torch.profiler``
    (``device_ms``);
  * back-to-back wrapper calls timed with CUDA events (``event_ms``), as
    ``chip_smoke.py`` times them.
Where ``host_ms`` exceeds ``device_ms`` the card waits for the host, and
``event_ms`` measures the host. Prints the card's name and power limit and
one JSON object per shape.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

DEFAULT_SHAPES = [(16, 12, 88, 64), (64, 12, 128, 32), (256, 12, 88, 64)]


def _event_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, iters: int = 200) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e3


def _device_ms(fn, name: str, iters: int = 20) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for event in prof.key_averages():
        if name in event.key:
            total += getattr(event, "device_time_total", 0) or getattr(event, "cuda_time_total", 0)
            count += event.count
    return total / max(count, 1) / 1e3


def measure(b: int, h: int, t: int, d: int) -> dict:
    from wavjepa_tpu_torch.ops import flash_attention as fam

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b, h, t, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    mask = torch.rand(b, t, generator=gen, device="cuda") < 0.3
    _, stats = fam.flash_attention_fwd(q, k, v, mask, True)
    o, dq, dk, dv = (torch.empty_like(q) for _ in range(4))
    dsum = torch.empty(b, h, t, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1 / math.sqrt(d)
    ptrs = [x.data_ptr() for x in (q, k, v, mask)]
    calls = {
        "fwd": (lambda: fam.flash_attention_fwd(q, k, v, mask),
                lambda: fam._fwd_fn()(*ptrs, o.data_ptr(), None, b, h, t, d, 1, scale, stream),
                "flash_attention_fwd_bf16"),
        "bwd": (lambda: fam.flash_attention_bwd(q, k, v, mask, do, stats),
                lambda: fam._bwd_fn()(*ptrs, do.data_ptr(), stats.data_ptr(), dsum.data_ptr(),
                                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, d,
                                      1, scale, stream),
                "bwd_"),
    }
    row = {"shape": [b, h, t, d]}
    for which, (wrapper, c_call, kernel) in calls.items():
        row[which] = {"host_ms": _host_ms(wrapper), "c_host_ms": _host_ms(c_call),
                      "device_ms": _device_ms(wrapper, kernel), "event_ms": _event_ms(wrapper)}
    return row


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("flash_host needs a CUDA card", file=sys.stderr)
        return 1
    shapes = [tuple(int(x) for x in a.split(",")) for a in argv] or DEFAULT_SHAPES
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for shape in shapes:
        print(json.dumps(measure(*shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
