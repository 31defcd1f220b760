"""Profiling: ``torch.profiler`` traces, timed blocks and device memory.

Counterpart of ``wavjepa_tpu/utils/profiling.py``:

    with trace("runs/profile") as prof:   # CPU and, where present, CUDA activity
        state, m = step_fn(state, batch, generator)
    prof.key_averages()                    # time by operator and kernel

    with timed("step") as t: ...
    print(t.elapsed_ms)

``trace`` writes a Chrome/Perfetto trace (``<name>.json.gz``, open it in
https://ui.perfetto.dev or chrome://tracing) into the log directory;
``trace_summary`` reads one back: the card's busy and idle share of a window,
its kernel launches and the kernels that took the most time.
"""

from __future__ import annotations

import collections
import contextlib
import gzip
import json
import os
import re
import shutil
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from wavjepa_tpu_torch.parallel.mesh import process_group


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace") -> Iterator["torch.profiler.profile"]:
    """Profile the block with CPU and (when CUDA is available) CUDA
    activity; on exit, waits for the card and writes
    ``<log_dir>/<name>.json.gz``. Yields the profiler, whose
    ``key_averages()`` and ``events()`` can be read after the block. In a
    data-parallel run rank 0 alone traces: the others run the block
    unprofiled and are given None."""
    if process_group()[0] != 0:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    plain = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(plain)
    with open(plain, "rb") as src, gzip.open(plain + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(plain)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# kernel classes by name, first match wins: this package's own kernels,
# cuDNN's convolutions, the GEMMs of cuBLAS and CUTLASS, reductions, then
# elementwise work and copies
KERNEL_CLASSES = (
    ("port", re.compile(r"wavjepa::")),
    ("convolution", re.compile(r"cudnn|conv", re.I)),
    ("gemm", re.compile(r"nvjet|gemm|xmma|cutlass|cublas", re.I)),
    ("reduction", re.compile(r"reduce|softmax|norm", re.I)),
    ("elementwise", re.compile(r"elementwise|copy|multi_tensor_apply|fill", re.I)),
)


def kernel_class(name: str) -> str:
    return next((cls for cls, pattern in KERNEL_CLASSES if pattern.search(name)), "other")


def trace_summary(path: str, window: Optional[str] = None, top: int = 10) -> dict:
    """What the card did in a trace written by ``trace``, within the host
    span of the ``torch.profiler.record_function`` range named ``window``
    (the whole trace without one; end the range after a synchronize, so that
    it covers the device work it launched):

    ``wall_us`` the window's length; ``busy_us`` the union of the device's
    kernel, copy and set intervals in it; ``idle_share`` 1 − busy / wall;
    ``kernel_us`` the kernels' summed durations, and ``kernel_us_by_class``
    by ``kernel_class``; ``kernels`` and ``copies`` their counts;
    ``top_kernels`` the ``top`` kernel names by summed time, each (name,
    count, µs)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if window is not None:
        spans = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise ValueError(f"{len(spans)} host ranges named {window!r} in {path}")
        lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    else:
        lo = min(e["ts"] for e in events)
        hi = max(e["ts"] + e["dur"] for e in events)
    intervals = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device
                       if e["ts"] < hi and e["ts"] + e["dur"] > lo)
    busy, end = 0.0, lo
    for start, stop in intervals:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    kernels = [e for e in device if e["cat"] == "kernel" and lo <= e["ts"] < hi]
    by_name: dict = collections.defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    by_class: dict = collections.Counter()
    for name, (_, us) in by_name.items():
        by_class[kernel_class(name)] += us
    wall = hi - lo
    return {
        "wall_us": wall, "busy_us": busy, "idle_share": 1.0 - busy / wall if wall > 0 else None,
        "kernel_us": sum(e["dur"] for e in kernels), "kernels": len(kernels),
        "kernel_us_by_class": dict(by_class.most_common()),
        "copies": sum(1 for e in device if e["cat"] != "kernel" and lo <= e["ts"] < hi),
        "top_kernels": [(name, n, us) for name, (n, us) in ranked],
    }


class _Timer:
    def __init__(self, name: str):
        self.name = name
        self.elapsed_ms: Optional[float] = None


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str, sync: bool = True, verbose: bool = True) -> Iterator[_Timer]:
    """Time a block on the host clock. With ``sync``, when CUDA is in use,
    waits for the card before and after, so the time covers the block's
    device work and not only its launches."""
    timer = _Timer(name)
    if sync:
        _sync()
    t0 = time.perf_counter()
    try:
        yield timer
    finally:
        if sync:
            _sync()
        timer.elapsed_ms = 1000.0 * (time.perf_counter() - t0)
        if verbose:
            print(f"[timed] {name}: {timer.elapsed_ms:.2f} ms", flush=True)


def device_memory_stats() -> dict:
    """Per CUDA device: bytes allocated now and at peak (by PyTorch's
    caching allocator) and the device's total; empty without CUDA."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(prog="python -m wavjepa_tpu_torch.utils.profiling",
                                     description="summarize a trace written by trace()")
    parser.add_argument("path", help="a <name>.json.gz written by trace()")
    parser.add_argument("--window", default=None, help="a record_function range to read within")
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args()
    print(json.dumps(trace_summary(args.path, args.window, args.top), indent=1))
