"""Profiling: phase spans and counters, ``torch.profiler`` traces.

Counterpart of ``wavjepa_tpu/utils/profiling.py``:

    with recording() as rec:               # spans and counters, kept in memory
        state, m = step_fn(state, batch, generator)
    rec.totals()                           # host seconds and count by span name

    with trace("runs/profile") as prof:   # CPU and, where present, CUDA activity
        state, m = step_fn(state, batch, generator)
    prof.key_averages()                    # time by operator and kernel

The program marks its phases with ``span(name, **attrs)`` and counts work
with ``count(name, n)``; the kernel wrappers count their launches in a
``launches`` attribute of their own (``launch_counted``). Spans and counts
do nothing unless a ``recording()`` is open:
then each span keeps its name, its parent (from a stack per thread), its
thread, its start and end on ``time.perf_counter_ns()`` and its attributes,
and opens a ``torch.profiler.record_function`` of the same name, so that
under a profiler the phases lie in the trace on the clock of the card's
kernels and copies. Spans measure the host: a span that launches device
work ends when the launches are issued, not when the card finishes them.

Work that is recorded and not run, a CUDA graph's capture, is counted
aside (``counted_aside``): its counts and launches go into a ``Tally``,
which its owner adds (``Tally.add``) each time the card runs that work.

``trace`` writes a Chrome/Perfetto trace (``<name>.json.gz``, open it in
https://ui.perfetto.dev or chrome://tracing) into the log directory, with
the spans recorded, as ``user_annotation`` events; ``trace_summary`` reads
one back: the card's busy and idle share of a window, its kernel launches
and the kernels that took the most time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gzip
import itertools
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

import torch

from wavjepa_tpu_torch.parallel.mesh import process_group


@dataclasses.dataclass
class Span:
    """A finished span. ``parent`` is the id of the span that was open on
    the same thread when it began (None for a root); ``root`` is its root's
    attributes, the same dict for every span under one root (a train step's
    ``step``, a request's ``request``)."""

    name: str
    id: int
    parent: Optional[int]
    root: dict
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recording:
    """What a ``recording()`` collected: finished spans, in the order they
    ended, and counters by name."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: collections.Counter = collections.Counter()
        self._lock = threading.Lock()

    def _add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += n

    def totals(self) -> dict:
        """{span name: {"count": spans, "s": summed host seconds}}."""
        out: dict = {}
        for s in self.spans:
            t = out.setdefault(s.name, {"count": 0, "s": 0.0})
            t["count"] += 1
            t["s"] += s.seconds
        return out


_OPEN: Optional[Recording] = None  # spans and counters are off while None
_NOOP = contextlib.nullcontext()
_ids = itertools.count()
_local = threading.local()


def _stack() -> list:
    """This thread's open spans, outermost first."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Active:
    """An open span: its record, its thread's stack, the recording it goes
    to and its profiler range."""

    __slots__ = ("span", "stack", "target", "range")

    def __init__(self, name: str, attrs: dict, target: Recording):
        self.stack = _stack()
        parent = self.stack[-1] if self.stack else None
        self.span = Span(name, next(_ids), parent.id if parent else None,
                         parent.root if parent else attrs, threading.get_ident(), 0, 0, attrs)
        self.target = target
        self.range = torch.profiler.record_function(name)

    def __enter__(self) -> Span:
        self.stack.append(self.span)
        self.range.__enter__()
        self.span.start_ns = time.perf_counter_ns()
        return self.span

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.stack.pop()
        self.target.spans.append(self.span)


def span(name: str, **attrs):
    """A phase of the program, as a context manager. While no recording is
    open it returns a shared no-op context and records nothing; while one
    is, it records a ``Span`` into it and opens a
    ``torch.profiler.record_function`` of the same name."""
    rec = _OPEN
    if rec is None:
        return _NOOP
    return _Active(name, attrs, rec)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the open recording (to the
    open ``counted_aside`` block's tally instead, while one is open)."""
    aside = _ASIDE
    if aside is not None:
        aside.counts[name] += n
        return
    rec = _OPEN
    if rec is None:
        return
    rec._add(name, n)


LAUNCH_COUNTED: list = []  # the kernel wrappers that ``launch_counted`` gave a counter


def launch_counted(fn):
    """Decorate a kernel wrapper: ``fn.launches`` starts at 0, the wrapper
    adds one a launch (its CPU path never counts), and ``counted_aside``
    knows it."""
    fn.launches = 0
    LAUNCH_COUNTED.append(fn)
    return fn


@dataclasses.dataclass
class Tally:
    """What a ``counted_aside`` block counted: counter increments by name
    and launches by kernel wrapper."""

    counts: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    launches: dict = dataclasses.field(default_factory=dict)

    def add(self) -> None:
        """Count the block's work once more, as if it had run again: into
        the open recording and the wrappers' ``launches``."""
        for name, n in self.counts.items():
            count(name, n)
        for fn, n in self.launches.items():
            fn.launches += n


_ASIDE: Optional[Tally] = None  # the open counted_aside block's tally, on every thread


@contextlib.contextmanager
def counted_aside() -> Iterator[Tally]:
    """Count the block's work into a ``Tally`` (yielded), kept out of the
    open recording and out of the wrappers' ``launches``: for work that is
    recorded and not run, as a CUDA graph's capture is. Counts from every
    thread go there (autograd's backward runs on a thread of its own)."""
    global _ASIDE
    if _ASIDE is not None:
        raise RuntimeError("counted_aside is already open")
    tally = _ASIDE = Tally()
    before = [fn.launches for fn in LAUNCH_COUNTED]
    try:
        yield tally
    finally:
        _ASIDE = None
        for fn, n in zip(LAUNCH_COUNTED, before):
            if fn.launches != n:
                tally.launches[fn] = fn.launches - n
            fn.launches = n


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the spans that begin and the counts made in the block, on
    every thread, in memory; yields the ``Recording``. One recording is
    open at a time: opening a second inside it raises ``RuntimeError``."""
    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("a recording is already open")
    rec = _OPEN = Recording()
    try:
        yield rec
    finally:
        _OPEN = None


@contextlib.contextmanager
def trace(log_dir: str, name: str = "trace") -> Iterator["torch.profiler.profile"]:
    """Profile the block with CPU and (when CUDA is available) CUDA
    activity, with the program's spans recorded (into the open
    ``recording()``, else into one of the block's own), so that they lie in
    the trace; on exit, waits for the card and writes
    ``<log_dir>/<name>.json.gz``. Yields the profiler, whose
    ``key_averages()`` and ``events()`` can be read after the block. In a
    process group (data- or tensor-parallel) global rank 0 alone traces:
    the others run the block unprofiled and are given None."""
    if process_group()[0] != 0:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof, (recording() if _OPEN is None else _NOOP):
        yield prof
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    plain = os.path.join(log_dir, f"{name}.json")
    prof.export_chrome_trace(plain)
    with open(plain, "rb") as src, gzip.open(plain + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(plain)


DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")  # the host calls that launch them
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
    count, µs). Kernels and copies count when they were launched in the
    window (the ``cuda_runtime`` or ``cuda_driver`` event of the same
    ``correlation``; their own start where the trace has no launch): a
    trace can place the last kernels of a range that ends on a synchronize
    a few milliseconds past its end."""
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
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    device = [e for e in device
              if lo <= launched.get(e.get("args", {}).get("correlation"), e["ts"]) < hi]
    kernels = [e for e in device if e["cat"] == "kernel"]
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
        "copies": sum(1 for e in device if e["cat"] != "kernel"),
        "top_kernels": [(name, n, us) for name, (n, us) in ranked],
    }


if __name__ == "__main__":
    import argparse

    parser = argparse.ArgumentParser(prog="python -m wavjepa_tpu_torch.utils.profiling",
                                     description="summarize a trace written by trace()")
    parser.add_argument("path", help="a <name>.json.gz written by trace()")
    parser.add_argument("--window", default=None, help="a record_function range to read within")
    parser.add_argument("--top", type=int, default=10)
    args = parser.parse_args()
    print(json.dumps(trace_summary(args.path, args.window, args.top), indent=1))
