"""A profiled tail that also records the program's spans and counters.

``profiled(device, names)`` is ``harness.profiled``'s profile (CPU and the
card, inside a ``harness.WINDOW`` range that ends after a synchronize) with
a ``wavjepa_tpu_torch.utils.profiling.recording()`` open around it, so that
the program's spans lie in the trace. Once the block is done the yielded
dict holds ``count/trace.read``'s reading of the window, ``spans`` (the
card's time by span, ``count/spans.read`` over the span names ``names``)
and ``counters`` (the recording's). A program without a span reads none of
it: the metric that wants it finds nothing.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time


@contextlib.contextmanager
def profiled(device, names):
    import torch

    from wavbench import harness
    from wavbench.count import spans as span_reader
    from wavbench.count import trace as trace_reader
    from wavjepa_tpu_torch.utils import profiling

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="wavbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = torch.profiler.profile(activities=activities)
        with profiling.recording() as rec, prof:
            with torch.profiler.record_function(harness.WINDOW):
                yield out
                harness.sync(device)
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        out["trace_bytes"] = os.path.getsize(path)
        out.update(trace_reader.read(path, harness.WINDOW))
        out["spans"] = span_reader.read(path, harness.WINDOW, names)
        out["counters"] = dict(rec.counters)
        out["read_s"] = time.perf_counter() - t0
