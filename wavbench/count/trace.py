"""What the card did in a profiled window, read from a Chrome trace.

The interval arithmetic is a frozen copy of ``trace_summary`` in
``wavjepa_tpu_torch/utils/profiling.py`` as of commit
cdac4308582b9b00131171bfbc04c0a840de7394: the window is the host span of
one ``record_function`` range; busy time is the union of the device's
kernel, copy and set intervals inside it. Added here: kernel time by name,
the device operations that took the most time, and the card's idle gaps
labelled with the innermost host operation that the launching thread was
running at their start (``python`` where none was).
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
NAME_CHARS = 160  # a breakdown entry's name is cut to this many characters


def read(path: str, window: str, top: int = 10) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("name") == window and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host ranges named {window!r} in {path}")
    lo, hi = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    intervals = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device)
    busy, end, gaps = 0.0, lo, []
    for start, stop in intervals:
        if start > end:
            gaps.append((end, start - end))
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    if hi > end:
        gaps.append((end, hi - end))
    by_name: dict = collections.defaultdict(float)
    kernels = 0
    for e in device:
        if lo <= e["ts"] < hi:
            by_name[e["name"]] += e["dur"]
            kernels += e["cat"] == "kernel"
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES and e is not spans[0]
                  and e.get("tid") == spans[0].get("tid"))  # the thread that launches
    starts = [h[0] for h in host]
    idle: dict = collections.defaultdict(float)
    for at, length in gaps:
        idle[_innermost(host, starts, at)] += length
    wall = hi - lo
    return {
        "wall_s": wall / 1e6, "busy_s": busy / 1e6, "kernels": kernels,
        "kernel_s_by_name": {k: v / 1e6 for k, v in by_name.items()},
        "device_ops": [[name[:NAME_CHARS], us / 1e6] for name, us in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[name[:NAME_CHARS], us / 1e6] for name, us in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
    }


def _innermost(host: list, starts: list, at: float, look: int = 256) -> str:
    """The latest-starting host operation that covers ``at``."""
    i = bisect.bisect_right(starts, at) - 1
    for j in range(i, max(-1, i - look), -1):
        if host[j][1] > at:
            return host[j][2]
    return "python"
