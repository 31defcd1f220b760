"""The card's time by the program's phase spans, read from a Chrome trace.

The program's spans (``wavjepa_tpu_torch/utils/profiling.span``, while a
recording is open) lie in a profiled trace as ``user_annotation`` ranges
on the thread that opened them; ``names`` says which ranges are theirs (a
library's own ranges, such as ``Optimizer.step#AdamW.step``, are not).
Within the host span of the ``window`` range (as ``count/trace.py`` reads
it):

- **device seconds by span**: each kernel, copy or set goes to the
  innermost span open on its launching thread (the ``cuda_runtime`` or
  ``cuda_driver`` event of the same ``correlation``) at the launch. Where
  none is open there (autograd's engine thread runs the backward's
  launches), it goes to the innermost span open on the window's thread at
  that time; where none is open there either, it is uncovered.
- **idle seconds by span**: each interval in which the card runs nothing
  is split over the innermost spans open on the window's thread while it
  lasts, by overlap, and not by where it starts.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json

from wavbench.count.trace import DEVICE_CATEGORIES

LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


class _Innermost:
    """The innermost span open at a time on one thread: properly nested
    spans, so the latest-starting one that covers the time (of two that
    start together, the one that ends first)."""

    def __init__(self, spans: list):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))  # (start, end, name)
        self.starts = [s[0] for s in self.spans]

    def at(self, t: float):
        for j in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            if self.spans[j][1] > t:
                return self.spans[j][2]
        return None

    def pieces(self, lo: float, hi: float) -> list:
        """[lo, hi) cut where a span starts or ends, each piece with the
        innermost span over it (or None)."""
        cuts = sorted({lo, hi, *(t for s in self.spans for t in s[:2] if lo < t < hi)})
        return [(a, b, self.at((a + b) / 2)) for a, b in zip(cuts, cuts[1:])]


def read(path: str, window: str, names) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    wins = [e for e in marks if e["name"] == window]
    if len(wins) != 1:
        raise ValueError(f"{len(wins)} host ranges named {window!r} in {path}")
    lo, hi, main = wins[0]["ts"], wins[0]["ts"] + wins[0]["dur"], wins[0].get("tid")
    names = set(names)
    by_thread = collections.defaultdict(list)
    for e in marks:
        if e["name"] in names:
            by_thread[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    threads = {tid: _Innermost(spans) for tid, spans in by_thread.items()}
    on_main = threads.get(main, _Innermost([]))
    launches = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    spent: dict = collections.defaultdict(float)
    total = uncovered = 0.0
    for e in device:
        us = min(e["ts"] + e["dur"], hi) - max(e["ts"], lo)
        tid, at = launches.get(e.get("args", {}).get("correlation"), (None, e["ts"]))
        name = threads[tid].at(at) if tid in threads else None
        if name is None:
            name = on_main.at(at)
        total += us
        if name is None:
            uncovered += us
        else:
            spent[name] += us
    intervals = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in device)
    gaps, end = [], lo
    for start, stop in intervals:
        if start > end:
            gaps.append((end, start))
        end = max(end, stop)
    if hi > end:
        gaps.append((end, hi))
    idle: dict = collections.defaultdict(float)
    idle_uncovered = 0.0
    pieces = on_main.pieces(lo, hi)
    j = 0
    for a, b in gaps:  # both in time order: one pass
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, name = pieces[k]
            overlap = min(b, p1) - max(a, p0)
            if name is None:
                idle_uncovered += overlap
            else:
                idle[name] += overlap
            k += 1
    return {
        "device_s": total / 1e6,
        "device_s_by_span": {k: v / 1e6 for k, v in sorted(spent.items(), key=lambda kv: -kv[1])},
        "uncovered_device_share": uncovered / total if total else None,
        "idle_s_by_span": {k: v / 1e6 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "idle_uncovered_s": idle_uncovered / 1e6,
    }
