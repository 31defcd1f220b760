"""Split a cell's step or request by the program's phase spans, on the card.

    python3 wavbench/tools/phases.py --workload <cell> --seed <n> --seconds <s>

Sets the cell up as ``wavbench/drivers/`` does (the same configuration, seeded
weights, traffic pool and warm-up), then in one process:

1. ``window``: ``--seconds`` of steps (requests) with no recording open,
   as ``run.py --trace 0`` runs them: seconds a step (request), over the
   whole window and over its first and last quarter of steps (requests);
2. segments of 4 steps, or 24 requests (8 of each duration), in turns
   with no recording open (``plain_s``: seconds a step or request) and
   with one open (``spanned_s``), the profiler off; ``spanned``: the first
   spanned segment's host milliseconds a step (request) and spans by span
   name, and its counters;
3. ``traced_off`` and ``traced``: the cell's profiled tail
   (``trace_steps`` or ``trace_requests``), first as ``run.py --trace 1``
   profiles it, with no recording open, then inside a recording; each read
   by ``count/trace.py`` (busy seconds, idle gaps by the host op open at
   their start), the second also by ``count/spans.py`` (device and idle
   seconds by span);
4. after the profiler, a plain segment (``plain_after_s``) and a spanned
   one (``spanned_after``).

Prints one JSON line. Checks no output against the reference: ``run.py``
does. Not run by ``run.py``. Its ``profiled`` and set-up copy
``harness.profiled`` and the drivers': delete this tool in the change that
makes the drivers record spans and adds the span metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from wavbench import harness, traffic  # noqa: E402
from wavbench.count import spans as span_reader  # noqa: E402
from wavbench.count import trace as trace_reader  # noqa: E402
from wavbench.reference import model as M  # noqa: E402
from wavbench.reference import train as R  # noqa: E402

SPANNED_STEPS = 4
SPANNED_REQUESTS_EACH = 8


@contextlib.contextmanager
def profiled(device, record: bool):
    """``harness.profiled``'s profile of the block, optionally inside a
    recording; yields a dict that holds both readers' readings after it."""
    from wavjepa_tpu_torch.utils import profiling

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="wavbench_phases_") as tmp:
        path = os.path.join(tmp, "trace.json")
        with torch.profiler.profile(activities=activities) as prof:
            with profiling.recording() if record else contextlib.nullcontext() as rec:
                with torch.profiler.record_function(harness.WINDOW):
                    yield out
                    harness.sync(device)
        prof.export_chrome_trace(path)
        read = trace_reader.read(path, harness.WINDOW)
        out.update({k: read[k] for k in ("wall_s", "busy_s", "kernels", "idle_gaps")})
        if record:
            out["spans"] = span_reader.read(path, harness.WINDOW, rec.totals())


def segment(unit, units: list, device, record: bool) -> dict:
    """The units in turn, with a recording open or not; seconds a unit
    and, when recorded, host milliseconds and spans a unit by span name."""
    from wavjepa_tpu_torch.utils import profiling

    harness.sync(device)
    with profiling.recording() if record else contextlib.nullcontext() as rec:
        t0 = time.perf_counter()
        for u in units:
            unit(u)
        harness.sync(device)
        seconds = time.perf_counter() - t0
    n = len(units)
    out = {"s_per_unit": seconds / n}
    if record:
        out.update(counters=dict(rec.counters),
                   ms_per_unit={k: 1000.0 * v["s"] / n for k, v in rec.totals().items()},
                   spans_per_unit={k: v["count"] / n for k, v in rec.totals().items()})
    return out


def measure(unit, draw, seconds: float, traced: int, units: list, device) -> dict:
    """The four parts of the module docstring; ``unit(u)`` runs one step or
    request, ``draw()`` gives the next ``u`` of the window's traffic."""
    harness.sync(device)
    t0, ends = time.perf_counter(), []
    while time.perf_counter() - t0 < seconds or not ends:
        unit(draw())
        ends.append(time.perf_counter() - t0)
    harness.sync(device)
    n, q = len(ends), max(1, len(ends) // 4)
    out = {"window": {"units": n, "s_per_unit": (time.perf_counter() - t0) / n,
                      "first_quarter_s_per_unit": ends[q - 1] / q,
                      "last_quarter_s_per_unit": (ends[-1] - ends[-q - 1]) / q
                      if n > q else ends[-1] / n}}
    plain, spanned = [], []
    for _ in range(2):
        plain.append(segment(unit, units, device, False)["s_per_unit"])
        spanned.append(segment(unit, units, device, True))
    out.update(plain_s=plain, spanned_s=[s["s_per_unit"] for s in spanned], spanned=spanned[0])
    for key, record in (("traced_off", False), ("traced", True)):
        with profiled(device, record) as tr:
            for _ in range(traced):
                unit(draw())
        out[key] = tr
    out["plain_after_s"] = segment(unit, units, device, False)["s_per_unit"]
    out["spanned_after"] = segment(unit, units, device, True)
    return out


def train(cell: dict, seed: int, seconds: float, device) -> dict:
    from wavjepa_tpu_torch.train.loop import build_run, prefetch_to_device, run_step

    T = harness.driver("train")
    t, m = cell["traffic"], cell["config"]["model"]
    cfg = T.port_config(cell, seed)
    dev, model_cfg, state, step_fn = build_run(cfg, device)
    T.check_resolution(cfg, model_cfg, step_fn, cell)
    T.restore(state, M.make_weights(m, seed, dev), t["start_step"])
    batches = prefetch_to_device(itertools.cycle(traffic.train_pool(t, seed)), dev)
    generator = torch.Generator(device=dev)

    def step(_=None):
        batch = next(batches)
        generator.manual_seed(R.step_seed(seed, state.step))
        loss = run_step(step_fn, state, batch, generator)[1]["loss"]
        if state.step % cfg.trainer.log_every == 0 and not math.isfinite(float(loss)):
            raise FloatingPointError(f"loss {float(loss)} at step {state.step}")

    for _ in range(T.CHECK_STEPS):  # the warm-up of drivers/train.py
        step()
    try:
        return measure(step, lambda: None, seconds, t["trace_steps"], [None] * SPANNED_STEPS,
                       dev)
    finally:
        batches.close()


def embed(cell: dict, seed: int, seconds: float, device) -> dict:
    from wavjepa_tpu_torch.api.runtime import RuntimeJEPA

    D = harness.driver("embed")
    t, m = cell["traffic"], cell["config"]["model"]
    runtime = RuntimeJEPA(D.serving_config(cell, seed),
                          state_dict=M.make_weights(m, seed, device, training=False),
                          device=device)
    pool = traffic.request_pool(t, seed)
    for dur in t["durations_s"]:
        runtime.get_scene_embeddings(pool[dur][0]).cpu()
    durations = traffic.request_durations(t, seed)
    sent = itertools.count()

    def request(dur):
        runtime.get_scene_embeddings(pool[dur][next(sent) % t["pool"]]).cpu()

    segment = t["durations_s"] * SPANNED_REQUESTS_EACH
    return measure(request, lambda: next(durations), seconds, t["trace_requests"], segment,
                   device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("phases: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = {"train": train, "embed": embed}[cell["traffic"]["driver"]]
    out = run(cell, args.seed, args.seconds, device)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "device": torch.cuda.get_device_name(device), **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
