"""Run one benchmark cell once on the card and print its result line.

    python3 wavbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from the same kind of
run with a profiled tail after the window. Every run checks what the timed
path produced against the plain reference (``wavbench/reference/``) and
prints each number compared beside its limit, as the last lines of
standard error and under ``checks`` in the result, the last line of
standard output. Without as many cards as the cell asks for, it prints no
result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from wavbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.cache_env()
    cell = harness.load_cell(args.workload)

    import torch

    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"wavbench: the cell needs {chips} CUDA device(s), this machine has {found}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.driver(cell["traffic"]["driver"]).run(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace), device=device,
        t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"wavbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    line = finish(cell, out, bool(args.trace), device)
    print(line, flush=True)
    return 0


def finish(cell: dict, out: dict, trace: bool, device) -> str:
    """The result line of a driver's output: the cell's end-to-end metrics,
    or its per-layer metrics as their readers find them."""
    import torch

    metrics = {}
    if trace:
        for spec in harness.cell_metrics(cell, "per_layer"):
            value = harness.metric_reader(spec["name"]).read(out["record"])
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        for spec in harness.cell_metrics(cell, "end_to_end"):
            metrics[spec["name"]] = {"value": out["end_to_end"][spec["name"]],
                                     "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["entry"]["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    if trace:
        tr = out["record"]["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["wall_s"]
        breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    print(f"wavbench: {json.dumps(out.get('notes', {}))}", file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    for name, c in out["checks"].items():  # the last lines of standard error
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    return harness.result_line(out["correct"], out["attempted"], out["failed"], metrics, dev,
                               out["checks"], breakdown)


if __name__ == "__main__":
    sys.exit(main())
