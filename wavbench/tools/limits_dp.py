"""Read the lower ends of the data-parallel train cell's limits on a card.

    python3 wavbench/tools/limits_dp.py --workload base-pretrain-dp4 --variant <v> --seeds <n> ...

Puts the plain reference (``reference/train.py``), changed as ``--variant``
says, in the program's place, and prints for each seed the numbers a run
compares against the unchanged reference over the global batch, one JSON
line a seed:

- ``fp8``: the control, every product's operands in float8
  (``reference/precision.py``), the precision below the configuration's
  bfloat16;
- ``noreduce``: the step without its gradient all-reduce, as rank 0 takes
  it: the loss and the gradient of rank 0's rows alone (its 32 clips' 256
  crops of the global 1,024), step after step.

Both are the reference's alone, so one card reads them. Not run by
``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from wavbench import harness, traffic  # noqa: E402


def readings(cell: dict, seed: int, variant: str, device) -> dict:
    from wavbench.drivers import train as T

    pool = traffic.train_pool(cell["traffic"], seed)
    ref = T.reference_readings(cell, seed, pool, device)
    if variant == "fp8":
        var = T.reference_readings(cell, seed, pool, device, precision="fp8")
    elif variant == "noreduce":
        crops = cell["traffic"]["batch_clips"] * cell["config"]["recipe"]["samples_per_audio"]
        var = T.reference_readings(cell, seed, pool, device,
                                   rows=slice(0, crops // cell["entry"]["chips"]))
    else:
        raise SystemExit(f"no variant {variant!r}")
    return {**T.compare(var, ref), "worst_leaves": T.worst_leaves(var, ref)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="base-pretrain-dp4")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("wavbench: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.variant, device)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "readings": out, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
