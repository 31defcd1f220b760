"""Read the upper ends of a cell's correctness limits on the card.

    python3 wavbench/tools/limits.py --workload <cell> --variant <v> --seeds <n> ...

Puts the plain reference, changed as ``--variant`` says, in the program's
place, and prints for each seed the numbers a run compares, against the
unchanged reference, one JSON line a seed:

- ``fp8``: the control, the reference with every product's operands in
  float8 (``reference/precision.py``), the precision below the
  configuration's bfloat16;
- ``half`` (train cells): a step that leaves half of its batch out and
  takes the mean over the rest;
- ``swap`` (embed cells): an answer altered where it is produced, each
  clip's embedding given its neighbour's.

A state left unchanged reads 1 on ``change_gap`` and ``ema_gap`` by their
definition and needs no run. Not run by ``run.py``.
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
from wavbench.reference import embed as E  # noqa: E402
from wavbench.reference import model as M  # noqa: E402


def train_readings(cell: dict, seed: int, variant: str, device) -> dict:
    from wavbench.drivers import train as T

    pool = traffic.train_pool(cell["traffic"], seed)
    ref = T.reference_readings(cell, seed, pool, device)
    if variant == "fp8":
        var = T.reference_readings(cell, seed, pool, device, precision="fp8")
    elif variant == "half":
        crops = cell["traffic"]["batch_clips"] * cell["config"]["recipe"]["samples_per_audio"]
        var = T.reference_readings(cell, seed, pool, device, rows=slice(0, crops // 2))
    else:
        raise SystemExit(f"no variant {variant!r} for a train cell")
    return {**T.compare(var, ref), "worst_leaves": T.worst_leaves(var, ref)}


def embed_readings(cell: dict, seed: int, variant: str, device) -> dict:
    t, m = cell["traffic"], cell["config"]["model"]
    pool = traffic.request_pool(t, seed)
    w = M.make_weights(m, seed, device, training=False)
    gaps = []
    for dur in t["durations_s"]:
        for i in range(t["pool"]):
            ref = E.scene_embeddings(pool[dur][i], w, m, device, t["reference_block"])
            if variant == "fp8":
                var = E.scene_embeddings(pool[dur][i], w, m, device, t["reference_block"], "fp8")
            elif variant == "swap":
                var = ref.roll(1, dims=0)
            else:
                raise SystemExit(f"no variant {variant!r} for an embed cell")
            gaps.append(E.answer_gap(var, ref))
    return {"embed_gap": max(gaps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    harness.cache_env()
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("wavbench: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    read = train_readings if cell["traffic"]["driver"] == "train" else embed_readings
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = read(cell, seed, args.variant, device)
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "readings": out, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
