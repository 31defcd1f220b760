"""Read the lower ends of the WavLM embed cell's limits on the card.

    python3 wavbench/tools/limits_wavlm.py --workload wavlm-large-embed --variant <v> --seeds <n> ...

Puts the plain reference (``reference/wavlm.py``), changed as ``--variant``
says, in the program's place, and prints for each seed the largest
``embed_gap`` over the seed's whole request pool (``drivers/embed_wavlm.
request_pool``) against the unchanged reference, one JSON line a seed:

- ``fp8``: the control, every product's operands in float8
  (``reference/precision.py``), the precision below the configuration's
  bfloat16;
- ``nobias``: the gated relative-position bias dropped from every layer;
- ``swap``: each utterance's embedding given its neighbour's.

Not run by ``run.py``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402

from wavbench import harness  # noqa: E402
from wavbench.reference import embed as E  # noqa: E402
from wavbench.reference import wavlm as RW  # noqa: E402


def readings(cell: dict, seed: int, variant: str, device) -> dict:
    from wavbench.drivers import embed_wavlm as D

    m, pre = cell["config"]["model"], cell["config"]["preprocessor"]
    pool = D.request_pool(cell["traffic"], seed)
    w = RW.make_weights(m, seed, device)
    gaps = []
    for req in pool:
        ref, _ = RW.scene_embeddings(req, w, m, pre, device)
        if variant == "fp8":
            var, _ = RW.scene_embeddings(req, w, m, pre, device, precision="fp8")
        elif variant == "nobias":
            var, _ = RW.scene_embeddings(req, w, m, pre, device, bias=False)
        elif variant == "swap":
            var = ref.roll(1, dims=0)
        else:
            raise SystemExit(f"no variant {variant!r}")
        gaps.append(E.answer_gap(var, ref))
    return {"embed_gap": max(gaps), "embed_gap_min": min(gaps)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="wavlm-large-embed")
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
