"""The train CLI launched alone and under torchrun, on one card, in turns.

    python -m wavjepa_tpu_torch.tools.launch_ab [--pairs 3] [--steps 10] [OUT.json]

runs ``python -m wavjepa_tpu_torch.train`` on the AudioSet configuration
(synthetic clips, the warmup cut to 2 steps, a line of metrics a step) in
processes of their own, in the order alone, torchrun, torchrun, alone, ...:
alone without a process group, and under ``torch.distributed.run
--standalone --nproc_per_node=1``, where the run joins a one-rank NCCL group
(its steps issue no collective at world size 1), with torchrun's
``OMP_NUM_THREADS=1``: the same steps, launched two ways. Prints each run's step times and
their median after 2 warm-up steps, the card's name and power limit, and a
JSON object last (also written to OUT.json when given).
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

WARMUP = 2
LAUNCHERS = {
    "alone": [sys.executable, "-m", "wavjepa_tpu_torch.train"],
    "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc_per_node=1", "-m", "wavjepa_tpu_torch.train"],
}


def step_times(launcher: str, steps: int, save_dir: Path) -> list[float]:
    """One run's ``step_time_ms`` a step, read from its metrics."""
    items = ["data.synthetic=true", "trainer.log_every=1", "optimizer.warmup_steps=2",
             f"trainer.steps={steps}", f"trainer.save_dir={save_dir}"]
    proc = subprocess.run([*LAUNCHERS[launcher], *items], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{launcher} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    (metrics,) = save_dir.rglob("metrics.jsonl")
    return [json.loads(line)["step_time_ms"] for line in metrics.read_text().splitlines()]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m wavjepa_tpu_torch.tools.launch_ab")
    parser.add_argument("out", nargs="?", help="write the JSON object here too")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    order = [("alone", "torchrun"), ("torchrun", "alone")]
    runs = []
    Path("build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build") as tmp:
        for i in range(args.pairs):
            for launcher in order[i % 2]:
                save_dir = Path(tmp) / str(len(runs))
                ms = step_times(launcher, args.steps, save_dir)
                shutil.rmtree(save_dir)
                runs.append({"launcher": launcher, "step_ms": ms,
                             "p50_ms": statistics.median(ms[WARMUP:])})
                print(f"{launcher}: p50 {runs[-1]['p50_ms']:.1f} ms; steps "
                      f"{', '.join(f'{x:.1f}' for x in ms)}", flush=True)
    summary = {k: statistics.median([x for r in runs if r["launcher"] == k
                                     for x in r["step_ms"][WARMUP:]]) for k in LAUNCHERS}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip())
    record = {"card": card.stdout.strip(), "runs": runs, "p50_ms_of_all_steps": summary}
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
