"""WavJEPA SSL pretraining from the command line.

    python -m wavjepa_tpu_torch.train [config.yaml] [key=value ...] [--device cpu]

Runs on cuda unless ``--device`` names another device. Training reads the
WebDataset tar shards that ``data.data_dirs`` names (brace ranges, commas),
decoded by ``data.num_workers`` spawned worker processes:

    python -m wavjepa_tpu_torch.train configs/audioset.yaml \\
        "data.data_dirs=/data/audioset/train-{000000..000999}.tar"

and synthetic clips when ``data.synthetic=true`` or ``data.data_dirs`` is
empty. On all 8 cards of a host, data-parallel (``trainer.batch_size`` is
the global batch; gloo ranks on the CPU with ``--device cpu``):

    torchrun --standalone --nproc_per_node=8 -m wavjepa_tpu_torch.train \\
        configs/audioset.yaml "data.data_dirs=..."

A smoke run of the tiny model on the CPU:

    python -m wavjepa_tpu_torch.train data.synthetic=true trainer.size=tiny \\
        trainer.steps=2 trainer.batch_size=1 data.samples_per_audio=2 \\
        trainer.log_every=1 trainer.save_dir=/tmp/run --device cpu
"""

from __future__ import annotations

import argparse
import sys

from wavjepa_tpu_torch.train.config import apply_overrides, load_config
from wavjepa_tpu_torch.train.loop import train_jepa


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m wavjepa_tpu_torch.train",
                                     description="WavJEPA SSL pretraining")
    parser.add_argument("items", nargs="*",
                        help="an optional config.yaml first, then key=value overrides")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    items = list(args.items)
    path = None
    if items and items[0].endswith((".yaml", ".yml")) and "=" not in items[0]:
        path = items.pop(0)
    cfg = apply_overrides(load_config(path), items)
    print(f"run: {cfg.run_identity()}", flush=True)
    train_jepa(cfg, device=args.device)


if __name__ == "__main__":
    main()
