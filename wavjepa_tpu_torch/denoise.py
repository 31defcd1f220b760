"""Denoise distillation from the command line.

    python -m wavjepa_tpu_torch.denoise [config.yaml] [key=value ...] [--device cpu]

Runs on cuda unless ``--device`` names another device. The teacher is the
student of the JEPA checkpoint that ``teacher_ckpt`` names (a port training
checkpoint or a reference ``.ckpt``; seeded weights without one). The
denoiser's defaults differ from SSL pretraining's, and each applies unless
the YAML file or the command line sets its key: lr 1e-4, weight decay 0,
gradient clip 1.0, 16 crops a clip, 100 000 steps, 8 clips a batch, warmup
min(5000, steps), total = steps. From shards:

    python -m wavjepa_tpu_torch.denoise teacher_ckpt=runs/.../step_00375000.ckpt \\
        "data.data_dirs=/data/audioset/train-{000000..000869}.tar" \\
        "data.rir_dir=/data/rirs-{000..009}.tar" "data.noise_dir=/data/wham-{000..019}.tar"

and from synthetic scene batches when ``data.synthetic=true`` or
``data.data_dirs`` is empty. Data-parallel on all 8 cards of a host
(``trainer.batch_size`` is the global batch; gloo ranks on the CPU with
``--device cpu``):

    torchrun --standalone --nproc_per_node=8 -m wavjepa_tpu_torch.denoise teacher_ckpt=...

A smoke run of the tiny model on the CPU:

    python -m wavjepa_tpu_torch.denoise data.synthetic=true trainer.size=tiny \\
        trainer.steps=2 trainer.batch_size=1 data.samples_per_audio=2 \\
        data.target_seconds=2.5 trainer.log_every=1 trainer.save_dir=/tmp/dn --device cpu
"""

from __future__ import annotations

import argparse
import sys

from wavjepa_tpu_torch.train.config import Config, apply_overrides, load_config
from wavjepa_tpu_torch.train.denoise_loop import train_denoiser


def denoise_config(items: list[str]) -> Config:
    """The run's configuration from an optional config.yaml first, then
    key=value overrides, with the denoiser's defaults where neither set the
    key."""
    items = list(items)
    path = None
    if items and items[0].endswith((".yaml", ".yml")) and "=" not in items[0]:
        path = items.pop(0)
    cfg = apply_overrides(load_config(path), items)
    cfg.model = "Denoiser"
    explicit = set(cfg.explicit_keys)
    defaults = [("optimizer.lr", "1e-4"), ("optimizer.weight_decay", "0.0"),
                ("optimizer.grad_clip", "1.0"), ("data.samples_per_audio", "16"),
                ("trainer.steps", "100000"), ("trainer.batch_size", "8")]
    cfg = apply_overrides(cfg, [f"{k}={v}" for k, v in defaults if k not in explicit])
    steps = cfg.trainer.steps
    return apply_overrides(cfg, [
        f"{k}={v}" for k, v in (("optimizer.warmup_steps", min(5000, steps)),
                                ("optimizer.total_steps", steps)) if k not in explicit])


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m wavjepa_tpu_torch.denoise",
                                     description="WavJEPA denoise distillation")
    parser.add_argument("items", nargs="*",
                        help="an optional config.yaml first, then key=value overrides")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    cfg = denoise_config(args.items)
    print(f"run: Denoise-{cfg.run_identity()}", flush=True)
    train_denoiser(cfg, device=args.device)


if __name__ == "__main__":
    main()
