"""ARCH evaluation CLI: load a WavJEPA checkpoint (or seeded weights),
evaluate it on the selected ARCH datasets, and append one TSV row a
(dataset, mode, metric) to the results file.

Usage:
    python -m wavjepa_tpu_torch.eval.arch --data-dir DATA \\
        [--ckpt CKPT] [--datasets esc50 us8k ...] \\
        [--mode linear non-linear attention-pooling] [--max-epochs 100] \\
        [--batch-size 32] [--tsv results.tsv] [--model-size base] [--device cpu]

Dataset folders are expected under --data-dir with their native layouts
(e.g. DATA/esc50/meta/esc50.csv; see eval/arch/recipes.py). The encoder and
the probes run on ``cuda`` unless ``--device cpu`` is given.
"""

import argparse
import sys
from pathlib import Path

DATASETS = {
    "esc50": ("ESC50", "esc50"),
    "us8k": ("US8K", "us8k"),
    "fsd50k": ("FSD50K", "fsd50k"),
    "vivae": ("VIVAE", "vivae"),
    "fma_small": ("FMASmall", "fma_small"),
    "magnatagatune": ("MagnaTagATune", "magnatagatune"),
    "irmas": ("IRMAS", "irmas"),
    "medleydb": ("MedleyDB", "medleydb"),
    "ravdess": ("RAVDESS", "ravdess"),
    "audio_mnist": ("AudioMNIST", "audio_mnist"),
    "slurp": ("SLURP", "slurp"),
    "emovo": ("EMOVO", "emovo"),
}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="wavjepa_tpu_torch.eval.arch")
    parser.add_argument("--ckpt", default="", help="checkpoint path (a port or reference .ckpt)")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--datasets", nargs="+", default=list(DATASETS))
    parser.add_argument("--mode", nargs="+", default=["linear", "non-linear"])
    parser.add_argument("--max-epochs", type=int, default=100)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--tsv", default="arch_results.tsv")
    parser.add_argument("--model-size", default="base")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import wavjepa_tpu_torch.eval.arch as arch
    from wavjepa_tpu_torch.eval.arch.model import WavJEPAModel

    model = WavJEPAModel.from_checkpoint(args.ckpt, model_size=args.model_size,
                                         device=args.device)

    tsv = Path(args.tsv)
    if not tsv.exists():
        tsv.write_text("dataset\tmode\tmetric\tvalue\n")

    for name in args.datasets:
        cls_name, subdir = DATASETS[name]
        path = str(Path(args.data_dir) / subdir)
        recipe_cls = getattr(arch, cls_name)
        if name == "fma_small":
            recipe = recipe_cls(
                config_path=str(Path(path) / "fma_metadata"),
                audio_files_path=str(Path(path) / "fma_small"),
            )
        else:
            recipe = recipe_cls(path)
        for mode in args.mode:
            print(f"=== {name} [{mode}]", flush=True)
            results = recipe.evaluate(
                model, mode=mode, device=args.device,
                max_num_epochs=args.max_epochs, batch_size=args.batch_size,
            )
            with open(tsv, "a") as f:
                for metric, value in results.items():
                    f.write(f"{name}\t{mode}\t{metric}\t{value}\n")
            print(f"{name} [{mode}]: {results}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
