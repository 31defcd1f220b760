"""HEAR eval CLI of the port (the reference's
``python -m heareval.embeddings.runner`` and
``python -m heareval.predictions.runner``).

Usage:
    python -m wavjepa_tpu_torch.eval embeddings MODULE [--model CKPT]
        [--tasks-dir tasks] [--task all] [--embeddings-dir embeddings]
        [--device cuda|cpu]
    python -m wavjepa_tpu_torch.eval predictions EMB_DIR [EMB_DIR ...]
        [--grid-points 8] [--grid default|fast|faster] [--device cuda|cpu]

Both run on ``cuda`` unless ``--device cpu`` is given (for ``embeddings``
the device goes to the module's ``load_model``).
"""

import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(prog="wavjepa_tpu_torch.eval")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_emb = sub.add_parser("embeddings", help="compute task embeddings")
    p_emb.add_argument("module")
    p_emb.add_argument("--model", default="")
    p_emb.add_argument("--tasks-dir", default="tasks")
    p_emb.add_argument("--task", default="all")
    p_emb.add_argument("--embeddings-dir", default="embeddings")
    p_emb.add_argument("--device", default=None, help="cuda (default) or cpu")

    p_pred = sub.add_parser("predictions", help="train + score probes")
    p_pred.add_argument("embedding_dirs", nargs="+")
    p_pred.add_argument("--grid-points", type=int, default=8)
    p_pred.add_argument("--grid", default="default",
                        choices=["default", "fast", "faster"])
    p_pred.add_argument("--device", default=None, help="cuda (default) or cpu")

    args = parser.parse_args(argv)
    if args.cmd == "embeddings":
        from wavjepa_tpu_torch.eval.embeddings import runner

        dirs = runner(
            args.module,
            model_path=args.model,
            tasks_dir=args.tasks_dir,
            task=args.task,
            embeddings_dir=args.embeddings_dir,
            model_options=None if args.device is None else {"device": args.device},
        )
        print("\n".join(str(d) for d in dirs))
    else:
        from wavjepa_tpu_torch.eval.predictions import runner

        results = runner(
            args.embedding_dirs, grid_points=args.grid_points, grid=args.grid,
            device=args.device,
        )
        for path, res in results.items():
            test = res.get("test", res.get("aggregated_scores", {}))
            print(path, {k: v for k, v in test.items() if isinstance(v, float)})


if __name__ == "__main__":
    sys.exit(main())
