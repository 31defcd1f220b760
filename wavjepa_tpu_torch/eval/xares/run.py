"""X-ARES task runner.

``python -m wavjepa_tpu_torch.eval.xares.run <task> [--ckpt PATH] [--device cpu]``

The port's copy of ``wavjepa_tpu/eval/xares/run.py``. Where the ``xares``
package is installed it hands over to the real harness (``python -m
xares.run encoder.py src/tasks/<task>``), the checkpoint passed in
``WAVJEPA_CKPT``. Without it, it runs the same protocol end to end on a
synthetic stub task:

    frozen encoder → frame embeddings → mean-pool → linear probe → accuracy

and warns that the number is not an X-ARES score when a real task was
named. The probe trains on ``cuda`` unless ``device="cpu"`` is given:
full-batch Adam (lr 1e-2, 300 steps) on standardised features, from
0.01 · N(0, 1) weights drawn from a seeded ``torch.Generator`` and zero
biases (``_init_probe``); ``_fit_probe`` takes the initial weights, so that
a test can start the JAX package's probe and this one from the same.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device


def _make_stub_task(sr: int, n_classes: int = 4, per_class: int = 24, seconds: float = 2.5, seed: int = 0):
    """Synthetic tone-vs-noise classification task: class k = tone at
    f0·2^k plus noise. Returns (train, test) lists of (waveform, label)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    data = []
    for k in range(n_classes):
        f = 220.0 * (2.0**k)
        for _ in range(per_class):
            phase = rng.uniform(0, 2 * np.pi)
            amp = rng.uniform(0.3, 0.9)
            wav = amp * np.sin(2 * np.pi * f * t + phase)
            wav += 0.05 * rng.standard_normal(t.size)
            data.append((wav.astype(np.float32), k))
    rng.shuffle(data)
    split = int(0.75 * len(data))
    return data[:split], data[split:]


def _embed(encoder, items, batch_size: int = 8):
    xs, ys = [], []
    for i in range(0, len(items), batch_size):
        batch = items[i : i + batch_size]
        wav = torch.from_numpy(np.stack([w for w, _ in batch]))
        emb = encoder(wav)  # (B, T', D)
        xs.append(emb.mean(dim=1).float().cpu().numpy())  # scene-level mean pool
        ys.extend(lbl for _, lbl in batch)
    return np.concatenate(xs), np.asarray(ys, np.int64)


def _init_probe(n_features: int, n_classes: int, seed: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial (w, b): 0.01 · N(0, 1) weights from a seeded generator, zero
    biases."""
    g = torch.Generator().manual_seed(seed)
    return 0.01 * torch.randn(n_features, n_classes, generator=g), torch.zeros(n_classes)


def _fit_probe(x: np.ndarray, y: np.ndarray, w: torch.Tensor, b: torch.Tensor,
               loss_fn: Callable, steps: int, lr: float, device: DeviceLike = None):
    """Full-batch Adam from (w, b) on the standardised x → ((w, b) as numpy,
    (mean, std), the last step's loss)."""
    dev = resolve_device(device)
    mu, sd = x.mean(0), x.std(0) + 1e-6
    xt = torch.from_numpy(np.asarray((x - mu) / sd, np.float32)).to(dev)
    yt = torch.from_numpy(np.asarray(y)).to(dev)
    params = [p.detach().clone().float().to(dev).requires_grad_() for p in (w, b)]
    opt = torch.optim.Adam(params, lr=lr)
    for _ in range(steps):
        loss = loss_fn(xt @ params[0] + params[1], yt)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return tuple(p.detach().cpu().numpy() for p in params), (mu, sd), loss.item()


def _train_probe(x, y, n_classes, steps: int = 300, lr: float = 1e-2, seed: int = 0,
                 device: DeviceLike = None):
    """Linear probe under softmax cross-entropy (the xares MLP-probe
    protocol at its smallest setting); y integer labels."""
    w, b = _init_probe(x.shape[1], n_classes, seed)
    return _fit_probe(x, np.asarray(y, np.int64), w, b, F.cross_entropy, steps, lr, device)


def run_stub_task(encoder, task: str = "stub", seed: int = 0, device: DeviceLike = None) -> dict:
    train, test = _make_stub_task(encoder.sampling_rate, seed=seed)
    x_tr, y_tr = _embed(encoder, train)
    x_te, y_te = _embed(encoder, test)
    n_classes = int(y_tr.max()) + 1
    params, (mu, sd), train_loss = _train_probe(x_tr, y_tr, n_classes, seed=seed,
                                                device=device)
    logits = (x_te - mu) / sd @ params[0] + params[1]
    acc = float((logits.argmax(-1) == y_te).mean())
    return {"task": task, "metric": "accuracy", "value": acc, "train_loss": train_loss,
            "n_train": len(y_tr), "n_test": len(y_te)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("task", nargs="?", default="stub")
    ap.add_argument("--ckpt", default="", help="a port or reference .ckpt")
    ap.add_argument("--max-jobs", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if importlib.util.find_spec("xares") is not None and args.task != "stub":
        # the real harness: hand over as its launcher does; the checkpoint
        # travels in WAVJEPA_CKPT, which encoder.WavJEPAEncoder's no-argument
        # constructor reads
        import os
        import subprocess

        env = dict(os.environ)
        if args.ckpt:
            env["WAVJEPA_CKPT"] = args.ckpt
        # bare task filenames live under the xares checkout's src/tasks/;
        # XARES_TASKS_DIR points there
        task = args.task
        if not os.path.exists(task) and os.sep not in task:
            task = os.path.join(
                os.environ.get("XARES_TASKS_DIR", "src/tasks"), task
            )
        enc_path = __file__.replace("run.py", "encoder.py")
        cmd = [sys.executable, "-m", "xares.run", "--max-jobs", str(args.max_jobs),
               enc_path, task]
        raise SystemExit(subprocess.call(cmd, env=env))

    from wavjepa_tpu_torch.eval.xares.checker import check_audio_encoder
    from wavjepa_tpu_torch.eval.xares.encoder import WavJEPAEncoder

    if args.task != "stub":
        # never let a synthetic-stub accuracy pass for a real benchmark
        print(
            f"WARNING: xares is not installed — running the built-in "
            f"SYNTHETIC stub task, NOT {args.task!r}; the reported metric is "
            f"not an X-ARES score",
            file=sys.stderr,
        )
    encoder = WavJEPAEncoder(ckpt_path=args.ckpt, device=args.device)
    check_audio_encoder(encoder)
    result = run_stub_task(
        encoder, "stub" if args.task == "stub" else f"stub({args.task})", device=args.device
    )
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
