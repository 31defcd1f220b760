"""ARCH probe models in torch.

The port's copy of ``wavjepa_tpu/eval/arch/probes.py``, with the flax nets
as ``nn.Module``s on the probe's device (``cuda`` unless the caller asks
for the CPU) and every protocol decision kept:

  * linear probe, non-linear MLP (Linear → Dropout → ReLU stacks), and the
    attention-pooling classifier (a learned scalar score a token, softmax
    over the tokens, padded ones included as the JAX package pools them);
    ``SequenceProbe`` a token, with or without a BiLSTM ahead;
  * Dense layers start as flax's do (lecun-normal, truncated, zero bias);
    the LSTM's input blocks likewise, its recurrent blocks orthogonal;
  * ``torch.optim.AdamW`` with optax's ``adamw`` defaults (b1 0.9, b2 0.999,
    eps 1e-8, weight decay 1e-4, where torch's default is 1e-2), under a
    ``LambdaLR`` that is ``_warmup_linear_decay``: 10 % warmup from 0, then
    linear to 0 over max_epochs · max(1, n // batch_size) steps, counted
    as optax counts (the first update has learning rate 0);
  * batches in the order of ``np.random.default_rng(seed).permutation``, an
    epoch at a time; dropout from an explicit ``torch.Generator``;
  * the weights of the best validation loss kept (a copy);
  * metrics on the host without scikit-learn: accuracy, macro-F1 over the
    sorted union of the labels seen in targets and predictions, and macro
    and positives-weighted average precision over the label columns
    (``eval/score.binary_average_precision``: scikit-learn's tie grouping,
    AP 0 on a column with no positive).

``probe_state_dict_from_flax`` carries a flax probe's ``params`` into the
port's net.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from wavjepa_tpu_torch.api.runtime import DeviceLike, resolve_device
from wavjepa_tpu_torch.eval.predictions import dropout
from wavjepa_tpu_torch.eval.score import binary_average_precision

BETAS, EPS = (0.9, 0.999), 1e-8
WEIGHT_DECAY = 1e-4  # optax.adamw's default; torch's AdamW defaults to 1e-2
GATES = "ifgo"  # nn.LSTM's order of the gate blocks
_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def _warmup_linear_decay(total_steps: int, warmup_pct: float = 0.1) -> Callable[[int], float]:
    """The learning rate's share of its peak at update ``count`` (from 0):
    linear from 0 over the warmup, then linear to 0, and 0 after."""
    warmup = max(1, int(total_steps * warmup_pct))
    decay = max(1, total_steps - warmup)

    def share(count: int) -> float:
        if count < warmup:
            return count / warmup
        return 1.0 - min(count - warmup, decay) / decay

    return share


# ------------------------------------------------------------------ metrics


def accuracy(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def macro_f1(y_true: np.ndarray, y_pred: np.ndarray) -> float:
    """F1 a label, 2·tp / (true + predicted), averaged over the sorted union
    of the labels in ``y_true`` and ``y_pred`` (``f1_score(average="macro")``)."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    f1 = []
    for label in np.union1d(y_true, y_pred):
        t, p = y_true == label, y_pred == label
        f1.append(2.0 * np.sum(t & p) / (np.sum(t) + np.sum(p)))
    return float(np.mean(f1))


def average_precision(y_true: np.ndarray, y_score: np.ndarray, average: str = "macro") -> float:
    """AP a label column, averaged (``"macro"``) or weighted by the column's
    positives (``"weighted"``; 0 when no column has one), as
    ``average_precision_score`` of a multilabel indicator matrix."""
    y_true, y_score = np.asarray(y_true), np.asarray(y_score)
    aps = np.array([binary_average_precision(y_true[:, c], y_score[:, c])
                    for c in range(y_true.shape[1])], np.float64)
    if average == "macro":
        return float(np.mean(aps))
    if average != "weighted":
        raise ValueError(f"average must be 'macro' or 'weighted', not {average!r}")
    weights = np.sum(y_true, axis=0)
    if np.isclose(np.sum(weights), 0):
        return 0.0
    aps[weights == 0] = 0.0
    return float(np.average(aps, weights=weights))


# ------------------------------------------------------------------- nets


@torch.no_grad()
def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel initialiser for a (out, in) weight: a normal
    truncated at two deviations, of variance 1 / fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _dense(in_dim: int, out_dim: int, generator: torch.Generator) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim)
    _lecun_normal_(lin.weight, generator)
    nn.init.zeros_(lin.bias)
    return lin


class MLPNet(nn.Module):
    """Linear probe (no hidden layer) or MLP: each hidden layer Linear →
    Dropout → ReLU, then a Linear to the classes."""

    def __init__(self, in_dim: int, hidden: Sequence[int], num_classes: int, rate: float,
                 generator: torch.Generator):
        super().__init__()
        dims = [in_dim, *hidden]
        self.hidden = nn.ModuleList(_dense(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))
        self.out = _dense(dims[-1], num_classes, generator)
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for lin in self.hidden:
            x = lin(x)
            if self.training:
                x = dropout(x, self.rate, generator)
            x = torch.relu(x)
        return self.out(x)


class AttentionPoolingNet(nn.Module):
    """(B, T, E) tokens → a softmax over a learned score a token → the
    weighted sum → a Linear to the classes."""

    def __init__(self, in_dim: int, num_classes: int, generator: torch.Generator):
        super().__init__()
        self.score = _dense(in_dim, 1, generator)
        self.out = _dense(in_dim, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        weights = torch.softmax(self.score(x)[..., 0], dim=-1)
        return self.out((x * weights[..., None]).sum(dim=1))


class SequenceNet(nn.Module):
    """A Linear a token, after a BiLSTM over the tokens when ``lstm_dim``
    is given (flax's two ``nn.RNN``s of an ``LSTMCell``, the second
    reversed with its outputs in the input's order; ``nn.LSTM``'s input
    biases held at 0, as the cell has only its recurrent ones)."""

    def __init__(self, in_dim: int, num_classes: int, lstm_dim: Optional[int],
                 generator: torch.Generator):
        super().__init__()
        self.lstm = None
        if lstm_dim:
            self.lstm = nn.LSTM(in_dim, lstm_dim, batch_first=True, bidirectional=True)
            with torch.no_grad():
                for suffix in ("", "_reverse"):
                    for w_ih, w_hh in zip(
                            getattr(self.lstm, f"weight_ih_l0{suffix}").chunk(4),
                            getattr(self.lstm, f"weight_hh_l0{suffix}").chunk(4)):
                        _lecun_normal_(w_ih, generator)
                        nn.init.orthogonal_(w_hh, generator=generator)
                    # flax's cell has one bias a gate (its recurrent
                    # Dense's): the input bias stays 0 and takes no step
                    getattr(self.lstm, f"bias_ih_l0{suffix}").zero_().requires_grad_(False)
                    getattr(self.lstm, f"bias_hh_l0{suffix}").zero_()
        self.out = _dense(2 * lstm_dim if lstm_dim else in_dim, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.lstm is not None:
            x, _ = self.lstm(x)
        return self.out(x)


def probe_state_dict_from_flax(params: Mapping, mode: str = "linear") -> Dict[str, torch.Tensor]:
    """A flax probe's ``params`` → the port net's ``state_dict``: Dense
    kernels transposed; an ``LSTMCell``'s input kernels ``ii/if/ig/io`` and
    recurrent ``hi/hf/hg/ho`` (with their biases) stacked in that order
    into ``weight_ih``/``weight_hh``/``bias_hh``, ``bias_ih`` zero; the
    second cell (the reversed RNN) into the ``_reverse`` direction."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    dense = sorted((k for k in params if k.startswith("Dense_")), key=lambda k: int(k[6:]))
    if mode == "attention-pooling":
        names = ["score", "out"]
    else:
        names = [f"hidden.{i}" for i in range(len(dense) - 1)] + ["out"]
    out = {}
    for key, name in zip(dense, names):
        out[f"{name}.weight"] = t(params[key]["kernel"]).T.contiguous()
        out[f"{name}.bias"] = t(params[key]["bias"])
    for cell, suffix in (("LSTMCell_0", ""), ("LSTMCell_1", "_reverse")):
        if cell not in params:
            continue
        p = params[cell]
        out[f"lstm.weight_ih_l0{suffix}"] = torch.cat([t(p[f"i{g}"]["kernel"]).T for g in GATES])
        out[f"lstm.weight_hh_l0{suffix}"] = torch.cat([t(p[f"h{g}"]["kernel"]).T for g in GATES])
        out[f"lstm.bias_hh_l0{suffix}"] = torch.cat([t(p[f"h{g}"]["bias"]) for g in GATES])
        out[f"lstm.bias_ih_l0{suffix}"] = torch.zeros_like(out[f"lstm.bias_hh_l0{suffix}"])
    return out


# ----------------------------------------------------------------- probes


class ClassificationProbe:
    """ARCH classification probe (linear / non-linear / attention-pooling).
    The net is built at ``train`` from the width of the data, as flax
    infers it."""

    def __init__(
        self,
        layers: Sequence[int] = (),
        input_embedding_size: int = 768,
        dropout: float = 0.1,
        num_classes: int = 2,
        is_multilabel: bool = False,
        mode: str = "linear",
        verbose: bool = False,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.layers = list(layers)
        self.input_embedding_size = input_embedding_size
        self.dropout = dropout
        self.num_classes = num_classes
        self.is_multilabel = is_multilabel
        self.mode = mode
        self.verbose = verbose
        self.seed = seed
        self.device = resolve_device(device)
        self.net: Optional[nn.Module] = None

    def _init_net(self, in_dim: int) -> nn.Module:
        g = torch.Generator().manual_seed(self.seed)
        if self.mode == "attention-pooling":
            return AttentionPoolingNet(in_dim, self.num_classes, g)
        return MLPNet(in_dim, self.layers, self.num_classes, self.dropout, g)

    def _loss(self, logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.is_multilabel:
            return F.binary_cross_entropy_with_logits(logits, y)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), y.reshape(-1))

    def _labels(self, y) -> torch.Tensor:
        y = np.asarray(y)
        return torch.from_numpy(y.astype(np.float32 if self.is_multilabel else np.int64))

    # ------------------------------------------------------------ train

    def train(
        self,
        train_data: Tuple[np.ndarray, np.ndarray],
        val_data: Tuple[np.ndarray, np.ndarray],
        learning_rate: float = 1e-3,
        max_num_epochs: int = 100,
        batch_size: int = 32,
        **kwargs,
    ) -> Dict[str, float]:
        """Fit with best-val-loss model selection; returns best val metrics."""
        x_train, y_train = train_data
        n = len(x_train)
        steps_per_epoch = max(1, n // batch_size)
        dev = self.device
        self.net = net = self._init_net(np.shape(x_train)[-1]).to(dev)
        opt = torch.optim.AdamW(net.parameters(), lr=learning_rate, betas=BETAS, eps=EPS,
                                weight_decay=WEIGHT_DECAY)
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, _warmup_linear_decay(max_num_epochs * steps_per_epoch))
        x = torch.from_numpy(np.asarray(x_train, np.float32)).to(dev)
        y = self._labels(y_train).to(dev)
        rng = np.random.default_rng(self.seed)
        gen = torch.Generator(device=dev).manual_seed(self.seed + 1)
        best_loss, best_state, best_metrics = np.inf, self._state(), {}
        for epoch in range(max_num_epochs):
            net.train()
            perm = torch.from_numpy(rng.permutation(n)).to(dev)
            for i in range(0, n, batch_size):
                idx = perm[i : i + batch_size]
                loss = self._loss(net(x[idx], gen), y[idx])
                opt.zero_grad(set_to_none=True)
                loss.backward()
                opt.step()
                sched.step()
            metrics = self._evaluate_arrays(val_data)
            if metrics["loss"] < best_loss:
                best_loss, best_state, best_metrics = metrics["loss"], self._state(), metrics
            if self.verbose:
                print(f"epoch {epoch + 1}: {metrics}", flush=True)
        net.load_state_dict(best_state)
        return best_metrics

    def _state(self) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.net.state_dict().items()}

    @torch.no_grad()
    def _predict(self, x: np.ndarray) -> np.ndarray:
        """Probabilities (sigmoid or softmax) in evaluation mode, on the host."""
        self.net.eval()
        logits = self.net(torch.from_numpy(np.asarray(x, np.float32)).to(self.device))
        probs = torch.sigmoid(logits) if self.is_multilabel else torch.softmax(logits, dim=-1)
        return probs.cpu().numpy()

    # ---------------------------------------------------------- metrics

    def _evaluate_arrays(self, data) -> Dict[str, float]:
        x, y = data
        probs = self._predict(x)
        if self.is_multilabel:
            eps = 1e-7
            bce = -np.mean(
                y * np.log(probs + eps) + (1 - y) * np.log(1 - probs + eps)
            )
            return {
                "loss": float(bce),
                "map_macro": average_precision(y, probs, average="macro"),
                "map_weighted": average_precision(y, probs, average="weighted"),
            }
        pred = probs.argmax(axis=1)
        ce = -np.mean(np.log(probs[np.arange(len(y)), y] + 1e-7))
        return {
            "loss": float(ce),
            "accuracy": accuracy(y, pred),
            "f1": macro_f1(y, pred),
        }

    def evaluate(self, data: Tuple[np.ndarray, np.ndarray]) -> Dict[str, float]:
        assert self.net is not None, "train() first"
        return self._evaluate_arrays(data)


class SequenceProbe(ClassificationProbe):
    """Frame-level sequence classification probe: a Linear a token, or a
    BiLSTM then a Linear; arrays are (B, T, E) with (B, T) integer labels,
    flattened into the loss and the metrics."""

    def __init__(self, *args, use_lstm: bool = False, lstm_dim: int = 256, **kwargs):
        super().__init__(*args, mode="linear", **kwargs)
        self.lstm_dim = lstm_dim if use_lstm else None

    def _init_net(self, in_dim: int) -> nn.Module:
        return SequenceNet(in_dim, self.num_classes, self.lstm_dim,
                           torch.Generator().manual_seed(self.seed))

    def _evaluate_arrays(self, data) -> Dict[str, float]:
        x, y = data
        probs = self._predict(x)  # (B, T, C)
        flat_p = probs.reshape(-1, probs.shape[-1])
        flat_y = np.asarray(y).reshape(-1)
        pred = flat_p.argmax(axis=1)
        ce = -np.mean(np.log(flat_p[np.arange(len(flat_y)), flat_y] + 1e-7))
        return {
            "loss": float(ce),
            "accuracy": accuracy(flat_y, pred),
            "f1": macro_f1(flat_y, pred),
        }
