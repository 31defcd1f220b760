"""The plain WavJEPA training step, in float32, and what it is compared by.

One step, as the published recipe describes it: ``n`` random 2.01-s crops
of each clip, each normalised to zero mean and unit standard deviation;
context and target span masks (the time-inverse masker: context spans
kept with probability 0.65, four target groups of spans, the context
stripped of every target, of K candidates the first whose context covers
the cutoff share); the student's context encoder over the visible context,
the predictor over mask tokens at the positions of each target group, the
teacher (an EMA copy of the encoder) over the whole crop, whose top k
block outputs, each instance-normed, averaged, are the targets; the loss is
the mean squared error over target positions; its gradient clipped by
global norm; AdamW with decoupled weight decay; the teacher's EMA from the
student before its update.

Two settings of the run fix the arithmetic beyond the recipe, and are read
from the configuration file, not the program: the token budgets
(``pack_encoder``: context tokens past it are masked; ``pack_decoder``: a
target group sees its targets first, then its context in order, up to
it), and the random draws, which follow the recipe's generator calls on a
``torch.Generator`` seeded per step (``step_seed``) on the device, so that
the same seed gives the same crops and masks in the program and here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from wavbench.reference import model as M
from wavbench.reference.precision import PRECISIONS
from wavbench.reference.scenes import scene


def step_seed(seed: int, step: int) -> int:
    return (seed * 1_000_003 + step) % (2**63)


def lr_at(opt: dict, step: int) -> float:
    if step < opt["warmup_steps"]:
        return opt["lr"] * step / max(1.0, opt["warmup_steps"])
    progress = (step - opt["warmup_steps"]) / max(1.0, opt["total_steps"] - opt["warmup_steps"])
    return opt["lr"] * max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def ema_at(ema: dict, step: int) -> float:
    if step >= ema["anneal_end_step"]:
        return ema["end_decay"]
    return ema["end_decay"] - (ema["end_decay"] - ema["start_decay"]) * (
        1.0 - step / ema["anneal_end_step"])


# ------------------------------------------------------------ crops, masks


def _spans(gen, rows: int, t: int, prob: float, length: int) -> torch.Tensor:
    """(rows, t) bool: floor(prob·t/length + U) spans of ``length`` at
    distinct uniform starts in [0, t − length)."""
    dev = gen.device
    most = int(math.floor(prob * t / length)) + 1
    count = torch.floor(prob * t / length + torch.rand(rows, generator=gen, device=dev))
    starts = torch.rand((rows, t - length), generator=gen, device=dev).topk(most, -1).indices
    live = torch.arange(most, device=dev) < count[:, None]
    pos = torch.arange(t, device=dev)
    inside = (pos >= starts[..., None]) & (pos < starts[..., None] + length) & live[..., None]
    return inside.any(dim=1)


def masks(gen, rows: int, m: dict, mk: dict):
    """(ctx_mask (R, T) True = not context, target_masks (R, N, T))."""
    chans = m["in_channels"] if mk["channel_based_masking"] else 1
    t = M.tokens(m) // chans
    k, n = mk["n_candidates"], mk["target_masks_per_context"]
    ctx_cover = _spans(gen, rows * k, t, mk["context_mask_prob"],
                       mk["context_mask_length"]).reshape(rows, k, t)
    targets = _spans(gen, rows * k * n, t, mk["target_prob"],
                     mk["target_length"]).reshape(rows, k, n, t)
    ctx = ~ctx_cover & ~targets.any(dim=2)
    share = ctx.float().mean(dim=-1)
    good = share >= mk["ratio_cutoff"]
    pick = torch.where(good.any(1), good.int().argmax(1), share.argmax(1))
    row = torch.arange(rows, device=ctx.device)
    ctx_mask, tgt = ~ctx[row, pick], targets[row, pick]
    if chans > 1:  # the same mask for every channel's tokens, channel-major
        ctx_mask = ctx_mask.repeat(1, chans)
        tgt = tgt.repeat(1, 1, chans)
    return ctx_mask, tgt


def crops_and_masks(audio: torch.Tensor, step: int, seed: int, m: dict, run: dict):
    """(B, C, L) float audio → crops (B·n, C, crop) float32, ctx_mask,
    target masks (after the encoder budget), and the decoder's key mask and
    loss weights of each target group, all from the step's generator."""
    gen = torch.Generator(device=audio.device).manual_seed(step_seed(seed, step))
    b, c, length = audio.shape
    n, crop = run["samples_per_audio"], M.crop_samples(m)
    starts = torch.randint(0, length - crop + 1, (b, n), generator=gen, device=audio.device)
    idx = starts[..., None] + torch.arange(crop, device=audio.device)
    crops = torch.stack([audio[i][:, idx[i]] for i in range(b)])  # (B, C, n, crop)
    crops = crops.transpose(1, 2).reshape(b * n, c, crop).double()
    mean = crops.mean(dim=(1, 2), keepdim=True)
    std = ((crops - mean).square().sum(dim=(1, 2), keepdim=True) / (c * crop - 1)).sqrt()
    crops = ((crops - mean) / (std + 1e-5)).float()
    ctx_mask, tgt = masks(gen, b * n, m, run["masker"])
    chans = m["in_channels"] if run["masker"]["channel_based_masking"] else 1
    if m.get("pack_encoder"):  # context past the budget is masked, a channel at a time
        vis = (~ctx_mask).reshape(b * n, chans, -1)
        ctx_mask = ctx_mask | (vis.cumsum(-1) > m["pack_encoder"] // chans).reshape(b * n, -1)
    seen = ~(ctx_mask[:, None, :] ^ tgt)  # what each group's predictor sees
    is_tgt = seen & ctx_mask[:, None, :]
    is_ctx = seen & ~ctx_mask[:, None, :]
    if m.get("pack_decoder"):  # targets first, then context in order, up to the budget
        pd = m["pack_decoder"]
        kept_tgt = is_tgt & (is_tgt.cumsum(-1) <= pd)
        room = pd - kept_tgt.sum(-1, keepdim=True)
        kept = kept_tgt | (is_ctx & (is_ctx.cumsum(-1) <= room))
    else:
        kept = seen
    return crops, ctx_mask, tgt, ~kept, tgt & kept


# --------------------------------------------------------------- one step


def _teacher_targets(feats, T, m, q):
    with torch.no_grad():
        outs = M.transformer(feats, T, "encoder", m["encoder_layers"], m["encoder_heads"],
                             torch.zeros(feats.shape[:2], dtype=torch.bool, device=feats.device),
                             m["layer_norm_eps"], q, every_layer=True)
        k = m["average_top_k_layers"]
        acc = 0.0
        for x in outs[-k:]:
            mean = x.mean(dim=(1, 2), keepdim=True)
            var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
            acc = acc + (x - mean) / torch.sqrt(var + 1e-5)
        return acc / k


def _block_loss_numerator(P, T, m, crops, ctx_mask, dec_mask, weights, q):
    feats = M.features(crops, P, m, q)
    targets = _teacher_targets(feats.detach(), T, m, q)
    enc = M.transformer(feats, P, "encoder", m["encoder_layers"], m["encoder_heads"], ctx_mask,
                        m["layer_norm_eps"], q)
    proj = M.linear(enc, P["encoder_to_decoder_mapper.weight"],
                    P["encoder_to_decoder_mapper.bias"], q)
    canvas = torch.where(ctx_mask[..., None], P["mask_token"], proj)
    canvas = canvas + M.pos_table(m, m["decoder_dim"], canvas.device)
    r, n, t = dec_mask.shape
    dec_in = canvas[:, None].expand(r, n, t, canvas.shape[-1]).reshape(r * n, t, -1)
    dec = M.transformer(dec_in, P, "decoder", m["decoder_layers"], m["decoder_heads"],
                        dec_mask.reshape(r * n, t), m["layer_norm_eps"], q)
    preds = M.linear(dec, P["decoder_to_encoder_mapper.weight"],
                     P["decoder_to_encoder_mapper.bias"], q).reshape(r, n, t, -1)
    per_pos = (preds - targets[:, None]).square().mean(dim=-1)
    return (per_pos * weights).sum()


def reference_step(state: dict, audio: torch.Tensor, step: int, seed: int, m: dict, run: dict,
                   precision: str = "exact", rows: slice = slice(None)) -> dict:
    """One step on (B, C, L) float audio, in place on ``state`` (``P``
    student leaves with ``requires_grad``, ``T`` teacher encoder leaves,
    ``m``/``v`` AdamW moments, ``k`` AdamW's step count). ``rows`` keeps a
    part of the step's crops (the check of a step that drops part of its
    batch). Returns the loss and each leaf's gradient as AdamW took it."""
    q = PRECISIONS[precision]
    P, T = state["P"], state["T"]
    crops, ctx_mask, tgt, dec_mask, weights = crops_and_masks(audio, step, seed, m, run)
    crops, ctx_mask, tgt, dec_mask, weights = (z[rows] for z in
                                               (crops, ctx_mask, tgt, dec_mask, weights))
    den = tgt.float().sum()
    block = run["reference_block"]
    total = 0.0
    with M.float32_matmul():
        for lo in range(0, crops.shape[0], block):
            part = slice(lo, lo + block)
            num = _block_loss_numerator(P, T, m, crops[part], ctx_mask[part], dec_mask[part],
                                        weights[part].float(), q)
            num.backward()
            total = total + num.detach()
    opt, ema = run["optimizer"], run["ema"]
    with torch.no_grad():
        names = list(P)
        grads = [P[k].grad / (den + 1e-8) for k in names]
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        if norm >= opt["grad_clip"]:
            grads = [g * (opt["grad_clip"] / norm).float() for g in grads]
        decay = ema_at(ema, step)  # the teacher from the student before its update
        for k in T:
            T[k].mul_(decay).add_(P[k], alpha=1.0 - decay)
        lr = lr_at(opt, step)
        state["k"] += 1
        c1 = 1.0 - opt["b1"] ** state["k"]
        c2 = 1.0 - opt["b2"] ** state["k"]
        for k, g in zip(names, grads):
            mom, var = state["m"][k], state["v"][k]
            mom.mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
            var.mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
            p = P[k]
            p.mul_(1.0 - lr * opt["weight_decay"])
            p.sub_(lr * (mom / c1) / ((var / c2).sqrt() + opt["eps"]))
            p.grad = None
    return {"loss": float(total / (den + 1e-8)), "grads": dict(zip(names, grads))}


def fresh_state(weights: dict) -> dict:
    """A reference train state from the benchmark's initial weights: the
    student, the teacher as a copy of its encoder, zero moments."""
    P = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    T = {k: v.detach().clone() for k, v in weights.items() if k.startswith("encoder.")}
    zeros = {k: torch.zeros_like(v) for k, v in weights.items()}
    return {"P": P, "T": T, "m": zeros, "v": {k: torch.zeros_like(v) for k, v in weights.items()},
            "k": 0}


def to_audio(batch, m: dict, run: dict, device) -> torch.Tensor:
    """A traffic batch (host arrays) → (B, C, L) float32 clips at the
    model's rate on ``device``: a mono batch as it is, a scene batch through
    the plain scene synthesis."""
    if isinstance(batch, dict):
        parts = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return scene(parts, m["in_channels"], run["scene_rate"], m["sample_rate"]).float()
    x = torch.from_numpy(batch).to(device).float()
    return x if x.dim() == 3 else x[:, None, :]


# -------------------------------------------------------------- readings


def leaf_gap(program: dict, reference: dict, counted) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median leaf's:
    (gap, leaf)."""
    ref = {k: reference[k] for k in counted}
    median = sorted(ref.values())[len(ref) // 2]
    worst, name = 0.0, ""
    for k, r in ref.items():
        gap = abs(program[k] - r) / max(r, median, 1e-30)
        if gap > worst:
            worst, name = gap, k
    return worst, name


def leaf_distances(program: dict, reference: dict, counted) -> dict:
    """Each counted leaf's distance between the program's tensor and the
    reference's, against the larger of that leaf's reference norm and the
    median leaf's."""
    ref = {k: float(reference[k].double().norm()) for k in counted}
    median = sorted(ref.values())[len(ref) // 2]
    return {k: float((program[k].to(reference[k].device).double() - reference[k].double()).norm())
            / max(r, median, 1e-30) for k, r in ref.items()}


def counted_leaves(grad_norms: dict) -> list:
    """Leaves whose reference gradient is more than a thousandth of the
    median leaf's: the others move under AdamW by round-off alone. A teacher
    leaf counts with the student leaf it follows."""
    median = sorted(grad_norms.values())[len(grad_norms) // 2]
    return [k for k, g in grad_norms.items() if g > 1e-3 * median]


def norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}
