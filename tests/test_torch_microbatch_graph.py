"""The train step's microbatch graph (``train/step.py``:
``microbatch_graph_route``, ``MicrobatchGraph``) and the aside counting it
keeps the launch counters true with (``utils/profiling.counted_aside``).

On the CPU: the rule that engages the graph, as a plain function; the CPU
step as it was, the eager loop (``step_on`` at accum 2 bit for bit equal to
that loop written out here, its counters saying eager); the graphs kept by
signature and addresses; and the aside counting.

On the card (``card`` marker; there run ``python -m pytest --noconftest
tests/test_torch_microbatch_graph.py -m card``, as the conftest imports JAX,
which that machine lacks): two steps through the graph against two through
the eager loop from the same state, at accum 2 and 16, on a reduced
binaural Nat configuration (packing 176/256, the two-pass flash backward,
nothing replayed), a mono one (88/128, every stack replayed) and a mono
one with the fused-block predictor (``attn_impl_decoder="fused_block"``,
nothing replayed): the loss,
the gradient norm, every gradient, every weight, the teacher and AdamW's
moments bit for bit equal. Both routes run
the same kernels in the same order; the gathers' backward (a scatter-add of
atomics where several target groups pack one token) is made deterministic
in this comparison (``torch.use_deterministic_algorithms``), as its order
otherwise varies from run to run on either route. Also the counters (one
capture, ``accum`` replays a step after it), the wrappers' launches equal
on both routes, a new microbatch shape capturing again, and the one-pass
step bypassing the graph. Imports nothing of JAX."""

import copy
import warnings

import pytest
import torch

from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.ops import flash_attention as FA
from wavjepa_tpu_torch.ops import fused_attention_block as FAB
from wavjepa_tpu_torch.ops import layer_norm as LN
from wavjepa_tpu_torch.train import step as S
from wavjepa_tpu_torch.train.state import TrainState, ema_update
from wavjepa_tpu_torch.train.step import (
    MicrobatchGraph,
    OptimizerConfig,
    canonicalize_for_packing,
    jepa_loss_fn,
    make_jepa_train_step,
    make_optimizer,
    microbatch_graph_route,
    optimizer_update,
    split_leaves,
)
from wavjepa_tpu_torch.utils import profiling

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
# CPU sizes: 31 frames a channel
TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), encoder_layers=2, encoder_dim=32,
            encoder_heads=4, decoder_layers=1, decoder_dim=16, decoder_heads=4,
            sample_rate=1600, process_seconds=0.201, average_top_k_layers=2)
TINY_MASK = dict(target_masks_per_context=2, context_mask_prob=0.5, context_mask_length=4,
                 target_prob=0.2, target_length=4)
# card sizes: 200 frames a channel, head_dim 64 (encoder) and 32 (predictor)
REDUCED = dict(conv_spec=((64, 10, 5), (64, 3, 2), (64, 3, 2), (64, 3, 2), (64, 3, 2),
                          (64, 2, 2)),
               encoder_layers=2, encoder_dim=128, encoder_heads=2, decoder_layers=2,
               decoder_dim=64, decoder_heads=2, average_top_k_layers=2, dtype=torch.bfloat16)
# (channels, the configuration's own keys, the masker's): binaural Nat as its
# cell resolves it (nothing replayed), and mono with every stack replayed
# (recomputation inside the captured backward)
LAYOUTS = {
    "binaural": (2, dict(in_channels=2, extractor="conv_channel", pos_embed="binaural",
                         remat=False), dict(channel_based_masking=True)),
    "mono": (1, dict(in_channels=1, remat=True), {}),
    "fused": (1, dict(in_channels=1, remat=False, attn_impl_decoder="fused_block"), {}),
}
BUDGETS = {("binaural", "card"): (176, 256), ("binaural", "cpu"): (32, 48),
           **{(layout, where): budgets for layout in ("mono", "fused")
              for where, budgets in (("card", (88, 128)), ("cpu", (16, 24)))}}
# flash forward launches a microbatch: each stack's layers once, the
# replayed stacks' twice, the fused predictor's none
FLASH_FORWARDS = {"binaural": 6, "mono": 10, "fused": 4}
WRAPPERS = (FA.flash_attention_fwd, FA.flash_attention_bwd, FA.relbias_flash_attention_fwd,
            FAB.fused_attention_block_fwd, FAB.fused_attention_block_bwd,
            LN.layer_norm32_fwd, LN.layer_norm32_bwd)


def build(layout: str, device: torch.device, accum: int, seed: int = 0):
    """(state, step) of a seeded model of ``layout`` at the CPU's tiny or
    the card's reduced sizes."""
    channels, keys, mask = LAYOUTS[layout]
    where = "cpu" if device.type == "cpu" else "card"
    pe, pd = BUDGETS[(layout, where)]
    sizes = TINY if where == "cpu" else REDUCED
    cfg = JEPAConfig(**sizes, **keys, pack_encoder=pe, pack_decoder=pd)
    model = JEPA(cfg)
    model.init_parameters(torch.Generator().manual_seed(seed))
    model.to(device)
    masker = TimeInverseMaskConfig(**(TINY_MASK if where == "cpu" else {}), **mask)
    step = make_jepa_train_step(OptimizerConfig(**OPT), nr_samples_per_audio=8,
                                masker_cfg=masker, accum_steps=accum)
    return TrainState.create(model, make_optimizer(OptimizerConfig(**OPT), model)), step


def batch(state, step, clips: int, seed: int):
    """Crops and masks of ``clips`` seeded clips, as ``step.prepare`` makes
    them on the state's device."""
    cfg = state.model.config
    device = next(state.model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn((clips, cfg.in_channels, 2 * cfg.target_length), generator=gen)
    return step.prepare(cfg, audio.to(device), torch.Generator(device).manual_seed(seed))


def eager_reference(step, state, crops, ctx_mask, target_masks, visible_masks):
    """The accumulation step as the eager loop runs it, written out: each
    microbatch's numerator backward into fresh gradients, the sums scaled by
    the target count, EMA, clip and AdamW. Returns (loss, gradient norm)."""
    model = state.model
    cfg = model.config
    chans = cfg.in_channels if step.masker_cfg.channel_based_masking else 1
    ctx_mask, visible_masks = canonicalize_for_packing(ctx_mask, target_masks,
                                                       cfg.pack_encoder, chans)
    params = list(model.parameters())
    for p in params:
        p.grad = None
    mb = crops.shape[0] // step.accum_steps
    num_sum = den_sum = 0.0
    for i in range(step.accum_steps):
        part = slice(i * mb, (i + 1) * mb)
        num, den = jepa_loss_fn(model, state.teacher_encoder, crops[part], ctx_mask[part],
                                target_masks[part], visible_masks[part], return_terms=True)
        num.backward()
        num_sum = num_sum + num.detach()
        den_sum = den_sum + den
    inv = 1.0 / (den_sum + 1e-8)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(inv)
    ema_update(state.teacher_encoder, model.encoder, step.ema_schedule(state.step))
    g_norm = optimizer_update(params, state.optimizer, step.lr_schedule(state.step),
                              step.grad_clip, split_leaves(model))
    state.step += 1
    return num_sum * inv, g_norm


def readings(state) -> dict:
    """Every tensor a step leaves: weights, gradients, teacher, AdamW's
    moments."""
    out = {}
    for name, p in state.model.named_parameters():
        out[f"weight {name}"] = p.detach().clone()
        out[f"grad {name}"] = torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for key, value in state.optimizer.state.get(p, {}).items():
            if torch.is_tensor(value):
                out[f"adamw {key} {name}"] = value.clone()
    for name, p in state.teacher_encoder.named_parameters():
        out[f"teacher {name}"] = p.detach().clone()
    return out


def unequal(a: dict, b: dict) -> list:
    assert a.keys() == b.keys()
    return [k for k in a if not torch.equal(a[k], b[k])]


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("device, accum, model_parallel, engages", [
    ("cpu", 16, 1, False),
    ("cpu", 1, 1, False),
    ("cuda", 1, 1, False),  # one pass
    ("cuda", 16, 2, False),  # tensor parallelism: collectives inside the forward
    ("cuda", 2, 1, True),
    ("cuda", 16, 1, True),
    ("cuda:1", 16, 1, True),
])
def test_the_graph_engages_on_a_card_with_microbatches_outside_tensor_parallelism(
        device, accum, model_parallel, engages):
    assert microbatch_graph_route(torch.device(device), accum, model_parallel) is engages


@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_cpu_step_is_the_eager_loop_bit_for_bit(layout):
    state, step = build(layout, torch.device("cpu"), accum=2)
    twin = copy.deepcopy(state)
    for k in range(2):
        inputs = batch(state, step, clips=2, seed=10 + k)
        with profiling.recording() as rec:
            _, metrics = step.step_on(state, *inputs)
        loss, g_norm = eager_reference(step, twin, *inputs)
        assert torch.equal(metrics["loss"], loss) and torch.equal(metrics["grad_norm"], g_norm)
        assert unequal(readings(state), readings(twin)) == []
        assert rec.counters["train.microbatch_eager"] == 2
        assert "train.graph_replay" not in rec.counters
        assert "train.graph_capture" not in rec.counters
        # the eager loop's forward and backward spans, one each a microbatch
        names = [s.name for s in rec.spans]
        assert names.count("train.forward") == names.count("train.backward") == 2
    assert step._graphs == {}


def test_the_one_pass_step_counts_its_microbatch_as_eager():
    state, step = build("mono", torch.device("cpu"), accum=1)
    with profiling.recording() as rec:
        step.step_on(state, *batch(state, step, clips=1, seed=3))
    assert rec.counters["train.microbatch_eager"] == 1


def test_a_graph_is_kept_by_signature_and_made_anew_where_addresses_moved():
    state, step = build("mono", torch.device("cpu"), accum=2)
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    crops, ctx, tgt, vis = batch(state, step, clips=2, seed=1)
    first = [x[:8] for x in (crops, ctx, tgt, vis)]
    graph = step._graph(state, first)
    assert step._graph(state, [x.clone() for x in first]) is graph  # same signature
    assert all(buf.shape == x.shape and buf.dtype == x.dtype
               for buf, x in zip(graph.inputs, first))
    other = step._graph(state, [x[:4] for x in first])  # another microbatch shape
    assert other is not graph and len(step._graphs) == 2
    assert step._graph(state, first) is graph
    p = next(state.model.parameters())
    p.grad = torch.zeros_like(p)  # a gradient moved: the graph would add into the old one
    moved = step._graph(state, first)
    assert moved is not graph and moved.bound == MicrobatchGraph.addresses(
        state.model, state.teacher_encoder)
    state.model.eval()  # the training mode is part of the signature
    assert step._graph(state, first) is not moved


def test_a_signature_holds_the_switches_that_choose_library_kernels():
    state, step = build("mono", torch.device("cpu"), accum=2)
    first = [x[:8] for x in batch(state, step, clips=2, seed=1)]
    key = MicrobatchGraph.signature(state.model, state.teacher_encoder, first)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = not old
        assert MicrobatchGraph.signature(state.model, state.teacher_encoder, first) != key
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        assert MicrobatchGraph.signature(state.model, state.teacher_encoder, first) != key
    finally:
        torch.use_deterministic_algorithms(False)
    assert MicrobatchGraph.signature(state.model, state.teacher_encoder, first) == key


def test_counted_aside_keeps_work_out_and_a_tally_adds_it_back():
    assert all(fn in profiling.LAUNCH_COUNTED for fn in WRAPPERS)
    before = FA.flash_attention_fwd.launches
    with profiling.recording() as rec:
        profiling.count("x", 1)
        with profiling.counted_aside() as tally:
            profiling.count("x", 2)
            FA.flash_attention_fwd.launches += 3
            LN.layer_norm32_bwd.launches += 1
        assert rec.counters["x"] == 1  # the aside block's count is not in the recording
        assert FA.flash_attention_fwd.launches == before  # nor its launches
        assert tally.counts == {"x": 2}
        assert tally.launches == {FA.flash_attention_fwd: 3, LN.layer_norm32_bwd: 1}
        tally.add()
        tally.add()
        assert rec.counters["x"] == 5
        assert FA.flash_attention_fwd.launches == before + 6
    FA.flash_attention_fwd.launches = before
    LN.layer_norm32_bwd.launches -= 2
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.counted_aside(), profiling.counted_aside():
            pass


def test_counted_aside_counts_while_no_recording_is_open():
    with profiling.counted_aside() as tally:
        profiling.count("y", 4)
    assert tally.counts == {"y": 4}
    tally.add()  # no recording open: nothing to add to, nothing raised


# ----------------------------------------------------------------- card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); a CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def deterministic():
    """The gathers' backward in a fixed order on both routes."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def run_route(state, step, inputs: list, graphed: bool, monkeypatch) -> list:
    """The steps on ``inputs`` through the graph or the eager loop (the
    rule patched to say no); each step's (loss, norm, counters, launches,
    readings)."""
    out = []
    with monkeypatch.context() as m:
        if not graphed:
            m.setattr(S, "microbatch_graph_route", lambda *a: False)
        for x in inputs:
            start = launches()
            with profiling.recording() as rec:
                _, metrics = step.step_on(state, *x)
            torch.cuda.synchronize()
            done = {k: n - start[k] for k, n in launches().items()}
            out.append((metrics["loss"].clone(), metrics["grad_norm"].clone(),
                        dict(rec.counters), done, readings(state)))
    return out


@pytest.mark.card
@pytest.mark.parametrize("accum", [2, 16])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_the_captured_step_equals_the_eager_loop(card, deterministic, monkeypatch, layout,
                                                 accum):
    state, step = build(layout, card, accum)
    twin = copy.deepcopy(state)
    inputs = [batch(state, step, clips=4, seed=20 + k) for k in range(2)]
    graphed = run_route(state, step, inputs, True, monkeypatch)
    eager = run_route(twin, step, inputs, False, monkeypatch)
    for k, (g, e) in enumerate(zip(graphed, eager)):
        assert torch.equal(g[0], e[0]), (k, g[0].item(), e[0].item())
        assert torch.equal(g[1], e[1]), (k, g[1].item(), e[1].item())
        assert unequal(g[4], e[4]) == [], k
        assert g[3] == e[3], (k, g[3], e[3])  # the wrappers count what the card ran
        assert g[2].get("layer_norm.kernel") == e[2].get("layer_norm.kernel")
    # step 1 captures (its microbatch 0 eager), step 2 replays every microbatch
    assert [c.get("train.graph_capture", 0) for _, _, c, _, _ in graphed] == [1, 0]
    assert [c.get("train.graph_replay", 0) for _, _, c, _, _ in graphed] == [accum - 1, accum]
    assert [c.get("train.microbatch_eager", 0) for _, _, c, _, _ in graphed] == [1, 0]
    assert [c.get("train.microbatch_eager", 0) for _, _, c, _, _ in eager] == [accum, accum]
    assert graphed[1][3]["flash_attention_fwd"] == FLASH_FORWARDS[layout] * accum


@pytest.mark.card
def test_a_new_microbatch_shape_captures_again(card):
    state, step = build("binaural", card, accum=2)
    counts = []
    for clips in (4, 2, 4, 2):
        with profiling.recording() as rec:
            step.step_on(state, *batch(state, step, clips=clips, seed=clips))
        counts.append((rec.counters.get("train.graph_capture", 0),
                       rec.counters.get("train.graph_replay", 0)))
    assert counts == [(1, 1), (1, 1), (0, 2), (0, 2)]
    assert len(step._graphs) == 2


@pytest.mark.card
def test_the_one_pass_step_bypasses_the_graph_on_the_card(card):
    state, step = build("mono", card, accum=1)
    with profiling.recording() as rec:
        step.step_on(state, *batch(state, step, clips=1, seed=5))
    assert rec.counters["train.microbatch_eager"] == 1
    assert "train.graph_replay" not in rec.counters and step._graphs == {}
