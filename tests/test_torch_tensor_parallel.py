"""Tensor parallelism of the port (``trainer.model_parallel``,
``wavjepa_tpu_torch/parallel/mesh.py``) on the CPU, over gloo.

This file runs itself as a worker, as tests/test_torch_parallel.py does:
``python tests/test_torch_tensor_parallel.py PORT RANK WORLD DIR`` is one
rank of a group of WORLD at model_parallel 2, laid out as (data WORLD/2,
model 2); two groups start together, a pair (data 1, model 2) and a quad
(data 2, model 2), and a third process (``... alone DIR``) runs the same
legs at model_parallel 1 in no group. Each writes what it saw to
``DIR/<name>.pt``, and the train CLI runs under ``torch.distributed.run
--nproc_per_node=2`` at model_parallel 2 beside them. The tests hold the
ranks against:

* the JAX package's step with the state placed by ``shard_train_state`` on
  ``make_mesh(n, model_parallel=2)`` (the conftest's 8 virtual CPU
  devices), n = 2 and 4, on the same crops and masks: loss rtol 1e-5,
  gradient norm rtol 1e-4 (tests/test_torch_train_step.py's);
* the port's one-process run: losses rtol 1e-5, gradient norms rtol 1e-4,
  per-leaf step-1 gradients rtol 1e-5 atol 1e-6 (MULTICHIP_r05.json's
  gate), weights after the steps atol 2e-6 rtol 1e-4, through ``step_on``
  and through ``build_run`` from synthetic clips; the Nat and the denoise
  step likewise, one step each;
* each other: every rank's whole weights bit for bit, and the replicated
  leaves each rank holds bit for bit across its tensor-parallel group;
* checkpoints: a model_parallel 2 run resumed at model_parallel 2 repeats
  the uninterrupted run bit for bit; at model_parallel 1 it resumes, and
  ``load_model`` serves it;
* recomputation: the pair's step with every stack replayed equals the same
  layout's step without it, bit for bit.

Without ranks: ``tp_rule`` against the JAX package's
``param_sharding_rules`` leaf by leaf (names mapped through
``api/convert.py``), the shards and their joins, the refusals, and the
fused block's plain version at a subset of the heads against the JAX
package's plain attention on the same heads. f32 throughout.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
MP = 2
STEPS = 3
GROUPS = {"pair": 2, "quad": 4}  # name → world size; (data 1, model 2), (data 2, model 2)
# tests/test_torch_parallel.py's tiny run (4 clips a step), its Nat run, and
# the denoise CLI's configuration at that size
TINY_RUN = [
    "data.synthetic=true", "trainer.size=tiny", "trainer.batch_size=4",
    "data.samples_per_audio=2", "data.sr=1600", "data.process_seconds=0.201",
    "data.target_seconds=1.0", "extractor.conv_spec=[[16,10,5],[16,3,2]]",
    "trainer.average_top_k_layers=2", "trainer.precision=f32", "trainer.log_every=1",
    "optimizer.warmup_steps=1",
]
NAT_RUN = [
    "data.nat_scenes=true", "data.in_channels=2", "extractor.channel_wise=true",
    "extractor.pos_embed=binaural", "masker.channel_based_masking=true", "trainer.size=tiny",
    "trainer.batch_size=4", "data.samples_per_audio=2", "data.process_seconds=0.201",
    "data.target_seconds=0.5", "trainer.precision=f32", "optimizer.warmup_steps=1",
]


def _config(items):
    from wavjepa_tpu_torch.train.config import Config, apply_overrides

    return apply_overrides(Config(), list(items))


def _clone(sd: dict) -> dict:
    return {k: v.detach().clone() for k, v in sd.items()}


def _whole_grads(module) -> dict:
    from wavjepa_tpu_torch.parallel.mesh import gather_params

    return _clone(gather_params({k: p.grad for k, p in module.named_parameters()}))


# --------------------------------------------------------------- the legs
# Each runs in every rank of both groups at model_parallel 2, and in the
# one-process run at 1, and returns what the tests compare.


def leg_step_on(inputs: dict, mp: int) -> dict:
    """Three steps of ``step_on`` from tests/test_torch_train_step.py's
    weights (the whole model built, then this rank's shard of it) on given
    global crops and masks, of which a data-parallel rank takes its rows."""
    from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
    from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
    from wavjepa_tpu_torch.parallel.mesh import init_layout, shard_batch, sharded
    from wavjepa_tpu_torch.train.state import TrainState
    from wavjepa_tpu_torch.train.step import (
        EMAConfig,
        OptimizerConfig,
        make_jepa_train_step,
        make_optimizer,
    )

    tiny, opt, mask, ema_end = inputs["config"]
    init_layout(mp)
    model = JEPA(JEPAConfig(**tiny))
    model.load_state_dict(inputs["state_dict"])
    if mp > 1:
        model = sharded(model, JEPA(JEPAConfig(**tiny), mp))
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**opt), model))
    step = make_jepa_train_step(OptimizerConfig(**opt), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**mask),
                                ema_cfg=EMAConfig(anneal_end_step=ema_end))
    out = {"loss": [], "grad_norm": []}
    for batch in inputs["batches"]:
        state, m = step.step_on(state, *(shard_batch(torch.from_numpy(x)) for x in batch))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        if "grads" not in out:
            out["grads"] = _whole_grads(state.model)
    out["weights"] = _clone(state.weights())
    out["local"] = _clone(dict(state.model.named_parameters()))
    return out


def _tensors(batch):
    if isinstance(batch, dict):
        return {k: _tensors(v) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch))


def _loop_steps(state, step_fn, batches, seed: int, n_steps: int) -> dict:
    """``n_steps`` of ``run_step`` as ``train/loop.run_loop`` takes them,
    each step's generator seeded from (seed, step)."""
    from wavjepa_tpu_torch.train.loop import run_step, step_seed

    generator = torch.Generator()
    student = state.model if hasattr(state, "model") else state.student
    out = {"loss": [], "grad_norm": []}
    for _ in range(n_steps):
        generator.manual_seed(step_seed(seed, state.step))
        state, m = run_step(step_fn, state, _tensors(next(batches)), generator)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if "grads" not in out:
            out["grads"] = _whole_grads(student)
    out["weights"] = _clone(state.weights())
    return out


def leg_seeded(items, mp: int, steps: int) -> dict:
    """``build_run`` (the seeded whole model, this rank's shard) and its
    step from the run's own synthetic data (clips or scene batches)."""
    from wavjepa_tpu_torch.train.loop import build_data_iterator, build_run

    cfg = _config([*items, f"trainer.model_parallel={mp}"])
    _, _, state, step_fn = build_run(cfg, device="cpu")
    return _loop_steps(state, step_fn, iter(build_data_iterator(cfg)), cfg.trainer.seed, steps)


def leg_denoise(mp: int) -> dict:
    """``build_denoise_run`` (a whole seeded teacher on every rank, the
    student this rank's shard of it) and one step from synthetic scenes."""
    from wavjepa_tpu_torch.denoise import denoise_config
    from wavjepa_tpu_torch.train.denoise_loop import build_denoise_data_iterator, build_denoise_run

    cfg = denoise_config([*TINY_RUN, f"trainer.model_parallel={mp}"])
    _, _, state, step_fn = build_denoise_run(cfg, device="cpu")
    return _loop_steps(state, step_fn, iter(build_denoise_data_iterator(cfg)),
                       cfg.trainer.seed, 1)


# the pair's recomputation leg: every stack replayed, and none
REMAT_LEGS = {"full": ["trainer.remat_conv=true", "trainer.remat_encoder=true",
                       "trainer.remat_decoder=true"],
              "none": ["trainer.remat=false"]}


def leg_remat(mp: int) -> dict:
    """One step of ``leg_seeded``'s run with every stack replayed, and one
    with none, each with the flags its model was built with (conv,
    encoder, decoder)."""
    from wavjepa_tpu_torch.train.loop import build_data_iterator, build_run

    out = {}
    for name, flags in REMAT_LEGS.items():
        cfg = _config([*TINY_RUN, *flags, f"trainer.model_parallel={mp}"])
        _, _, state, step_fn = build_run(cfg, device="cpu")
        model = state.model
        out[name] = _loop_steps(state, step_fn, iter(build_data_iterator(cfg)),
                                cfg.trainer.seed, 1)
        out[name]["replayed"] = [model.extract_audio.remat, model.encoder.layers[0].remat,
                                 model.decoder.layers[0].remat]
    return out


def leg_resume(root: Path) -> dict:
    """``train_jepa`` at model_parallel 2 for 4 steps, and for 2 then
    resumed to 4, checkpointing every step: the whole final weights of
    both."""
    from wavjepa_tpu_torch.train.loop import train_jepa

    out = {}
    for name, stops in (("whole", (4,)), ("resumed", (2, 4))):
        cfg = _config([*TINY_RUN, f"trainer.model_parallel={MP}", "trainer.ckpt_every=1",
                       f"trainer.save_dir={root / name}"])
        for stop in stops:
            state = train_jepa(cfg, max_steps=stop, device="cpu")
        out[name] = _clone(state.weights())
    return out


def refusals() -> dict:
    """What ``build_model_config`` raises in this process's group: a
    model_parallel that does not divide the world, and a batch of 3 clips
    over the data-parallel ranks."""
    out = {}
    for name, extra in (("mp3", ["trainer.model_parallel=3"]),
                        ("batch", [f"trainer.model_parallel={MP}", "trainer.batch_size=3"])):
        try:
            _config([*TINY_RUN, *extra]).build_model_config()
        except ValueError as e:
            out[name] = str(e)
    return out


def group_collectives() -> dict:
    """A batch (a nested dict) that differs by rank after
    ``same_over_model_group``, and a list of tensors after
    ``mean_over_model_group``."""
    from wavjepa_tpu_torch.parallel.mesh import (
        mean_over_model_group,
        process_group,
        same_over_model_group,
    )

    rank = process_group()[0]
    batch = {"audio": torch.full((2, 3), float(rank)),
             "refresh": {"slots": torch.arange(4) + rank}}
    grads = [torch.full((5,), float(rank)), torch.full((2, 2), 2.0 * rank)]
    mean_over_model_group(grads)
    return {"batch": same_over_model_group(batch), "grads": grads}


def run_legs(inputs: dict, mp: int) -> dict:
    return {
        "step_on": leg_step_on(inputs, mp),
        "seeded": leg_seeded(TINY_RUN, mp, STEPS),
        "nat": leg_seeded(NAT_RUN, mp, 1),
        "denoise": leg_denoise(mp),
    }


def alone(out_dir: str) -> None:
    """The legs at model_parallel 1 in a process of its own, in no group."""
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    torch.save(run_legs(inputs, 1), out_dir / "alone.pt")


def worker(port: int, rank: int, world: int, out_dir: str) -> None:
    from wavjepa_tpu_torch.parallel.mesh import (
        data_group,
        init_layout,
        initialize_multihost,
        model_group,
    )

    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", world, rank, device="cpu")
    init_layout(MP)
    assert data_group() == (rank // MP, world // MP) and model_group() == (rank % MP, MP)
    out_dir = Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    seen = run_legs(inputs, MP)
    seen["layout"] = {"data": data_group(), "model": model_group()}
    seen["refusals"] = refusals()
    seen["collectives"] = group_collectives()
    if world == 2:
        seen["resume"] = leg_resume(out_dir / "runs")
        seen["remat"] = leg_remat(MP)
    torch.save(seen, out_dir / f"{GROUP_OF[world]}{rank}.pt")
    torch.distributed.destroy_process_group()


GROUP_OF = {w: name for name, w in GROUPS.items()}

# ------------------------------------------------------- the test process

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_torch_train_step import EMA_END, MASK, OPT, TINY, _inputs
    from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
    from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
    from wavjepa_tpu.ops.transformer import dot_product_attention as jax_attention
    from wavjepa_tpu.ops.transformer import key_padding_bias as jax_key_padding_bias
    from wavjepa_tpu.parallel.mesh import batch_sharding, make_mesh, param_sharding_rules
    from wavjepa_tpu.parallel.mesh import shard_train_state as jax_shard_train_state
    from wavjepa_tpu.train.schedule import ema_decay_schedule as jax_ema_schedule
    from wavjepa_tpu.train.state import TrainState as JaxTrainState
    from wavjepa_tpu.train.state import ema_update as jax_ema_update
    from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
    from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
    from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
    from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params
    from wavjepa_tpu_torch.parallel import mesh


def _free_port() -> int:
    """A free port below the ephemeral range, from which
    torch.distributed.run --standalone takes its own."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get(
        "PYTHONPATH", "")]), "OMP_NUM_THREADS": "1"}


def _start(cmds: dict, root: Path) -> dict:
    procs = {}
    for name, cmd in cmds.items():
        with open(root / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=log,
                                           stderr=subprocess.STDOUT)
    return procs


def _wait(procs: dict, root: Path, timeout: float) -> dict:
    """Each process's output; a process that fails ends the rest, so that a
    rank left waiting in a collective does not hang, and raises naming it."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs.values()):
        if any(p.poll() not in (None, 0) for p in procs.values()) or time.monotonic() > deadline:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    out = {name: (root / f"{name}.log").read_text() for name in procs}
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} exited {p.returncode}:\n{out[name][-4000:]}"
    return out


@pytest.fixture(scope="module")
def jax_params():
    jc = JaxConfig(**TINY)  # tests/test_torch_train_step.py's weights, initialised jitted
    params = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 1, jc.target_length)))
    return jc, jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """Both groups' ranks, the one-process run and the train CLI under
    torch.distributed.run at model_parallel 2, started together; meanwhile
    the JAX package's steps over (data 1, model 2) and (data 2, model 2)."""
    root = tmp_path_factory.mktemp("tensor_parallel")
    jc, params = jax_params
    batches = [_inputs(30 + i, 8, jc) for i in range(STEPS)]
    torch.save({"state_dict": state_dict_from_jax_params(params), "batches": batches,
                "config": (TINY, OPT, MASK, EMA_END)}, root / "inputs.pt")
    cmds = {"train_cli": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc_per_node={MP}", "-m", "wavjepa_tpu_torch.train", *TINY_RUN,
                          f"trainer.model_parallel={MP}", "trainer.steps=2",
                          f"trainer.save_dir={root / 'train_cli'}", "--device", "cpu"],
            "alone": [sys.executable, __file__, "alone", str(root)]}
    for name, world in GROUPS.items():
        port = _free_port()
        cmds.update({f"{name}{r}": [sys.executable, __file__, str(port), str(r), str(world),
                                    str(root)] for r in range(world)})
    procs = _start(cmds, root)
    try:
        jax_mesh = {name: _jax_mesh_steps(params, batches, jc, world)
                    for name, world in GROUPS.items()}
    finally:
        out = _wait(procs, root, timeout=600)
    ranks = {name: [torch.load(root / f"{name}{r}.pt", weights_only=False) for r in range(w)]
             for name, w in GROUPS.items()}
    alone = torch.load(root / "alone.pt", weights_only=False)
    return {"root": root, "ranks": ranks, "alone": alone, "jax_mesh": jax_mesh, "out": out}


def _jax_mesh_steps(params, batches, jc, n: int):
    """tests/test_torch_train_step.py's JAX steps, jitted whole, with the
    train state placed by ``shard_train_state`` on ``make_mesh(n,
    model_parallel=2)`` and every crop and mask batch-sharded over its data
    axis."""
    jax_mesh = make_mesh(n, model_parallel=MP)
    model = JaxJEPA(jc)
    tx, _ = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    state = jax_shard_train_state(JaxTrainState.create(params, tx), jax_mesh)
    ema = jax_ema_schedule(anneal_end_step=EMA_END)

    @jax.jit
    def step_fn(p, teacher, opt_state, step, *xs):
        loss, grads = jax.value_and_grad(
            lambda q: jax_jepa_loss_fn(model, q, teacher, *xs))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        teacher = jax_ema_update(teacher, p["encoder"], ema(step))
        return optax.apply_updates(p, updates), teacher, opt_state, loss, optax.global_norm(grads)

    p, teacher, opt_state, out = state.params, state.teacher_encoder, state.opt_state, []
    for step, batch in enumerate(batches):
        xs = [jax.device_put(jnp.asarray(x), batch_sharding(jax_mesh, x.ndim)) for x in batch]
        p, teacher, opt_state, loss, g_norm = step_fn(p, teacher, opt_state, step, *xs)
        out.append((float(loss), float(g_norm)))
    return out


def _close(got, want, what: str, rtol: float, atol: float = 0.0):
    """``got`` within (rtol, atol) of ``want``: lists of scalars, or dicts of
    tensors leaf by leaf. A failure names ``what`` (the leg, the group, the
    rank and the quantity), the leaf and the largest differences."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), f"{what}: leaves {sorted(got)} vs {sorted(want)}"
        pairs = [(f"{what}, leaf {k}", got[k].numpy(), want[k].numpy()) for k in want]
    else:
        pairs = [(what, np.asarray(got), np.asarray(want))]
    for name, g, w in pairs:
        assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        ok = np.abs(g64 - w64) <= atol + rtol * np.abs(w64)
        if not ok.all():
            diff = np.abs(g64 - w64)
            raise AssertionError(f"{name}: {int((~ok).sum())} of {ok.size} outside rtol {rtol}, "
                                 f"atol {atol}; max abs diff {diff.max():.6g}")


def _ranks(runs):
    for name, seen in runs["ranks"].items():
        for rank, s in enumerate(seen):
            yield name, rank, s


def test_ranks_sit_where_the_jax_mesh_places_their_devices(runs):
    for name, world in GROUPS.items():
        devices = np.arange(world).reshape(world // MP, MP)  # make_mesh's reshape
        for rank, seen in enumerate(runs["ranks"][name]):
            (d,), (m,) = np.nonzero(devices == rank)
            assert seen["layout"] == {"data": (d, world // MP), "model": (m, MP)}, (name, rank)


@pytest.mark.parametrize("group", list(GROUPS))
def test_ranks_take_the_jax_tensor_parallel_step(runs, group):
    ref = runs["jax_mesh"][group]
    for rank, seen in enumerate(runs["ranks"][group]):
        got, what = seen["step_on"], f"leg step_on, {group}, rank {rank}"
        _close(got["loss"], [r[0] for r in ref], f"{what}, loss vs the JAX mesh", rtol=1e-5)
        _close(got["grad_norm"], [r[1] for r in ref], f"{what}, gradient norm vs the JAX mesh",
               rtol=1e-4)


@pytest.mark.parametrize("leg", ["step_on", "seeded", "nat", "denoise"])
def test_ranks_take_the_one_process_step(runs, leg):
    alone = runs["alone"][leg]
    assert np.isfinite(alone["loss"]).all(), f"leg {leg}, one process: {alone['loss']}"
    for group, rank, seen in _ranks(runs):
        what = f"leg {leg}, {group}, rank {rank}"
        got = seen[leg]
        _close(got["loss"], alone["loss"], f"{what}, loss", rtol=1e-5)
        _close(got["grad_norm"], alone["grad_norm"], f"{what}, gradient norm", rtol=1e-4)
        _close(got["grads"], alone["grads"], f"{what}, step-1 gradients", rtol=1e-5, atol=1e-6)
        _close(got["weights"], alone["weights"], f"{what}, weights", rtol=1e-4, atol=2e-6)


def test_every_rank_holds_the_same_whole_weights_bit_for_bit(runs):
    for group, rank, seen in _ranks(runs):
        first = runs["ranks"][group][0]
        for leg in ("step_on", "seeded", "nat", "denoise"):
            _close(seen[leg]["weights"], first[leg]["weights"],
                   f"leg {leg}, {group}, rank {rank} vs rank 0, weights", rtol=0)


def test_replicated_leaves_are_bit_equal_across_a_tensor_parallel_group(runs):
    for group, rank, seen in _ranks(runs):
        local, first = seen["step_on"]["local"], runs["ranks"][group][rank - rank % MP]
        split = [k for k in local if mesh.tp_rule(k) is not None]
        assert split and len(split) < len(local)
        rep = {k: v for k, v in local.items() if mesh.tp_rule(k) is None}
        _close(rep, {k: first["step_on"]["local"][k] for k in rep},
               f"leg step_on, {group}, rank {rank}, replicated leaves", rtol=0)
        # and its split leaves are its own slice of the whole
        for k in split:
            want = mesh.shard_tensor(k, seen["step_on"]["weights"][k], rank % MP, MP)
            assert torch.equal(local[k], want), f"{group}, rank {rank}, shard {k}"


def test_a_group_takes_its_first_ranks_batch_and_averages_replicated_gradients(runs):
    for group, rank, seen in _ranks(runs):
        first = rank - rank % MP  # the group's ranks are first .. first + MP - 1
        got = seen["collectives"]
        assert torch.equal(got["batch"]["audio"], torch.full((2, 3), float(first))), (group, rank)
        assert torch.equal(got["batch"]["refresh"]["slots"], torch.arange(4) + first)
        mean = first + (MP - 1) / 2
        assert torch.equal(got["grads"][0], torch.full((5,), mean)), (group, rank)
        assert torch.equal(got["grads"][1], torch.full((2, 2), 2.0 * mean)), (group, rank)


def test_a_resume_at_model_parallel_two_repeats_the_uninterrupted_run(runs):
    for rank, seen in enumerate(runs["ranks"]["pair"]):
        _close(seen["resume"]["resumed"], seen["resume"]["whole"],
               f"leg resume, pair, rank {rank}, resumed vs uninterrupted weights", rtol=0)


def test_recomputation_leaves_the_tensor_parallel_step_bit_equal(runs):
    """The pair with every stack replayed (each replayed sub-block's
    forward all-reduce issued again in the backward) against the same
    layout without recomputation: the step-1 loss, gradient norm and every
    gradient bit for bit."""
    for rank, seen in enumerate(runs["ranks"]["pair"]):
        full, none = seen["remat"]["full"], seen["remat"]["none"]
        assert full["replayed"] == [True] * 3 and none["replayed"] == [False] * 3
        what = f"leg remat, pair, rank {rank}"
        _close(full["loss"], none["loss"], f"{what}, losses", rtol=0)
        _close(full["grad_norm"], none["grad_norm"], f"{what}, gradient norms", rtol=0)
        _close(full["grads"], none["grads"], f"{what}, step-1 gradients", rtol=0)


def test_a_model_parallel_checkpoint_resumes_at_one_and_serves(runs, tmp_path):
    import shutil

    from wavjepa_tpu_torch.api.runtime import load_model
    from wavjepa_tpu_torch.train.checkpoint import CheckpointManager
    from wavjepa_tpu_torch.train.loop import train_jepa

    src = runs["root"] / "runs" / "whole"
    shutil.copytree(src, tmp_path / "run")
    run = next((tmp_path / "run").rglob("model_config.json")).parent
    blob = torch.load(run / "ckpt" / "step_00000004.ckpt", weights_only=False)
    _close({k: blob["state_dict"][k] for k in runs["ranks"]["pair"][0]["resume"]["whole"]},
           runs["ranks"]["pair"][0]["resume"]["whole"], "the file vs rank 0's weights", rtol=0)
    cfg = _config([*TINY_RUN, f"trainer.save_dir={tmp_path / 'run'}", "trainer.ckpt_every=1"])
    state = train_jepa(cfg, max_steps=5, device="cpu")  # model_parallel 1
    assert state.step == 5 and CheckpointManager(run / "ckpt").steps() == [1, 2, 3, 4, 5]
    rt = load_model(str(run / "ckpt" / "step_00000004.ckpt"), device="cpu")
    emb = rt.get_scene_embeddings(torch.randn(2, 1600))
    assert emb.shape == (2, rt.embedding_size) and torch.isfinite(emb).all()


def test_the_train_cli_takes_two_steps_at_model_parallel_two(runs):
    out, save_dir = runs["out"]["train_cli"], runs["root"] / "train_cli"
    files = sorted(str(p.relative_to(save_dir)) for p in save_dir.rglob("*"))
    where = f"train_cli: files {files}; log\n{out[-4000:]}"
    for step in (1, 2):
        assert out.count(f"[step {step}] loss=") == 1, where  # rank 0 logs
    ckpts = list(save_dir.rglob("step_00000002.ckpt"))
    assert len(ckpts) == 1 and len(list(save_dir.rglob("metrics.jsonl"))) == 1, where
    lines = [json.loads(x) for x in next(save_dir.rglob("metrics.jsonl")).read_text().splitlines()]
    assert [x["step"] for x in lines] == [1, 2] and all(np.isfinite(x["loss"]) for x in lines)


def test_a_model_parallel_that_does_not_divide_the_world_or_the_batch_raises(runs):
    for group, rank, seen in _ranks(runs):
        world = GROUPS[group]
        want = {"mp3": f"trainer.model_parallel=3 does not divide the {world} rank(s) of this run"}
        if world // MP > 1:
            want["batch"] = "trainer.batch_size=3 does not split over 2 data-parallel ranks"
        assert seen["refusals"] == want, (group, rank)


# ------------------------------------------------------------ no ranks


def _jax_port_names(params) -> dict:
    """JAX leaf path → the port's state-dict name, by converting a tree whose
    every leaf holds its own index."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(v), i + 1, np.float32) for i, (_, v) in enumerate(leaves)])
    sd = state_dict_from_jax_params(tagged)
    by_tag = {int(v.reshape(-1)[0]): k for k, v in sd.items() if v.numel()}
    return {jax.tree_util.keystr(path): by_tag[i + 1] for i, (path, _) in enumerate(leaves)
            if i + 1 in by_tag}


def test_tp_rule_splits_the_leaves_param_sharding_rules_splits(jax_params):
    jc, params = jax_params
    names = _jax_port_names(params)
    specs = param_sharding_rules(params, make_mesh(2, model_parallel=MP))
    seen = set()
    for path, spec in jax.tree_util.tree_flatten_with_path(specs)[0]:
        name = names.get(jax.tree_util.keystr(path))
        if name is None:  # a leaf the port keeps no state-dict entry for
            continue
        axes = tuple(spec.spec) + (None,) * (np.ndim(params_at(params, path)) - len(spec.spec))
        # a JAX kernel is (in, out), the port's weight (out, in); a bias is 1-D
        jax_dim = next((i for i, a in enumerate(axes) if a == "model"), None)
        want = None if jax_dim is None else (jax_dim if len(axes) == 1 else 1 - jax_dim)
        assert mesh.tp_rule(name) == want, (name, spec)
        seen.add(mesh.tp_rule(name))
    assert seen == {None, 0, 1}


def params_at(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_shards_join_to_the_whole_and_cut_qkv_per_head():
    rng = np.random.default_rng(3)
    d, heads, mlp = 16, 4, 64
    sd = {"encoder.layers.0.self_attn.in_proj_weight": rng.standard_normal((3 * d, d)),
          "encoder.layers.0.self_attn.in_proj_bias": rng.standard_normal(3 * d),
          "encoder.layers.0.self_attn.out_proj.weight": rng.standard_normal((d, d)),
          "encoder.layers.0.self_attn.out_proj.bias": rng.standard_normal(d),
          "encoder.layers.0.linear1.weight": rng.standard_normal((mlp, d)),
          "encoder.layers.0.linear2.weight": rng.standard_normal((d, mlp)),
          "encoder.norm.weight": rng.standard_normal(d)}
    sd = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
    shards = [mesh.shard_params(sd, (r, MP)) for r in range(MP)]
    for k, v in sd.items():
        assert torch.equal(mesh.join_shards(k, [s[k] for s in shards]), v), k
    w = sd["encoder.layers.0.self_attn.in_proj_weight"]
    hd, a = d // heads, d // MP
    for r, s in enumerate(shards):  # q | k | v rows of heads r·H/mp ..
        got = s["encoder.layers.0.self_attn.in_proj_weight"]
        want = torch.cat([w[p * d + r * a:p * d + (r + 1) * a] for p in range(3)])
        assert torch.equal(got, want) and got.shape == (3 * heads // MP * hd, d)
        assert s["encoder.layers.0.self_attn.out_proj.bias"] is sd[
            "encoder.layers.0.self_attn.out_proj.bias"]  # replicated: the leaf itself


def test_models_refuse_counts_that_model_parallel_does_not_divide():
    from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig

    with pytest.raises(ValueError, match="does not divide heads=4"):
        JEPA(JEPAConfig(size="tiny"), model_parallel=3)
    with pytest.raises(ValueError, match="does not divide mlp_dim=129"):
        JEPA(JEPAConfig(size="tiny", mlp_ratio=129 / 32), model_parallel=2)
    with pytest.raises(ValueError, match="needs a tensor-parallel group of 2"):
        JEPA(JEPAConfig(size="tiny"), model_parallel=2)  # no group of two here


@pytest.mark.parametrize("items, said", [
    (["trainer.model_parallel=5"], "does not divide heads=4"),
    (["trainer.model_parallel=3", "trainer.size=large"], "does not divide heads=16"),
])
def test_config_refuses_heads_that_model_parallel_does_not_divide(monkeypatch, items, said):
    """A configuration whose heads mp does not divide resolves in a group of
    mp ranks, and the model it builds (the JEPA, the denoiser's student)
    refuses it before any weight is made."""
    from wavjepa_tpu_torch.models.denoiser import DenoiserStudent
    from wavjepa_tpu_torch.models.jepa import JEPA
    from wavjepa_tpu_torch.train import config as tcfg

    mp = _config(items).trainer.model_parallel
    monkeypatch.setattr(tcfg, "process_group", lambda: (0, mp))  # a group of mp ranks
    cfg = _config([*TINY_RUN, *items])
    with pytest.raises(ValueError, match=said):
        JEPA(cfg.build_model_config(), mp)
    with pytest.raises(ValueError, match=said):
        DenoiserStudent(cfg.build_denoise_model_config(), mp)


def test_the_large_config_resolves_to_its_widths_in_one_pass():
    from wavjepa_tpu_torch.train.config import load_config

    cfg = load_config("configs/large.yaml")
    model_cfg = cfg.build_model_config()
    assert (model_cfg.encoder_layers, model_cfg.encoder_dim, model_cfg.encoder_heads,
            model_cfg.decoder_layers, model_cfg.decoder_dim, model_cfg.decoder_heads) == (
        24, 1024, 16, 12, 384, 12)
    assert cfg.resolved_accum_steps() == 1  # 8 clips × 8 crops
    assert (model_cfg.pack_encoder, model_cfg.pack_decoder) == (88, 128)


def _subset_case(seed, b=2, t=12, d=32, heads=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x, ipk, ipb, opk = f(b, t, d) * 0.3, f(d, 3 * d) * 0.2, f(3 * d) * 0.1, f(d, d) * 0.2
    mask = rng.random((b, t)) < 0.3
    mask[:, -1] = False  # no fully masked row: plain autodiff and the kernel's maths agree
    return x, ipk, ipb, opk, mask, f(b, t, d)


def _jax_subset(x, ipk, ipb, opk, mask, heads, rank):
    """The JAX package's plain attention on tensor-parallel rank ``rank``'s
    heads: their q, k, v columns of the in_proj kernel, the einsum core,
    their rows of the out_proj kernel, no output bias."""
    d = x.shape[-1]
    hl, hd = heads // MP, d // heads
    cols = lambda p: slice(p * d + rank * hl * hd, p * d + (rank + 1) * hl * hd)
    b, t, _ = x.shape
    q, k, v = ((x @ ipk[:, cols(p)] + ipb[cols(p)]).reshape(b, t, hl, hd).transpose(0, 2, 1, 3)
               for p in range(3))
    o = jax_attention(q, k, v, jax_key_padding_bias(mask))
    return o.transpose(0, 2, 1, 3).reshape(b, t, hl * hd) @ opk[rank * hl * hd:
                                                                (rank + 1) * hl * hd]


def _port_subset_params(ipk, ipb, opk, rank):
    full = {"self_attn.in_proj_weight": torch.tensor(ipk.T.copy()),
            "self_attn.in_proj_bias": torch.tensor(ipb),
            "self_attn.out_proj.weight": torch.tensor(opk.T.copy())}
    s = mesh.shard_params(full, (rank, MP))
    return [s[k].requires_grad_(True) for k in full]


@pytest.mark.parametrize("rank", range(MP))
def test_fused_block_at_a_subset_of_heads_matches_jax_plain_attention(rank):
    from wavjepa_tpu_torch.ops import fused_attention_block as fab

    heads = 4
    x, ipk, ipb, opk, mask, wl = _subset_case(seed=11 + rank)
    w_in, b_in, w_out = _port_subset_params(ipk, ipb, opk, rank)
    assert w_in.shape == (3 * 16, 32) and w_out.shape == (32, 16)  # A = 16 < D = 32
    tx = torch.tensor(x, requires_grad=True)
    got = fab.fused_self_attention(tx, w_in, b_in, w_out, None, torch.tensor(mask), heads // MP)
    ref = _jax_subset(*map(jnp.asarray, (x, ipk, ipb, opk)), jnp.asarray(mask), heads, rank)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    (got * torch.tensor(wl)).sum().backward()
    refs = jax.grad(lambda *a: jnp.sum(jnp.asarray(wl) * _jax_subset(
        *a, jnp.asarray(mask), heads, rank)), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, (x, ipk, ipb, opk)))
    hl, hd, d = heads // MP, 32 // heads, 32
    cols = np.concatenate([np.arange(p * d + rank * hl * hd, p * d + (rank + 1) * hl * hd)
                           for p in range(3)])
    pairs = {"dx": (tx.grad, refs[0]), "d_in_proj": (w_in.grad.T, np.asarray(refs[1])[:, cols]),
             "d_in_proj_bias": (b_in.grad, np.asarray(refs[2])[cols]),
             "d_out_proj": (w_out.grad.T, np.asarray(refs[3])[rank * hl * hd:
                                                               (rank + 1) * hl * hd])}
    for name, (g, r) in pairs.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-5, atol=5e-5, err_msg=name)


def test_the_ranks_partial_blocks_sum_to_the_whole_block():
    from wavjepa_tpu_torch.ops import fused_attention_block as fab

    heads = 4
    x, ipk, ipb, opk, mask, _ = _subset_case(seed=13)
    opb = np.random.default_rng(14).standard_normal(32).astype(np.float32)
    tx, tm = torch.tensor(x), torch.tensor(mask)
    whole = fab.fused_self_attention(tx, torch.tensor(ipk.T.copy()), torch.tensor(ipb),
                                     torch.tensor(opk.T.copy()), torch.tensor(opb), tm, heads)
    parts = [fab.fused_self_attention(tx, *(p.detach() for p in _port_subset_params(
        ipk, ipb, opk, r)), None, tm, heads // MP) for r in range(MP)]
    np.testing.assert_allclose((sum(parts) + torch.tensor(opb)).numpy(), whole.numpy(),
                               rtol=2e-5, atol=2e-5)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "alone":
        alone(sys.argv[2])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
