"""Data parallelism of the port (``wavjepa_tpu_torch/parallel/mesh.py``) on
the CPU, over gloo.

This file runs itself as a worker (``python tests/test_torch_parallel.py
PORT RANK DIR``, as tests/multihost_worker.py does for the JAX package): one
module-scoped pair of rank processes joins a process group of two through
``initialize_multihost`` (tcp://) and runs every leg, each rank writing what
it saw to ``DIR/rank<r>.pt``; a third process (``python
tests/test_torch_parallel.py alone DIR``) runs the same legs in no group
into ``DIR/alone.pt``. Beside them both CLIs run under
``torch.distributed.run --nproc_per_node=2 --device cpu``. The tests hold
the two ranks against:

* the JAX package's ``shard_batch(make_mesh(2), x)`` (the rows each rank
  holds) and the JAX loss and gradients over a 2-device mesh, on the same
  crops and masks, at tests/test_torch_train_step.py's tolerances (loss
  rtol 1e-5, gradient norm rtol 1e-4);
* the port's one-process run at the same seed (its own process, at one
  thread like the ranks, so that it inherits nothing of this test process:
  not its thread count, nor the floating-point mode that a library built
  with -ffast-math, such as the JAX package's native data library, leaves
  behind when an earlier test loaded it): losses rtol 1e-5, per-leaf
  step-1 gradients rtol 1e-5 atol 1e-6 (MULTICHIP_r05.json's gate), at
  accum 1 and 2, through ``step_on`` and through ``build_run`` from
  synthetic clips; the Nat step from synthetic scene batches and the
  denoise step from a scene bank likewise (weights after the steps atol
  2e-6, rtol 1e-4, tests/test_torch_train_step.py's);
* each other: weights and teacher bit for bit, the all-reduce being one sum
  that every rank receives;
* an uninterrupted run: a resume at world size 2 reproduces its weights bit
  for bit, and rank 0 alone writes the run's files.

f32 throughout.
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
WORLD = 2
STEPS = 3
# tests/test_torch_train_loop.py's tiny run (31 tokens a crop), 4 clips a step
TINY_RUN = [
    "data.synthetic=true", "trainer.size=tiny", "trainer.batch_size=4",
    "data.samples_per_audio=2", "data.sr=1600", "data.process_seconds=0.201",
    "data.target_seconds=1.0", "extractor.conv_spec=[[16,10,5],[16,3,2]]",
    "trainer.average_top_k_layers=2", "trainer.precision=f32", "trainer.log_every=1",
    "optimizer.warmup_steps=1",
]
# configs/nat_binaural.yaml as overrides of the defaults, tiny, with
# tests/test_torch_nat_step.py's CLI rates
NAT_RUN = [
    "data.nat_scenes=true", "data.in_channels=2", "extractor.channel_wise=true",
    "extractor.pos_embed=binaural", "masker.channel_based_masking=true", "trainer.size=tiny",
    "trainer.batch_size=4", "data.samples_per_audio=2", "data.process_seconds=0.201",
    "data.target_seconds=0.5", "trainer.precision=f32", "optimizer.warmup_steps=1",
]
# the denoise CLI's configuration (wavjepa_tpu_torch.denoise) at that size
DENOISE_RUN = TINY_RUN
BANK_RIR, BANK_ROWS, BANK_NOISES = 200, 6, 2


def _config(items):
    from wavjepa_tpu_torch.train.config import Config, apply_overrides

    return apply_overrides(Config(), list(items))


def _weights(module) -> dict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _grads(module) -> dict:
    return {k: p.grad.detach().clone() for k, p in module.named_parameters()}


# --------------------------------------------------------------- the legs
# Each runs in a rank process (in a group of two) and in the test process
# alone (no group), and returns what the tests compare.


def leg_step_on(inputs: dict, accum: int) -> dict:
    """Three steps of ``step_on`` from tests/test_torch_train_step.py's
    carried-across weights, on given global crops and masks, of which a rank
    takes its rows."""
    from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
    from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
    from wavjepa_tpu_torch.parallel.mesh import shard_batch
    from wavjepa_tpu_torch.train.state import TrainState
    from wavjepa_tpu_torch.train.step import (
        EMAConfig,
        OptimizerConfig,
        make_jepa_train_step,
        make_optimizer,
    )

    tiny, opt, mask, ema_end = inputs["config"]
    model = JEPA(JEPAConfig(**tiny))
    model.load_state_dict(inputs["state_dict"])
    state = TrainState.create(model, make_optimizer(OptimizerConfig(**opt), model))
    step = make_jepa_train_step(OptimizerConfig(**opt), nr_samples_per_audio=2,
                                masker_cfg=TimeInverseMaskConfig(**mask),
                                ema_cfg=EMAConfig(anneal_end_step=ema_end), accum_steps=accum)
    out = {"loss": [], "grad_norm": []}
    for batch in inputs["batches"]:
        state, m = step.step_on(state, *(shard_batch(torch.from_numpy(x)) for x in batch))
        out["loss"].append(m["loss"].item())
        out["grad_norm"].append(m["grad_norm"].item())
        out.setdefault("grads", _grads(state.model))
    out["weights"], out["teacher"] = _weights(state.model), _weights(state.teacher_encoder)
    return out


def _loop_steps(state, step_fn, batches, seed, n_steps, bank=None, refresh=None) -> dict:
    """``n_steps`` of ``run_step`` as ``train/loop.run_loop`` takes them:
    each step's generator seeded from (seed, step)."""
    from wavjepa_tpu_torch.train.loop import run_step, step_seed

    generator = torch.Generator()
    out = {"loss": [], "grad_norm": []}
    student = state.model if hasattr(state, "model") else state.student
    for i in range(n_steps):
        batch = next(batches)
        if refresh is not None:
            batch = {**batch, "rir_bank_refresh": refresh(i)}
        generator.manual_seed(step_seed(seed, state.step))
        state, m = run_step(step_fn, state, batch, generator, bank)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out.setdefault("grads", _grads(student))
    out["weights"] = _weights(student)
    if hasattr(state, "teacher_encoder"):
        out["teacher"] = _weights(state.teacher_encoder)
    return out


def _tensors(batch):
    if isinstance(batch, dict):
        return {k: _tensors(v) for k, v in batch.items()}
    return torch.from_numpy(np.ascontiguousarray(batch))


def leg_seeded(items) -> dict:
    """``build_run`` (weights from rank 0) and its step from the run's own
    data (``build_data_iterator``: synthetic clips or scene batches, a
    rank's rows of each), crops and masks drawn from the (seed, step)
    generator."""
    from wavjepa_tpu_torch.train.loop import build_data_iterator, build_run

    cfg = _config(items)
    _, _, state, step_fn = build_run(cfg, device="cpu")
    batches = map(_tensors, build_data_iterator(cfg))
    return _loop_steps(state, step_fn, batches, cfg.trainer.seed, STEPS)


def _bank_batches(n_clips: int, scene_len: int):
    """Global scene batches that index a scene bank (every rank holds the
    same bank here), a rank's rows of each, and the bank's refresh after
    each step, all from seeded numpy."""
    from wavjepa_tpu_torch.parallel.mesh import shard_batch

    rng = np.random.default_rng(21)
    rirs = np.zeros((BANK_ROWS, 1, BANK_RIR), np.float32)
    rirs[:, :, 0] = 1.0
    rirs[:, :, 1:60] = 0.1 * rng.standard_normal((BANK_ROWS, 1, 59))
    bank = {"source_rir": rirs,
            "noise_rirs": 0.3 * rng.standard_normal(
                (BANK_ROWS, BANK_NOISES, 1, BANK_RIR)).astype(np.float32),
            "noise": (rng.standard_normal((BANK_ROWS, scene_len)) * 3000).astype(np.int16)}

    def batches():
        i = 0
        while True:
            r = np.random.default_rng((5, i))
            i += 1
            length = r.integers(scene_len // 2, scene_len, n_clips).astype(np.int32)
            yield _tensors(shard_batch({
                "audio": r.standard_normal((n_clips, scene_len)).astype(np.float32),
                "rir_index": r.integers(0, BANK_ROWS, n_clips).astype(np.int32),
                "noise_index": r.integers(0, BANK_ROWS, n_clips).astype(np.int32),
                "noise_start": r.integers(0, scene_len - length + 1).astype(np.int32),
                "noise_length": length,
                "snr": r.uniform(-5, 5, n_clips).astype(np.float32)}))

    def refresh(i):
        r = np.random.default_rng((6, i))
        return _tensors({"slots": {k: np.array([i % BANK_ROWS], np.int64) for k in bank},
                         "rows": {k: (r.standard_normal((1, *v.shape[1:])) *
                                      (3000 if v.dtype == np.int16 else 0.1)).astype(v.dtype)
                                  for k, v in bank.items()}})

    return _tensors(bank), batches(), refresh


def leg_denoise_bank() -> dict:
    """``build_denoise_run`` (the teacher, and so the student, rank 0's) and
    two denoise steps at accum 2 from scene batches that index a scene bank,
    refreshed after each step."""
    from wavjepa_tpu_torch.denoise import denoise_config
    from wavjepa_tpu_torch.train.denoise_loop import build_denoise_run

    cfg = denoise_config([*DENOISE_RUN, "trainer.accum_steps=2"])
    _, _, state, step_fn = build_denoise_run(cfg, device="cpu")
    bank, batches, refresh = _bank_batches(cfg.trainer.batch_size,
                                           int(32000 * cfg.data.target_seconds))
    return _loop_steps(state, step_fn, batches, cfg.trainer.seed, 2, bank, refresh)


def leg_resume(root: Path) -> dict:
    """``train_jepa`` for 4 steps, and for 2 then resumed to 4, at accum 2,
    checkpointing every step; the final weights of both."""
    from wavjepa_tpu_torch.train.loop import train_jepa

    out = {}
    for name, stops in (("whole", (4,)), ("resumed", (2, 4))):
        cfg = _config([*TINY_RUN, "trainer.accum_steps=2", "trainer.ckpt_every=1",
                       f"trainer.save_dir={root / name}"])
        for stop in stops:
            state = train_jepa(cfg, max_steps=stop, device="cpu")
        out[name] = {**_weights(state.model),
                     **{f"teacher_encoder.{k}": v for k, v in
                        _weights(state.teacher_encoder).items()}}
    return out


def rank_rows() -> dict:
    """A rank's rows of a numpy batch and of a dict of them."""
    from wavjepa_tpu_torch.parallel.mesh import shard_batch

    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    return {"array": shard_batch(x), "dict": shard_batch({"a": x, "b": x[:, 0].copy()})}


def replicated_weights() -> dict:
    """A module whose weights differ between ranks, after ``replicated``."""
    from wavjepa_tpu_torch.parallel.mesh import process_group, replicated

    rank = process_group()[0]
    module = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(module.weight, float(rank + 1))
    return _weights(replicated(module))


def refusals() -> dict:
    """What ``build_model_config`` raises over two ranks: a batch of 3 clips,
    and a rank's 4 crops in 3 microbatches."""
    out = {}
    for name, extra in (("batch", ["trainer.batch_size=3"]),
                        ("accum", ["trainer.accum_steps=3"])):
        try:
            _config([*TINY_RUN, *extra]).build_model_config()
        except ValueError as e:
            out[name] = str(e)
    return out


def run_legs(inputs: dict, root: Path) -> dict:
    return {
        "step_on": {a: leg_step_on(inputs, a) for a in (1, 2)},
        "seeded": {a: leg_seeded([*TINY_RUN, f"trainer.accum_steps={a}"]) for a in (1, 2)},
        "nat": leg_seeded([*NAT_RUN, "trainer.accum_steps=2"]),
        "denoise_bank": leg_denoise_bank(),
    }


def alone(out_dir: str) -> None:
    """The legs in a process of its own, in no group: the one-process run."""
    torch.set_num_threads(1)
    out_dir = Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    torch.save(run_legs(inputs, out_dir), out_dir / "alone.pt")


def worker(port: int, rank: int, out_dir: str) -> None:
    from wavjepa_tpu_torch.parallel.mesh import initialize_multihost, process_group

    torch.set_num_threads(1)
    dev = initialize_multihost(f"localhost:{port}", WORLD, rank, device="cpu")
    assert dev == torch.device("cpu") and process_group() == (rank, WORLD)
    out_dir = Path(out_dir)
    inputs = torch.load(out_dir / "inputs.pt", weights_only=False)
    seen = run_legs(inputs, out_dir)
    seen["resume"] = leg_resume(out_dir / "runs")
    seen["rows"], seen["replicated"] = rank_rows(), replicated_weights()
    seen["refusals"] = refusals()
    torch.save(seen, out_dir / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


# ------------------------------------------------------- the test process

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp
    import optax

    from tests.test_torch_train_step import EMA_END, MASK, OPT, TINY, _inputs
    from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
    from wavjepa_tpu.models.jepa import JEPAConfig as JaxConfig
    from wavjepa_tpu.parallel.mesh import make_mesh, shard_batch as jax_shard_batch
    from wavjepa_tpu.train.schedule import ema_decay_schedule as jax_ema_schedule
    from wavjepa_tpu.train.state import TrainState as JaxTrainState
    from wavjepa_tpu.train.state import ema_update as jax_ema_update
    from wavjepa_tpu.train.step import OptimizerConfig as JaxOptimizerConfig
    from wavjepa_tpu.train.step import jepa_loss_fn as jax_jepa_loss_fn
    from wavjepa_tpu.train.step import make_optimizer as jax_make_optimizer
    from wavjepa_tpu_torch.api.convert import state_dict_from_jax_params


def _free_port() -> int:
    """A free port below the ephemeral range, from which torch.distributed.run
    --standalone takes its own (port 0), so that the two cannot collide."""
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


def _torchrun(module: str, save_dir: Path, items: list) -> list:
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc_per_node={WORLD}", "-m", module, *items, "trainer.steps=2",
            f"trainer.save_dir={save_dir}", "--device", "cpu"]


def _start(cmds: dict, root: Path) -> dict:
    procs = {}
    for name, cmd in cmds.items():
        with open(root / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=log,
                                           stderr=subprocess.STDOUT)
    return procs


def _wait(procs: dict, root: Path, timeout: float) -> dict:
    """Each process's output; a process that fails ends the rest, so that a
    rank left waiting in a collective does not hang, and raises."""
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs.values()):
        failed = any(p.poll() not in (None, 0) for p in procs.values())
        if failed or time.monotonic() > deadline:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
        time.sleep(0.1)
    out = {name: (root / f"{name}.log").read_text() for name in procs}
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} exited {p.returncode}:\n{_tail(out[name])}"
    return out


def _tail(log: str, n: int = 4000) -> str:
    return log[-n:]


@pytest.fixture(scope="module")
def jax_params():
    jc = JaxConfig(**TINY)  # tests/test_torch_train_step.py's weights, initialised jitted
    params = jax.jit(JaxJEPA(jc).init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 1, jc.target_length)))
    return jc, jax.tree.map(np.asarray, params["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_params):
    """Both CLIs under torch.distributed.run and the two rank processes,
    started together; meanwhile the same legs in this process alone, and
    the JAX package's steps over a 2-device mesh."""
    root = tmp_path_factory.mktemp("parallel")
    procs = _start({
        "train_cli": _torchrun("wavjepa_tpu_torch.train", root / "train_cli", TINY_RUN),
        "denoise_cli": _torchrun("wavjepa_tpu_torch.denoise", root / "denoise_cli", DENOISE_RUN),
    }, root)
    try:
        jc, params = jax_params
        batches = [_inputs(20 + i, 8, jc) for i in range(STEPS)]
        inputs = {"state_dict": state_dict_from_jax_params(params), "batches": batches,
                  "config": (TINY, OPT, MASK, EMA_END)}
        torch.save(inputs, root / "inputs.pt")
        port = _free_port()
        procs.update(_start({f"rank{r}": [sys.executable, __file__, str(port), str(r), str(root)]
                             for r in range(WORLD)}, root))
        procs.update(_start({"alone": [sys.executable, __file__, "alone", str(root)]}, root))
        jax_mesh = _jax_mesh_steps(params, batches, jc)
    finally:
        out = _wait(procs, root, timeout=300)
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    alone = torch.load(root / "alone.pt", weights_only=False)
    return {"root": root, "ranks": ranks, "alone": alone, "jax_mesh": jax_mesh, "out": out}


def _jax_mesh_steps(params, batches, jc):
    """tests/test_torch_train_step.py's JAX steps, jitted whole, with every
    crop and mask placed batch-sharded over a 2-device mesh."""
    mesh = make_mesh(WORLD)
    model = JaxJEPA(jc)
    tx, _ = jax_make_optimizer(JaxOptimizerConfig(**OPT))
    state = JaxTrainState.create(params, tx)
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
        p, teacher, opt_state, loss, g_norm = step_fn(
            p, teacher, opt_state, step, *(jax_shard_batch(mesh, jnp.asarray(x)) for x in batch))
        out.append((float(loss), float(g_norm)))
    return out


def _diffs(got: np.ndarray, want: np.ndarray) -> str:
    """The largest absolute and relative difference, for a failure message."""
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    rel = diff / np.maximum(np.abs(want.astype(np.float64)), np.finfo(np.float64).tiny)
    return f"max abs diff {diff.max():.6g}, max rel diff {rel.max():.6g}"


def _close(got, want, what: str, rtol: float, atol: float = 0.0):
    """``got`` within (rtol, atol) of ``want``: two lists of scalars, or two
    dicts of tensors leaf by leaf. A failure names ``what`` (the leg, the
    accumulation, the rank and the quantity), the leaf and the largest
    differences."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), f"{what}: leaves {sorted(got)} vs {sorted(want)}"
        pairs = [(f"{what}, leaf {k}", got[k].numpy(), want[k].numpy()) for k in want]
    else:
        pairs = [(what, np.asarray(got), np.asarray(want))]
    for name, g, w in pairs:
        assert g.shape == w.shape, f"{name}: shape {g.shape} vs {w.shape}"
        ok = np.abs(g.astype(np.float64) - w.astype(np.float64)) <= atol + rtol * np.abs(w)
        assert ok.all(), (f"{name}: {int((~ok).sum())} of {ok.size} outside rtol {rtol}, "
                          f"atol {atol}; {_diffs(g, w)}")


def test_a_rank_holds_the_rows_the_jax_mesh_places_on_its_device(runs):
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    placed = jax_shard_batch(make_mesh(WORLD), x)
    shards = sorted(placed.addressable_shards, key=lambda s: s.index[0].start)
    for rank, seen in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(seen["rows"]["array"], np.asarray(shards[rank].data))
        np.testing.assert_array_equal(seen["rows"]["dict"]["a"], np.asarray(shards[rank].data))
        np.testing.assert_array_equal(seen["rows"]["dict"]["b"], x[4 * rank:4 * rank + 4, 0])


def test_a_batch_or_accumulation_that_does_not_split_over_the_ranks_raises(runs):
    assert refusals() == {}  # one process takes both
    for seen in runs["ranks"]:
        assert seen["refusals"] == {
            "batch": "trainer.batch_size=3 does not split over 2 data-parallel ranks",
            "accum": "a rank's 4 crops do not split into 3 microbatches (trainer.accum_steps)"}


def test_replicated_weights_are_rank_zeros(runs):
    for seen in runs["ranks"]:
        assert torch.equal(seen["replicated"]["weight"], torch.ones(2, 3))


@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_take_the_jax_mesh_step(runs, accum):
    ref = runs["jax_mesh"]
    for rank, seen in enumerate(runs["ranks"]):
        got, what = seen["step_on"][accum], f"leg step_on, accum {accum}, rank {rank}"
        _close(got["loss"], [r[0] for r in ref], f"{what}, loss vs the JAX mesh", rtol=1e-5)
        _close(got["grad_norm"], [r[1] for r in ref], f"{what}, gradient norm vs the JAX mesh",
               rtol=1e-4)


def _against_alone(got: dict, alone: dict, what: str, parts: tuple) -> None:
    """A rank's leg against the one-process run's, at this file's limits."""
    _close(got["loss"], alone["loss"], f"{what}, loss", rtol=1e-5)
    _close(got["grad_norm"], alone["grad_norm"], f"{what}, gradient norm", rtol=1e-4)
    _close(got["grads"], alone["grads"], f"{what}, step-1 gradients", rtol=1e-5, atol=1e-6)
    for part in parts:
        _close(got[part], alone[part], f"{what}, {part}", rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("leg", ["step_on", "seeded"])
@pytest.mark.parametrize("accum", [1, 2])
def test_two_ranks_take_the_one_process_step(runs, leg, accum):
    for rank, seen in enumerate(runs["ranks"]):
        _against_alone(seen[leg][accum], runs["alone"][leg][accum],
                       f"leg {leg}, accum {accum}, rank {rank}", ("weights", "teacher"))


@pytest.mark.parametrize("leg", ["nat", "denoise_bank"])
def test_nat_and_denoise_with_a_scene_bank_take_the_one_process_step(runs, leg):
    alone = runs["alone"][leg]
    assert np.isfinite(alone["loss"]).all(), f"leg {leg}, accum 2, one process: {alone['loss']}"
    for rank, seen in enumerate(runs["ranks"]):
        _against_alone(seen[leg], alone, f"leg {leg}, accum 2, rank {rank}", ("weights",))


def test_both_ranks_hold_the_same_weights_bit_for_bit(runs):
    r0, r1 = runs["ranks"]
    for leg, key in (("step_on", 1), ("step_on", 2), ("seeded", 1), ("seeded", 2)):
        for part in ("weights", "teacher"):
            _close(r1[leg][key][part], r0[leg][key][part],
                   f"leg {leg}, accum {key}, rank 1 vs rank 0, {part}", rtol=0)
    for leg in ("nat", "denoise_bank"):
        _close(r1[leg]["weights"], r0[leg]["weights"],
               f"leg {leg}, accum 2, rank 1 vs rank 0, weights", rtol=0)


def test_a_resume_at_two_ranks_repeats_the_uninterrupted_run(runs):
    for rank, seen in enumerate(runs["ranks"]):
        _close(seen["resume"]["resumed"], seen["resume"]["whole"],
               f"leg resume, accum 2, rank {rank}, resumed vs uninterrupted weights", rtol=0)


def test_rank_zero_alone_writes_the_run(runs):
    from wavjepa_tpu_torch.train.checkpoint import CheckpointManager

    logs = "\n".join(f"{r}: {_tail(runs['out'][r], 1500)}" for r in ("rank0", "rank1"))
    for name, launches in (("whole", 1), ("resumed", 2)):
        files = sorted(str(p.relative_to(runs["root"])) for p in
                       (runs["root"] / "runs" / name).rglob("*"))
        where = f"leg resume, accum 2, the {name} run; files {files}; logs\n{logs}"
        configs = list((runs["root"] / "runs" / name).rglob("model_config.json"))
        assert len(configs) == 1, where
        run = configs[0].parent
        lines = [json.loads(x) for x in (run / "logs" / "metrics.jsonl").read_text().splitlines()]
        # one line a step, not one a rank
        assert [x["step"] for x in lines] == [1, 2, 3, 4], f"metrics {lines}; {where}"
        assert lines[-1]["clips_per_sec_per_card"] == pytest.approx(
            lines[-1]["clips_per_sec"] / WORLD), f"metrics {lines[-1]}; {where}"
        assert CheckpointManager(run / "ckpt").steps() == [1, 2, 3, 4], where
        assert not list(run.rglob("*.tmp")), where
        events = list((run / "logs").glob("events.out.tfevents.*"))
        assert len(events) <= launches, where  # rank 0's writer, once a launch


@pytest.mark.parametrize("cli, prefix", [("train_cli", "Data="), ("denoise_cli", "Denoise-")])
def test_both_clis_take_two_steps_under_torchrun(runs, cli, prefix):
    out = runs["out"][cli]
    save_dir = runs["root"] / cli
    files = sorted(str(p.relative_to(save_dir)) for p in save_dir.rglob("*"))
    where = f"{cli}: files {files}; log\n{_tail(out)}"
    for step in (1, 2):
        assert out.count(f"[step {step}] loss=") == 1, where  # rank 0 logs
    ckpts = list(save_dir.rglob("step_00000002.ckpt"))
    assert len(ckpts) == 1 and ckpts[0].relative_to(save_dir).parts[0].startswith(prefix), where
    assert len(list(save_dir.rglob("metrics.jsonl"))) == 1, where


def test_the_final_save_is_decided_from_what_every_rank_knows(tmp_path, monkeypatch):
    """The end of a run saves the last step unless it was saved already:
    decided from the steps every rank took, not from the checkpoint
    directory, where rank 0 may have written the final file before a slower
    rank looks (that rank then skipped the save's gather and barrier, and
    the run's other ranks failed in theirs). Here the file is there, as
    such a rank would find it, and the save must still be made."""
    from wavjepa_tpu_torch.train import loop

    cfg = _config([*TINY_RUN, f"trainer.save_dir={tmp_path}"])  # no save before the end
    final = tmp_path / cfg.run_identity() / "ckpt" / "step_00000002.ckpt"
    real_step = loop.run_step

    def run_step(step_fn, state, *args):
        state, metrics = real_step(step_fn, state, *args)
        if state.step == 2:
            final.write_bytes(b"")  # rank 0's file, as a late rank finds the directory
        return state, metrics

    monkeypatch.setattr(loop, "run_step", run_step)
    state = loop.train_jepa(cfg, max_steps=2, device="cpu")
    blob = torch.load(final, weights_only=False)
    assert blob["step"] == state.step == 2
    assert all(torch.equal(blob["state_dict"][k], v) for k, v in state.weights().items())


def test_without_a_group_nothing_is_joined_and_two_devices_raise(tmp_path):
    from wavjepa_tpu_torch.data.pipeline import rank_batch_size
    from wavjepa_tpu_torch.parallel.mesh import initialize_multihost
    from wavjepa_tpu_torch.train.loop import train_jepa

    assert "WORLD_SIZE" not in os.environ
    assert initialize_multihost(device="cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    cfg = _config([*TINY_RUN, "trainer.num_devices=2", f"trainer.save_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        train_jepa(cfg, max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="does not split over 3"):
        rank_batch_size(4, 3)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    if sys.argv[1] == "alone":
        alone(sys.argv[2])
    else:
        worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
