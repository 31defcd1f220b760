"""The train driver: the port's pretraining step, driven as its loop drives it.

Set-up builds the run with ``train.loop.build_run`` from the configuration
file's port settings, gives the student and the teacher the benchmark's
seeded weights, puts the run at the traffic's ``start_step`` (a run
resumed part-way through warm-up, where the learning rate and the EMA
decay both move the weights), and takes the first three steps through the
window's own feed (``prefetch_to_device`` over the traffic's pool) and
call (``run_step``, each step's generator seeded by ``step_seed``). Those
steps warm every shape up and are what the reference checks: each step's
loss, the first gradient as AdamW holds it, and the change of every
weight after three. The window then runs steps until ``seconds`` have
passed, reading the loss every ``trainer.log_every`` steps, and ends on a
synchronize. A traced run profiles ``trace_steps`` more steps after it.
Then the state is put back where set-up began, in place, and the check
steps run again through the same feed and call, so that the path as it
stands after the window is held to the same reference and limits (the
readings named ``<number>.after``).
"""

from __future__ import annotations

import copy
import gc
import itertools
import math
import time

import torch

from wavbench import harness, traffic
from wavbench.count import attention, flops
from wavbench.reference import model as M
from wavbench.reference import train as R

CHECK_STEPS = 3
MODEL_KEYS = ("encoder_layers", "encoder_dim", "encoder_heads", "decoder_layers", "decoder_dim",
              "decoder_heads", "mlp_ratio", "layer_norm_eps", "in_channels", "extractor",
              "pos_embed", "sample_rate", "process_seconds", "average_top_k_layers",
              "pack_encoder", "pack_decoder")


def run_settings(cell: dict) -> dict:
    """What the reference reads: the recipe of the configuration file and
    the traffic's sizes."""
    t = cell["traffic"]
    return {**cell["config"]["recipe"], "reference_block": t["reference_block"],
            "scene_rate": t.get("scene_rate"), "start_step": t["start_step"]}


def port_config(cell: dict, seed: int):
    from wavjepa_tpu_torch.train.config import apply_overrides, load_config

    cfg = load_config(data=copy.deepcopy(cell["config"]["port"]))
    return apply_overrides(cfg, [*cell["config"].get("overrides", []),
                                 *cell["traffic"].get("port_overrides", []),
                                 f"trainer.seed={seed}"])


def check_resolution(cfg, model_cfg, step_fn, cell: dict) -> None:
    """Raise unless the port resolved the model and the recipe that the
    configuration file states, which the reference computes."""
    m, run, t = cell["config"]["model"], run_settings(cell), cell["traffic"]
    found = {k: getattr(model_cfg, k) for k in MODEL_KEYS}
    found["conv_spec"] = [list(x) for x in model_cfg.conv_spec]
    found["dtype"] = str(model_cfg.dtype).removeprefix("torch.")
    mk = step_fn.masker_cfg
    found_run = {"samples_per_audio": step_fn.n_crops, "batch_clips": cfg.trainer.batch_size,
                 "masker": {k: getattr(mk, k) for k in run["masker"]},
                 "optimizer": {k: getattr(cfg.optimizer, k) for k in run["optimizer"]},
                 "ema": {k: getattr(cfg.ema, k) for k in run["ema"]}}
    want = {**{k: m[k] for k in found}, "samples_per_audio": run["samples_per_audio"],
            "batch_clips": t["batch_clips"], "masker": run["masker"],
            "optimizer": run["optimizer"], "ema": run["ema"]}
    have = {**found, **found_run}
    wrong = {k: (have[k], want[k]) for k in want if have[k] != want[k]}
    if wrong:
        raise ValueError(f"the port resolved another configuration than the file states: {wrong}")


def program_readings(state, w0: dict, losses: list, first: dict) -> dict:
    """What the reference checks, from the program's state after the check
    steps: the losses, the gradient AdamW took at step 1 (``first``, on the
    host) and its norms, and each student and teacher leaf's change."""
    with torch.no_grad():
        change = {n: float((p.detach() - w0[n]).double().norm())
                  for n, p in state.model.named_parameters()}
        teacher = {f"encoder.{n}": float((p - w0[f"encoder.{n}"]).double().norm())
                   for n, p in state.teacher_encoder.named_parameters()}
    return {"losses": losses, "grads": R.norms(first), "change": change, "teacher": teacher,
            "grad_tensors": first}


def reference_readings(cell: dict, seed: int, pool: list, device, precision: str = "exact",
                       rows: slice = slice(None)) -> dict:
    """The reference's readings over the check steps, from the same seed's
    weights and batches."""
    m, run = cell["config"]["model"], run_settings(cell)
    w0 = M.make_weights(m, seed, device)
    st = R.fresh_state(w0)
    losses, grads = [], None
    for k in range(CHECK_STEPS):
        audio = R.to_audio(pool[k], m, run, device)
        out = R.reference_step(st, audio, run["start_step"] + k, seed, m, run, precision, rows)
        losses.append(out["loss"])
        if grads is None:
            first, grads = out["grads"], R.norms(out["grads"])
    with torch.no_grad():
        change = R.norms({k: st["P"][k].detach() - w0[k] for k in w0})
        teacher = R.norms({k: st["T"][k] - w0[k] for k in st["T"]})
    return {"losses": losses, "grads": grads, "change": change, "teacher": teacher,
            "grad_tensors": first}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap and, by the
    worst counted leaf, the gaps of the first gradient's norm, of the
    student's change and of the teacher's change, and the first gradient's
    distance from the reference's (``reference/train.leaf_distances``) at
    the worst leaf and at the median one."""
    counted = R.counted_leaves(ref["grads"])
    dist = R.leaf_distances(prog["grad_tensors"], ref["grad_tensors"], counted)
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    teacher_counted = [k for k in ref["teacher"] if k in counted]
    return {"loss_gap": loss_gap,
            "grad_gap": R.leaf_gap(prog["grads"], ref["grads"], counted)[0],
            "change_gap": R.leaf_gap(prog["change"], ref["change"], counted)[0],
            "ema_gap": R.leaf_gap(prog["teacher"], ref["teacher"], teacher_counted)[0],
            "grad_diff": max(dist.values()),
            "grad_diff_median": sorted(dist.values())[len(dist) // 2]}


def worst_leaves(prog: dict, ref: dict, top: int = 6) -> list:
    """The leaves whose first gradient lies farthest from the reference's."""
    dist = R.leaf_distances(prog["grad_tensors"], ref["grad_tensors"],
                            R.counted_leaves(ref["grads"]))
    return sorted(dist.items(), key=lambda kv: -kv[1])[:top]


def restore(state, w0: dict, start_step: int) -> None:
    """Put the run's state back where set-up began, in place: the seeded
    weights in the student and the teacher, AdamW's moments and step
    counts at zero (as a fresh optimizer holds them after its first step's
    initialisation), the step counter at ``start_step``."""
    state.model.load_state_dict(w0, strict=True)
    state.teacher_encoder.load_state_dict(
        {k[len("encoder."):]: v for k, v in w0.items() if k.startswith("encoder.")}, strict=True)
    with torch.no_grad():
        for held in state.optimizer.state.values():
            for key, value in held.items():
                if torch.is_tensor(value):
                    value.zero_()
                else:
                    held[key] = type(value)(0)
    state.step = start_step


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from wavjepa_tpu_torch.train.loop import build_run, prefetch_to_device, run_step

    t, m = cell["traffic"], cell["config"]["model"]
    crops = t["batch_clips"] * cell["config"]["recipe"]["samples_per_audio"]
    marks = {"imported": time.perf_counter() - t_start}
    cfg = port_config(cell, seed)
    dev, model_cfg, state, step_fn = build_run(cfg, device)
    check_resolution(cfg, model_cfg, step_fn, cell)
    marks["build_run"] = time.perf_counter() - t_start
    w0 = M.make_weights(m, seed, dev)
    restore(state, w0, t["start_step"])
    pool = traffic.train_pool(t, seed)
    marks["weights_and_pool"] = time.perf_counter() - t_start
    batches = prefetch_to_device(itertools.cycle(pool), dev)
    generator = torch.Generator(device=dev)
    waited, fed, step_ends = [0.0], [0], []

    def step():
        t0 = time.perf_counter()
        batch = next(batches)
        waited[0] += time.perf_counter() - t0
        fed[0] += 1
        generator.manual_seed(R.step_seed(seed, state.step))
        return run_step(step_fn, state, batch, generator)[1]

    def check_steps(w0: dict) -> dict:
        """The check steps from the state as set-up leaves it, through the
        window's own feed and call, on the pool's first batches."""
        for _ in range(-fed[0] % len(pool)):  # the feed back at the pool's start
            next(batches)
        losses, first = [], {}
        for k in range(CHECK_STEPS):
            losses.append(float(step()["loss"]))
            if k == 0:  # AdamW's first moment after one step is (1 - b1) times the gradient
                b1 = state.optimizer.param_groups[0]["betas"][0]
                held = state.optimizer.state
                first = {n: (held[p]["exp_avg"] / (1.0 - b1)).cpu()
                         if "exp_avg" in held.get(p, {}) else torch.zeros(p.shape)
                         for n, p in state.model.named_parameters()}
        return program_readings(state, w0, losses, first)

    prog = check_steps(w0)
    marks["check_steps"] = time.perf_counter() - t_start
    del w0
    harness.sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    waited[0] = 0.0
    failed = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps = 0
    while time.perf_counter() - t0 < seconds or steps == 0:
        metrics = step()
        steps += 1
        step_ends.append(time.perf_counter() - t0)
        if state.step % cfg.trainer.log_every == 0:  # run_loop's cadence
            failed += not math.isfinite(float(metrics["loss"]))
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    record = {"driver": "train", "steps": steps, "window_s": window_s,
              "data_wait_s": waited[0], "flops_per_step": flops.jepa_step_flops(m, crops),
              "peak_window_bytes": peak_window}
    if trace:
        with harness.profiled(dev) as tr:
            for _ in range(t["trace_steps"]):
                step()
        record["trace"] = tr
        record["traced_steps"] = t["trace_steps"]
        record["attention_bound_s"] = t["trace_steps"] * attention.train_step_seconds(m, crops)
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    # the window's path once more, as it stands after the window: the check
    # steps again from set-up's state, held to the same reference
    w0 = M.make_weights(m, seed, dev)
    restore(state, w0, t["start_step"])
    prog_after = check_steps(w0)
    del w0
    batches.close()
    del state, step_fn, batches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = reference_readings(cell, seed, pool, dev)
    marks["reference_s"] = time.perf_counter() - r0
    limits = cell["workload"]["limits"]
    correct, checks = harness.judge(
        {**compare(prog, ref), **{f"{k}.after": v for k, v in compare(prog_after, ref).items()}},
        {**limits, **{f"{k}.after": v for k, v in limits.items()}})
    clips = steps * t["batch_clips"]
    return {"correct": correct, "attempted": steps, "failed": failed, "checks": checks,
            "memory_peak_bytes": int(memory_peak), "record": record,
            "end_to_end": {"train_clips_per_s": clips / window_s, "setup_s": setup_s},
            "notes": {"marks": marks, "worst_leaves": worst_leaves(prog, ref),
                      "leaves_left_out": sorted(set(ref["grads"]) - set(R.counted_leaves(
                          ref["grads"]))),
                      "losses": prog["losses"], "losses_after": prog_after["losses"],
                      "ref_losses": ref["losses"], "steps": steps, "window_s": window_s,
                      "step_ends": step_ends,
                      "trace": {k: v for k, v in record.get("trace", {}).items()
                                if k in ("trace_bytes", "read_s", "kernels")}}}
