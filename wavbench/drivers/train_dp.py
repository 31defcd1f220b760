"""The data-parallel train driver: the port's pretraining step on every card
of the cell, one NCCL rank a card, as ``torchrun`` would run it.

``run`` is rank 0, on ``cuda:0`` in the harness's process. It builds the
kernels once, starts ranks 1 .. W−1 as processes of their own (this file
run as a script, rank r on ``cuda:r``), and joins them in a process group
over ``tcp://localhost`` (NCCL for the step, and a gloo group beside it for
the window's stop signal, which the host decides). Every rank then does
what ``drivers/train.py`` does for one card, on its rows of each global
batch of ``batch_clips`` clips (``trainer.batch_size`` is the global batch;
the port's step draws crops and masks for the whole batch and takes its
rows, ``parallel/mesh.shard_batch``): ``build_run``, the seeded weights,
the three check steps through the window's own feed and call, the window,
a traced tail on rank 0 with the program's spans recorded (``count/tail.py``:
``train.all_reduce`` holds the gradient round), and the check steps again
from set-up's state. Rank 0 times the window, counting every rank's clips,
and after the others have finished holds its own readings (the gradient
and the losses after the all-reduce are the global batch's) to the plain
reference redone over the global batch (``drivers/train.reference_readings``).
"""

from __future__ import annotations

import argparse
import datetime
import gc
import itertools
import json
import math
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from wavbench import harness, traffic  # noqa: E402
from wavbench.count import attention, flops, tail  # noqa: E402
from wavbench.drivers import train as T  # noqa: E402
from wavbench.reference import model as M  # noqa: E402
from wavbench.reference import train as R  # noqa: E402

SPANS = ("train.step", "train.prepare", "train.microbatch", "train.forward", "train.backward",
         "train.all_reduce", "train.update")
TIMEOUT = datetime.timedelta(minutes=10)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_run(cell: dict, seed: int, seconds: float, trace: bool, rank: int, world: int,
             port: int, t_start: float) -> dict:
    """One rank's share of the run; rank 0 returns the readings and times.
    On the CPU (the tests' rehearsal) the ranks are gloo ranks."""
    from wavjepa_tpu_torch.train.loop import build_run, prefetch_to_device, run_step

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    control = dist.new_group(backend="gloo", timeout=TIMEOUT)
    t, m = cell["traffic"], cell["config"]["model"]
    marks = {"joined": time.perf_counter() - t_start}
    cfg = T.port_config(cell, seed)
    dev, model_cfg, state, step_fn = build_run(cfg, dev)
    T.check_resolution(cfg, model_cfg, step_fn, cell)
    marks["build_run"] = time.perf_counter() - t_start
    w0 = M.make_weights(m, seed, dev)
    T.restore(state, w0, t["start_step"])
    share = t["batch_clips"] // world
    pool = traffic.train_pool(t, seed)
    rows = [b[rank * share:(rank + 1) * share] for b in pool]
    marks["weights_and_pool"] = time.perf_counter() - t_start
    batches = prefetch_to_device(itertools.cycle(rows), dev)
    generator = torch.Generator(device=dev)
    waited, fed = [0.0], [0]

    def step():
        t0 = time.perf_counter()
        batch = next(batches)
        waited[0] += time.perf_counter() - t0
        fed[0] += 1
        generator.manual_seed(R.step_seed(seed, state.step))
        return run_step(step_fn, state, batch, generator)[1]

    def go(decision: bool) -> bool:
        flag = torch.tensor([int(decision)])
        dist.broadcast(flag, 0, group=control)
        return bool(flag.item())

    def check_steps(w0: dict) -> dict:
        for _ in range(-fed[0] % len(rows)):  # the feed back at the pool's start
            next(batches)
        losses, first = [], {}
        for k in range(T.CHECK_STEPS):
            losses.append(float(step()["loss"]))
            if k == 0:  # AdamW's first moment after one step is (1 - b1) times the gradient
                b1 = state.optimizer.param_groups[0]["betas"][0]
                held = state.optimizer.state
                first = {n: (held[p]["exp_avg"] / (1.0 - b1)).cpu()
                         if "exp_avg" in held.get(p, {}) else torch.zeros(p.shape)
                         for n, p in state.model.named_parameters()}
        return T.program_readings(state, w0, losses, first)

    prog = check_steps(w0)
    marks["check_steps"] = time.perf_counter() - t_start
    del w0
    harness.sync(dev)
    dist.barrier(group=control)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    waited[0] = 0.0
    failed = steps = 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while go(rank != 0 or time.perf_counter() - t0 < seconds or steps == 0):
        metrics = step()
        steps += 1
        if state.step % cfg.trainer.log_every == 0:  # run_loop's cadence
            failed += not math.isfinite(float(metrics["loss"]))
    harness.sync(dev)
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    # the train metrics' record, of this rank's card: its crops' FLOPs and
    # attention bound, so that mfu.train and attention_roofline.train are
    # shares of one card's peak
    crops = share * cell["config"]["recipe"]["samples_per_audio"]
    record = {"driver": "train", "world": world, "steps": steps, "window_s": window_s,
              "data_wait_s": waited[0], "flops_per_step": flops.jepa_step_flops(m, crops),
              "peak_window_bytes": memory_peak}
    if trace:
        if rank == 0:
            with tail.profiled(dev, SPANS) as tr:
                for _ in range(t["trace_steps"]):
                    step()
            record["trace"] = tr
        else:
            for _ in range(t["trace_steps"]):
                step()
        record["traced_steps"] = t["trace_steps"]
        record["attention_bound_s"] = t["trace_steps"] * attention.train_step_seconds(m, crops)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    w0 = M.make_weights(m, seed, dev)
    T.restore(state, w0, t["start_step"])
    prog_after = check_steps(w0)
    del w0
    batches.close()
    del state, step_fn, batches
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier(group=control)
    dist.destroy_process_group()
    return {"prog": prog, "prog_after": prog_after, "record": record, "failed": failed,
            "memory_peak": memory_peak, "setup_s": setup_s, "marks": marks, "pool": pool}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    from wavjepa_tpu_torch.ops import _build

    world = cell["entry"]["chips"]
    if device.type == "cuda":
        _build.build_all()  # once, before the ranks that load the libraries start
    port = _free_port()
    here = Path(__file__).resolve()
    with tempfile.TemporaryDirectory(prefix="wavbench_dp_") as tmp:
        cell_file = Path(tmp) / "cell.json"  # the ranks run the cell rank 0 was given
        cell_file.write_text(json.dumps(cell))
        workers = [subprocess.Popen(
            [sys.executable, str(here), "--cell-file", str(cell_file), "--seed", str(seed),
             "--seconds", str(seconds), "--trace", str(int(trace)), "--rank", str(r),
             "--world", str(world), "--port", str(port)], cwd=harness.ROOT,
            stdout=sys.stderr)  # standard output carries the result line alone
            for r in range(1, world)]
        try:
            out = rank_run(cell, seed, seconds, trace, 0, world, port, t_start)
        finally:
            codes = [w.wait(timeout=TIMEOUT.total_seconds()) for w in workers]
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")
    t, dev = cell["traffic"], device
    r0 = time.perf_counter()
    ref = T.reference_readings(cell, seed, out["pool"], dev)
    out["marks"]["reference_s"] = time.perf_counter() - r0
    prog, prog_after = out["prog"], out["prog_after"]
    limits = cell["workload"]["limits"]
    correct, checks = harness.judge(
        {**T.compare(prog, ref), **{f"{k}.after": v for k, v in T.compare(prog_after,
                                                                           ref).items()}},
        {**limits, **{f"{k}.after": v for k, v in limits.items()}})
    record = out["record"]
    steps, window_s = record["steps"], record["window_s"]
    return {"correct": correct, "attempted": steps, "failed": out["failed"], "checks": checks,
            "memory_peak_bytes": int(out["memory_peak"]), "record": record,
            "end_to_end": {"train_clips_per_s": steps * t["batch_clips"] / window_s,
                           "setup_s": out["setup_s"]},
            "notes": {"marks": out["marks"], "worst_leaves": T.worst_leaves(prog, ref),
                      "losses": prog["losses"], "losses_after": prog_after["losses"],
                      "ref_losses": ref["losses"], "steps": steps, "window_s": window_s,
                      "world": out["record"]["world"],
                      "trace": {k: v for k, v in record.get("trace", {}).items()
                                if k in ("trace_bytes", "read_s", "kernels")}}}


def main() -> int:
    ap = argparse.ArgumentParser(description="one rank of the data-parallel train driver")
    for name, kind in (("--cell-file", str), ("--seed", int), ("--seconds", float),
                       ("--trace", int), ("--rank", int), ("--world", int), ("--port", int)):
        ap.add_argument(name, type=kind, required=True)
    args = ap.parse_args()
    t_start = time.perf_counter()
    harness.cache_env()
    cell = json.loads(Path(args.cell_file).read_text())
    rank_run(cell, args.seed, args.seconds, bool(args.trace), args.rank, args.world, args.port,
             t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
