"""What every driver shares: a cell's files, the card, profiling, the
per-layer readers and the result line.

A cell is found by name: its entry in ``BENCHMARK.json`` names a
configuration (``wavbench/configs/<config>.json``) and a traffic mix
(``wavbench/traffic/<traffic>.json``, whose ``driver`` names
``wavbench/drivers/<driver>.py``); ``wavbench/workloads/<cell>.json`` holds
the cell's correctness limits. A per-layer metric ``<name>`` is read by
``wavbench/metrics/<name>.py``'s ``read(record)``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wavjepa_tpu")
WINDOW = "wavbench_window"  # the record_function range a traced window runs in


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout. The port
    builds its libraries under ``build/wavjepa_tpu_torch`` by itself; the
    others are set for kernels a later change may build with Triton,
    ``torch.utils.cpp_extension`` or the driver's JIT, whose defaults lie
    outside the checkout. ``USE_FLAX=0`` keeps ``transformers`` from
    loading JAX."""
    base = ROOT / "build" / "wavbench"
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(base / "cuda_cache"))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> dict:
    """The cell's entry, configuration, traffic and limits, by name."""
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    entry = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": name, "entry": entry, "bench": bench,
        "config": load_json(ROOT / config["file"]),
        "traffic": load_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        "workload": load_json(BENCH_DIR / "workloads" / f"{name}.json"),
    }


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str):
    return _module(BENCH_DIR / "drivers" / f"{name}.py", f"wavbench_driver_{name}")


def metric_reader(name: str):
    return _module(BENCH_DIR / "metrics" / f"{name}.py", f"wavbench_metric_{name}")


def cell_metrics(cell: dict, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    this cell reports: those listing it, and those listing no cells."""
    return [m for m in cell["bench"][section]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules of JAX or the JAX package, by whole top-level name."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(device):
    """Profile the block (CPU and the card) inside a ``WINDOW`` range that
    ends after a synchronize; yields a dict that holds the trace's reading
    (``count/trace.read``) once the block is done. The trace is written to
    a temporary directory under ``TMPDIR`` and deleted once read."""
    import torch

    from wavbench.count import trace as trace_reader

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="wavbench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = torch.profiler.profile(activities=activities)
        with prof:
            with torch.profiler.record_function(WINDOW):
                yield out
                sync(device)
        t0 = time.perf_counter()
        prof.export_chrome_trace(path)
        out["trace_bytes"] = os.path.getsize(path)
        out.update(trace_reader.read(path, WINDOW))
        out["read_s"] = time.perf_counter() - t0


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                checks: dict, breakdown=None) -> str:
    line = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks  # the numbers compared, each beside its limit: last
    return json.dumps(line)


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited reading beside its limit; correct when every one is
    there, finite and at most its limit."""
    checks = {k: {"value": float(readings[k]), "limit": float(v)} for k, v in limits.items()
              if k in readings}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok and len(checks) == len(limits), checks
