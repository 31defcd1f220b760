"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level module name, and the reference loads nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "wavjepa_tpu"}


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        tops = _imported_tops(path)
        assert "wavjepa_tpu_torch" not in tops and not tops & FORBIDDEN, path
        assert tops <= {"__future__", "contextlib", "math", "numpy", "torch", "wavbench"}, path


def test_the_name_check_compares_whole_top_level_names():
    from wavbench import harness

    sys.modules.setdefault("wavjepa_tpu_torch_probe", type(sys)("wavjepa_tpu_torch_probe"))
    try:
        assert "wavjepa_tpu" not in harness.forbidden_modules()
    finally:
        del sys.modules["wavjepa_tpu_torch_probe"]


def test_a_tiny_run_loads_no_forbidden_module():
    """Drive a tiny train and embed cell on the CPU in a fresh process and
    look at ``sys.modules`` afterwards, as run.py does."""
    code = ("import sys, time, torch; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from conftest import tiny_cell; from wavbench import harness; "
            "[harness.driver(tiny_cell(n)['traffic']['driver']).run(tiny_cell(n), seed=3, "
            "seconds=0.1, trace=False, device=torch.device('cpu'), t_start=time.perf_counter())"
            " for n in ('base-pretrain-1pass', 'base-embed')]; "
            "print('FOUND', harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(BENCH_DIR / "tests")],
                         capture_output=True, text=True, check=True, timeout=600).stdout
    assert "FOUND []" in out
