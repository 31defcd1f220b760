"""BENCHMARK.json against the benchmark's contract, and the harness finding
cells, configurations and metrics by name alone."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys

from conftest import BENCH_DIR, ROOT, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
BENCH = load_json(ROOT / "BENCHMARK.json")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["wavbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert len(json.dumps(BENCH)) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys():
    metric_keys = {"name", "unit", "better", "source"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert c["file"].startswith("wavbench/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and TEXT.match(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == metric_keys | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == metric_keys | {"layer", "moves"}
        assert TEXT.match(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_resolves_and_reports():
    from wavbench import harness

    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (BENCH_DIR / "drivers" / f"{cell['traffic']['driver']}.py").is_file()
        reported = [m["name"] for m in harness.cell_metrics(cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(cell, "per_layer")
        assert layer
        for m in layer:
            assert hasattr(harness.metric_reader(m["name"]), "read")
            assert m["moves"] in reported
            assert "workloads" not in e2e[m["moves"]] or w["name"] in e2e[m["moves"]]["workloads"]
        limits = cell["workload"]["limits"]
        assert limits and all(0 < v < 1e6 for v in limits.values())
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}


def test_roofline_and_mfu_metrics_are_percent():
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _digest(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_configuration_and_metric_need_no_edit(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric are
    added as new files and entries; the files already there stay as they
    are, and the harness finds the new ones by name."""
    shutil.copytree(BENCH_DIR, tmp_path / "wavbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "wavbench")
    bench = json.loads(json.dumps(BENCH))
    config = load_json(BENCH_DIR / "configs" / "wavjepa-base.json")
    config["name"] = "wavjepa-new"
    (tmp_path / "wavbench" / "configs" / "wavjepa-new.json").write_text(json.dumps(config))
    tr = load_json(BENCH_DIR / "traffic" / "hear-32-mixed.json")
    tr["durations_s"] = [30.0]
    (tmp_path / "wavbench" / "traffic" / "hear-32-long.json").write_text(json.dumps(tr))
    (tmp_path / "wavbench" / "workloads" / "new-embed.json").write_text(
        json.dumps({"limits": {"embed_gap": 0.5}}))
    (tmp_path / "wavbench" / "metrics" / "windows.embed.py").write_text(
        "def read(record):\n    return record.get('windows')\n")
    bench["configs"].append({"name": "wavjepa-new", "source": "https://example.org/new",
                             "file": "wavbench/configs/wavjepa-new.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "new-embed", "config": "wavjepa-new",
                               "traffic": "hear-32-long", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "windows.embed", "unit": "windows", "better": "higher",
                               "source": "program_counter", "layer": "serving entry",
                               "moves": "embed_audio_s_per_s", "workloads": ["new-embed"]})
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new-embed"])
                           if m["name"].startswith("embed_") else m for m in bench["end_to_end"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from wavbench import harness; "
            "c = harness.load_cell('new-embed'); "
            "names = [m['name'] for m in harness.cell_metrics(c, 'per_layer')]; "
            "print(c['traffic']['durations_s'], c['config']['name'], names, "
            "[harness.metric_reader(n).read({'driver': 'embed', 'windows': 3}) for n in names"
            " if n == 'windows.embed'])")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, check=True).stdout
    assert "[30.0] wavjepa-new" in out and "windows.embed" in out and "[3]" in out
    after = _digest(tmp_path / "wavbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_run_without_a_card_prints_no_result():
    """No CUDA device: exit non-zero, nothing on standard output."""
    proc = subprocess.run(
        [sys.executable, "wavbench/run.py", "--workload", "base-pretrain-1pass", "--seed",
         str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                       "PATH": "/usr/bin:/bin"}, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
