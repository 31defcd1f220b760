"""The port's kernel build module, run with a stand-in compiler: one process
per source, all started together, output renamed into place only on success,
and a hash of the source in the library's name."""

import stat

import pytest

from wavjepa_tpu_torch.ops import _build

FAKE_NVCC = """#!/bin/sh
# writes "built <source>" to the -o path; fails on sources named bad*.cu
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
case "$(basename "$src")" in bad*) echo "error: $src" >&2; exit 2;; esac
echo "ptxas info    : Used 8 registers" >&2
echo "built $src" > "$out"
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "build_logs", {})
    return csrc, build


def test_build_all_compiles_every_source_once(fake_tree):
    csrc, build = fake_tree
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    _build.build_all()
    for name in ("a", "b"):
        lib = _build.library_path(name)
        assert lib.parent == build and lib.read_text().startswith("built ")
        assert "registers" in _build.build_logs[name]
    _build.build_logs.clear()
    _build.build_all()  # up to date: nothing runs
    assert _build.build_logs == {}
    assert sorted(p.name for p in build.iterdir()) == sorted(
        _build.library_path(n).name for n in ("a", "b"))


def test_edited_source_gets_a_new_library(fake_tree):
    csrc, _ = fake_tree
    (csrc / "a.cu").write_text("// one\n")
    first = _build.library_path("a")
    (csrc / "a.cu").write_text("// two\n")
    assert _build.library_path("a") != first


def test_edited_shared_header_renames_every_library(fake_tree):
    # the flash kernels and the GEMM include one header of Hopper primitives
    # (csrc/hopper_common.cuh); an edit to it must rebuild all of them
    csrc, _ = fake_tree
    names = ("flash_attention_fwd", "flash_attention_bwd", "hopper_gemm")
    for name in names:
        (csrc / f"{name}.cu").write_text(f'#include "hopper_common.cuh"  // {name}\n')
    (csrc / "hopper_common.cuh").write_text("// barriers, TMA, wgmma\n")
    before = {n: _build.library_path(n) for n in names}
    (csrc / "hopper_common.cuh").write_text("// barriers, TMA, wgmma, edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(before[n] != after[n] for n in names)
    assert len(set(after.values())) == len(names)


def test_failed_source_raises_and_leaves_no_library(fake_tree):
    csrc, build = fake_tree
    (csrc / "good.cu").write_text("// ok\n")
    (csrc / "bad.cu").write_text("// no\n")
    with pytest.raises(RuntimeError, match="nvcc failed for bad.cu"):
        _build.build_all()
    assert _build.library_path("good").exists()
    assert [p.name for p in build.iterdir()] == [_build.library_path("good").name]


def test_flash_ab_needs_another_checkout_and_a_card(monkeypatch):
    import torch

    from wavjepa_tpu_torch.tools import flash_ab
    assert flash_ab.main([]) == 2  # usage
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_ab.main(["."]) == 1  # nothing is built without a card


def test_flash_host_needs_a_card(monkeypatch):
    import torch

    from wavjepa_tpu_torch.tools import flash_host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert flash_host.main([]) == 1  # nothing is measured without a card
