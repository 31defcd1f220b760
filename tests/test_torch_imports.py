"""Package rules of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points run on CUDA unless asked for the CPU."""

import ast
import os
import pathlib

import pytest
import torch

import wavjepa_tpu_torch
from wavjepa_tpu_torch.api import hear_wavjepa
from wavjepa_tpu_torch.api import runtime as trt
from wavjepa_tpu_torch.models.jepa import JEPAConfig

# transformers imports TensorFlow where it is installed; nothing here needs it
os.environ.setdefault("USE_TF", "0")
PACKAGE = pathlib.Path(wavjepa_tpu_torch.__file__).parent
# the card's machine has neither scikit-learn nor pandas
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wavjepa_tpu", "sklearn", "pandas")
TINY = dict(conv_spec=((16, 10, 5), (16, 3, 2)), size="tiny",
            sample_rate=1600, process_seconds=0.201)


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax_and_not_the_jax_package():
    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imported(ast.parse(path.read_text(), str(path))):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.relative_to(PACKAGE.parent)} imports {name}"


def test_the_denoise_modules_are_among_the_files_checked():
    checked = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    for name in ("models/denoiser.py", "train/denoise_step.py", "train/denoise_loop.py",
                 "denoise.py"):
        assert name in checked, name
        tree = ast.parse((PACKAGE / name).read_text())
        assert not {n.split(".")[0] for n in _imported(tree)} & set(FORBIDDEN), name


def test_the_parallel_modules_are_among_the_files_checked():
    checked = {p.relative_to(PACKAGE).as_posix() for p in PACKAGE.rglob("*.py")}
    for name in ("parallel/__init__.py", "parallel/mesh.py"):
        assert name in checked, name
        tree = ast.parse((PACKAGE / name).read_text())
        assert not {n.split(".")[0] for n in _imported(tree)} & set(FORBIDDEN), name


def test_ast_walk_catches_a_forbidden_import():
    tree = ast.parse("def f():\n    from wavjepa_tpu.ops import pos_embed\n    import jax.numpy\n")
    assert [n.split(".")[0] for n in _imported(tree)] == ["wavjepa_tpu", "jax"]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = JEPAConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.load_model("")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.load_model("", config=cfg, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.RuntimeJEPA(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hear_wavjepa.load_model("")


def test_the_denoise_teacher_loader_defaults_to_cuda(no_cuda):
    from wavjepa_tpu_torch.train.denoise_loop import load_teacher

    cfg = JEPAConfig(**TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_teacher("", cfg, seed=0)
    assert next(load_teacher("", cfg, seed=0, device="cpu").parameters()).device.type == "cpu"


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    rt = trt.load_model("", config=JEPAConfig(**TINY), device="cpu")
    assert rt.device.type == "cpu"
    emb, ts = hear_wavjepa.get_timestamp_embeddings([torch.randn(500).numpy()], rt)
    assert emb.device.type == "cpu" and emb.shape[0] == 1 and torch.isfinite(emb).all()
    base = hear_wavjepa.load_model("", device="cpu")
    assert base.embedding_size == 768 and base.config.dtype == torch.bfloat16
    assert next(base.model.parameters()).dtype == torch.float32


def test_only_the_transformers_module_imports_transformers_and_none_sklearn_or_pandas():
    files = sorted(PACKAGE.rglob("*.py")) + [PACKAGE.parent / "chip_smoke.py"]
    importers = set()
    for path in files:
        roots = {n.split(".")[0] for n in _imported(ast.parse(path.read_text(), str(path)))}
        assert not roots & {"sklearn", "pandas"}, path
        if "transformers" in roots:
            importers.add(path.relative_to(PACKAGE.parent).as_posix())
    assert importers == {"wavjepa_tpu_torch/api/hf_transformers.py"}


def test_the_serving_and_eval_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from wavjepa_tpu_torch.api import hear_wavjepa_hf, hear_wavjepa_w2v2, hf, hf_transformers
    from wavjepa_tpu_torch.eval import embeddings, predictions

    for load in (hf.WavJEPAForAudioEmbeddings.from_pretrained, hear_wavjepa_hf.load_model,
                 hear_wavjepa_w2v2.load_model):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load("")
    export = hf_transformers.export_transformers_pretrained(
        tmp_path / "hf", trt.load_model("", config=JEPAConfig(**TINY), device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hf_transformers.WavJEPATransformersModel.from_pretrained(export)
    model = hf_transformers.WavJEPATransformersModel.from_pretrained(export, device="cpu")
    assert model.device.type == "cpu"
    (tmp_path / "tasks" / "t").mkdir(parents=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embeddings.runner("wavjepa_tpu_torch.api.hear_wavjepa", tasks_dir=str(tmp_path / "tasks"),
                          embeddings_dir=str(tmp_path / "emb"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictions.runner([str(tmp_path / "emb")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predictions.task_predictions(tmp_path / "emb")


def test_the_arch_and_xares_entry_points_raise_without_cuda(no_cuda, tmp_path):
    import numpy as np

    from wavjepa_tpu_torch.eval import synthetic
    from wavjepa_tpu_torch.eval.arch import (ESC50, ClassificationProbe, HFWrapperModel,
                                             SequenceProbe, WavJEPAModel)
    from wavjepa_tpu_torch.eval.arch.__main__ import main as arch_main
    from wavjepa_tpu_torch.eval.xares import WavJEPAEncoder
    from wavjepa_tpu_torch.eval.xares import run, vendored_protocol

    x, y = np.ones((4, 3), np.float32), np.array([0, 1, 0, 1])
    calls = [ClassificationProbe, SequenceProbe, WavJEPAModel.from_checkpoint,
             HFWrapperModel.from_pretrained, WavJEPAEncoder,
             lambda: run.main(["stub"]), lambda: run._train_probe(x, y, 2),
             lambda: vendored_protocol.knn_classify(x, y, x),
             lambda: vendored_protocol._train_probe_multilabel(x, np.eye(4, 2)),
             lambda: arch_main(["--data-dir", str(tmp_path), "--datasets", "esc50"])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    synthetic.write_arch_esc50(tmp_path / "esc50", 1600, classes=2, clips_per_class=5,
                               seconds=0.25)
    model = WavJEPAModel(trt.load_model("", config=JEPAConfig(**TINY), device="cpu"))
    recipe = ESC50(str(tmp_path / "esc50"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recipe.evaluate(model, max_num_epochs=1)
    result = recipe.evaluate(model, max_num_epochs=1, device="cpu")
    assert 0.0 <= result["accuracy"] <= 1.0
