"""The port's FLOP count against the JAX package's, exactly; its trace
surface on the CPU; and its metric logger with and without tensorboardX."""

import builtins
import gzip
import json

import pytest
import torch

from wavjepa_tpu.train import config as jcfg
from wavjepa_tpu.utils import flops as jflops
from wavjepa_tpu_torch.train import config as tcfg
from wavjepa_tpu_torch.utils import flops, metrics, profiling

CONFIGS = {
    "audioset": [],
    "tiny": ["trainer.size=tiny", "extractor.conv_spec=[[16,10,5],[16,3,2]]",
             "data.sr=1600", "data.process_seconds=0.201"],
    "large": ["trainer.size=large"],
    "packing_off": ["trainer.pack_tokens=off"],
    "speech_masker": ["masker.name=speech-masker", "trainer.batch_size=8"],
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_flops_equal_the_jax_packages(name):
    t = tcfg.apply_overrides(tcfg.Config(), list(CONFIGS[name]))
    j = jcfg.apply_overrides(jcfg.Config(), list(CONFIGS[name]))
    tm, jm = t.build_model_config(), j.build_model_config()
    crops = t.trainer.batch_size * t.data.samples_per_audio
    got = flops.jepa_step_flops(tm, crops)
    assert isinstance(got, int) and got == jflops.jepa_step_flops(jm, crops)
    assert flops.jepa_forward_flops(tm) == jflops.jepa_forward_flops(jm)
    assert flops.encoder_path_flops(tm) == jflops.encoder_path_flops(jm)
    for alpha in (None, 0.0, 0.5, 1.0):
        for clean in (True, False):
            assert (flops.denoise_step_flops(tm, crops, alpha, clean)
                    == jflops.denoise_step_flops(jm, crops, alpha, clean))
    if name == "audioset":  # the resolved AudioSet step: 256 crops, packing 88/128
        assert (tm.pack_encoder, tm.pack_decoder, crops) == (88, 128, 256)
        assert got == 46_279_582_285_824
    if name == "packing_off":
        assert tm.pack_encoder is None
        assert got > flops.jepa_step_flops(tcfg.Config().build_model_config(), crops)


def test_mfu_and_throughput_are_per_card_over_data_parallel_ranks():
    # a step of 989 TFLOP over 4 cards in 1 s uses a quarter of each card
    assert flops.mfu(989e12, 1.0, n_cards=4) == pytest.approx(0.25)
    t = metrics.Throughput(clips_per_step=32, crops_per_step=256, n_cards=4)
    t.step()
    rates = t.rates()
    assert rates["clips_per_sec_per_card"] == pytest.approx(rates["clips_per_sec"] / 4)
    assert rates["crops_per_sec_per_card"] == pytest.approx(rates["crops_per_sec"] / 4)
    assert rates["crops_per_sec"] == pytest.approx(8 * rates["clips_per_sec"])


def test_mfu_uses_the_h100_bf16_peak():
    assert flops.H100_BF16_PEAK_FLOPS == 989e12
    assert flops.mfu(989e12, 2.0) == pytest.approx(0.5)
    assert flops.mfu(10, 1.0, peak=20) == 0.5
    assert flops.conv_output_lengths(((512, 10, 5), (512, 3, 2)), 400) == \
        jflops.conv_output_lengths(((512, 10, 5), (512, 3, 2)), 400)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "prof"), name="step") as prof:
        y = (x @ x).relu().sum()
    assert float(y) > 0
    path = tmp_path / "prof" / "step.json.gz"
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert any(e.key == "aten::mm" for e in prof.key_averages())
    assert not (tmp_path / "prof" / "step.json").exists()
    summary = profiling.trace_summary(str(path))  # no card: no device time
    assert summary["kernels"] == 0 and summary["busy_us"] == 0 and summary["wall_us"] > 0


def test_trace_summary_reads_busy_idle_and_top_kernels(tmp_path):
    """A hand-written trace: a 100-µs window with overlapping kernels, a
    copy, and a kernel outside the window."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1001.0, "dur": 5.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1010.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1020.0, "dur": 20.0},  # overlaps
        {"ph": "X", "cat": "kernel", "name": "softmax", "ts": 1050.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1090.0, "dur": 20.0},
        {"ph": "X", "cat": "kernel", "name": "later", "ts": 1200.0, "dur": 10.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1015.0},
    ]
    path = tmp_path / "t.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    s = profiling.trace_summary(str(path), window="step", top=1)
    assert s["wall_us"] == 100.0
    assert s["busy_us"] == 30.0 + 10.0 + 10.0  # gemm union, softmax, copy clipped at 1100
    assert s["idle_share"] == pytest.approx(0.5)
    assert (s["kernels"], s["copies"], s["kernel_us"]) == (3, 1, 50.0)
    assert s["top_kernels"] == [("gemm", 2, 40.0)]
    assert s["kernel_us_by_class"] == {"gemm": 40.0, "reduction": 10.0}
    whole = profiling.trace_summary(str(path))
    assert whole["kernels"] == 4 and whole["wall_us"] == 210.0
    with pytest.raises(ValueError, match="0 host ranges"):
        profiling.trace_summary(str(path), window="missing")


def test_trace_summary_counts_kernels_by_their_launch(tmp_path):
    """A kernel launched in the window but placed past its end counts; one
    launched before the window and run inside it does not; a copy without
    a launch event counts by its own start."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "step", "ts": 1000.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 990.0,
         "dur": 2.0, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1010.0,
         "dur": 2.0, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 1090.0,
         "dur": 2.0, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 1005.0, "dur": 10.0,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1020.0, "dur": 10.0,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1104.0, "dur": 10.0,
         "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1050.0, "dur": 5.0},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profiling.trace_summary(str(path), window="step")
    assert (s["kernels"], s["copies"], s["kernel_us"]) == (2, 1, 20.0)
    assert s["top_kernels"] == [("gemm", 2, 20.0)]
    assert s["busy_us"] == 10.0 + 10.0 + 5.0  # the device's intervals inside the window


@pytest.mark.parametrize("name,cls", [
    ("void wavjepa::flash_fwd::flash_attention_fwd_bf16<64>(CUtensorMap_st)", "port"),
    ("nvjet_tst_192x192_64x4_1x2_h_bz_coopB_bias_TNN", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "gemm"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>", "convolution"),
    ("void implicit_convolve_sgemm<__nv_bfloat16>", "convolution"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add<float>>", "elementwise"),
    ("void at::native::unrolled_elementwise_kernel<direct_copy_kernel_cuda>", "elementwise"),
    ("Memset (Device)", "other"),
])
def test_kernel_classes(name, cls):
    assert profiling.kernel_class(name) == cls


def _lines(log_dir):
    return [json.loads(x) for x in (log_dir / "metrics.jsonl").read_text().splitlines()]


def test_metric_logger_writes_tensorboard_events_where_tensorboardx_imports(tmp_path, capsys):
    pytest.importorskip("tensorboardX")
    log = metrics.MetricLogger(str(tmp_path))
    assert log.writer is not None
    log.log(1, {"loss": 0.5, "lr": 1e-4})
    log.close()
    assert list(tmp_path.glob("events.out.tfevents.*"))
    assert _lines(tmp_path) == [{"step": 1, "loss": 0.5, "lr": 1e-4}]
    assert "[step 1] loss=0.5" in capsys.readouterr().out


def test_metric_logger_keeps_json_lines_without_tensorboardx(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name.split(".")[0] == "tensorboardX":
            raise ImportError("No module named 'tensorboardX'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    log = metrics.MetricLogger(str(tmp_path))
    assert log.writer is None
    log.log(2, {"loss": 0.25})
    log.close()
    assert not list(tmp_path.glob("events.out.tfevents.*"))
    assert _lines(tmp_path) == [{"step": 2, "loss": 0.25}]
