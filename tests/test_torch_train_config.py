"""The port's run configuration against the JAX package's: the same YAML
files and overrides give the same configuration, packing bounds, microbatch
count and model configuration, field for field and exactly (the packing
sampler is numpy with a fixed seed)."""

import dataclasses

import pytest
import torch

from wavjepa_tpu.models.jepa import jepa_config_to_dict as jax_jepa_config_to_dict
from wavjepa_tpu.train import config as jcfg
from wavjepa_tpu_torch.models.jepa import jepa_config_to_dict
from wavjepa_tpu_torch.train import config as tcfg

OVERRIDES = [
    ["trainer.batch_size=4", "data.samples_per_audio=4"],
    ["trainer.precision=f32", "trainer.size=large"],
    ["masker.name=speech-masker", "extractor.name=wav2vec2"],
    ["trainer.pack_tokens=exact", "trainer.accum_steps=2"],
    ["trainer.pack_tokens=off"],
    ["trainer.remat_encoder=true", "trainer.remat_decoder=null", "optimizer.lr=1e-3",
     "ema.anneal_end_step=7", "extractor.conv_spec=[[32,10,5],[32,3,2]]",
     "data.mixing_weights=[0.5,0.5]", "trainer.attn_impl_decoder=einsum"],
    ["data.in_channels=2", "masker.channel_based_masking=true", "trainer.batch_size=16"],
]


def _both(overrides, path=None):
    return (tcfg.apply_overrides(tcfg.load_config(path), list(overrides)),
            jcfg.apply_overrides(jcfg.load_config(path), list(overrides)))


@pytest.mark.parametrize("overrides", OVERRIDES)
def test_overrides_coerce_as_the_jax_package(overrides):
    t, j = _both(overrides)
    assert tcfg.config_to_dict(t) == jcfg.config_to_dict(j)
    assert t.explicit_keys == j.explicit_keys
    assert t.run_identity() == j.run_identity()
    assert t.resolved_accum_steps() == j.resolved_accum_steps()


@pytest.mark.parametrize("overrides", OVERRIDES[:5])
def test_build_model_config_matches_field_by_field(overrides):
    t, j = _both(overrides)
    td = jepa_config_to_dict(t.build_model_config())
    jd = jax_jepa_config_to_dict(j.build_model_config())
    assert td == jd


def test_audioset_defaults_resolve_as_the_jax_package():
    t, j = _both([])
    assert t.packing_bounds(200) == j.packing_bounds(200) == (88, 128)
    assert t.resolved_accum_steps() == j.resolved_accum_steps() == 16
    mc = t.build_model_config()
    assert (mc.pack_encoder, mc.pack_decoder, mc.dtype) == (88, 128, torch.bfloat16)
    assert mc.remat_conv is mc.remat_encoder is mc.remat_decoder is False
    assert (mc.encoder_layers, mc.encoder_dim, mc.decoder_dim) == (12, 768, 384)


@pytest.mark.parametrize("t_patches", [160, 200, 999])
def test_packing_bounds_equal_the_jax_package(t_patches):
    for mode in ("auto", "exact", "off"):
        t, j = _both([f"trainer.pack_tokens={mode}"])
        assert t.packing_bounds(t_patches) == j.packing_bounds(t_patches)


def test_audioset_yaml_is_the_default_config():
    cfg = tcfg.load_config("configs/audioset.yaml")
    assert cfg == tcfg.Config()
    assert "trainer.batch_size" in cfg.explicit_keys
    assert tcfg.config_to_dict(cfg) == jcfg.config_to_dict(jcfg.load_config("configs/audioset.yaml"))


def test_bad_overrides_raise_like_the_jax_package():
    for bad in (["trainer.steps=null"], ["trainer.batch_size"], ["trainer.nope=1"]):
        with pytest.raises(Exception) as te:
            tcfg.apply_overrides(tcfg.Config(), list(bad))
        with pytest.raises(Exception) as je:
            jcfg.apply_overrides(jcfg.Config(), list(bad))
        assert type(te.value) is type(je.value)
    with pytest.raises(ValueError, match="pack_tokens"):
        tcfg.apply_overrides(tcfg.Config(), ["trainer.pack_tokens=yes"]).packing_bounds(200)
    # the denoiser's configuration resolves since the denoiser has a port; a
    # setting this process cannot honour still raises: two data-parallel
    # ranks, or two tensor-parallel ones, with no process group of two
    assert tcfg.Config().build_denoise_model_config().pack_encoder is None
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node=2"):
        tcfg.apply_overrides(tcfg.Config(), ["trainer.num_devices=2"]).build_denoise_model_config()
    with pytest.raises(ValueError, match="trainer.model_parallel=2 does not divide the 1 rank"):
        tcfg.apply_overrides(tcfg.Config(),
                             ["trainer.model_parallel=2"]).build_denoise_model_config()


def test_the_masker_builds_the_ports_maskers():
    from wavjepa_tpu_torch.masking import speech_masks, time_inverse_block_masks

    fn, mcfg = tcfg.MaskerConfig().build()
    assert fn is time_inverse_block_masks and mcfg.context_mask_prob == 0.65
    fn, mcfg = tcfg.MaskerConfig(name="speech-masker").build()
    assert fn is speech_masks and dataclasses.asdict(mcfg)["min_context_len"] == 5


# (YAML file or None, overrides, the denoise resolution): the AudioSet
# default (packed, 16 microbatches), one pass, the large model, Nat, and the
# denoise run at its default (4 microbatches) and in one pass
RESOLVED_RUNS = {
    "audioset": (None, [], False),
    "accum_1": (None, ["trainer.accum_steps=1"], False),
    "large": ("configs/large.yaml", [], False),
    "nat": ("configs/nat_binaural.yaml", [], False),
    "denoise": (None, [], True),
    "denoise_accum_1": (None, ["trainer.accum_steps=1"], True),
}
REMAT_FIELDS = (("extract_audio", "remat"), ("encoder", "remat"),
                ("encoder", "remat_save_probs"), ("decoder", "remat"),
                ("decoder", "remat_save_probs"))


@pytest.mark.parametrize("run", list(RESOLVED_RUNS))
def test_resolved_recomputation_reaches_the_built_modules_as_in_the_jax_package(run):
    """The recomputation each built module (the conv frontend, the encoder,
    the predictor; the denoise student) carries, against the same modules
    of the JAX package built from its own resolution. The port's modules
    are built on the meta device (no weights)."""
    import jax.numpy as jnp

    from wavjepa_tpu.models.denoiser import DenoiserStudent as JaxStudent
    from wavjepa_tpu.models.jepa import JEPA as JaxJEPA
    from wavjepa_tpu_torch.models.denoiser import DenoiserStudent
    from wavjepa_tpu_torch.models.jepa import JEPA

    path, overrides, denoise = RESOLVED_RUNS[run]
    t, j = _both(overrides, path)
    build = "build_denoise_model_config" if denoise else "build_model_config"
    tc, jc = getattr(t, build)(), getattr(j, build)()
    fields = REMAT_FIELDS[:3] if denoise else REMAT_FIELDS
    if denoise:
        jax_model = JaxStudent(jc).bind({})
    else:
        jax_model = JaxJEPA(jc).bind({"params": {"mask_token": jnp.zeros((1, 1, jc.decoder_dim))}})
    want = {f"{sub}.{f}": getattr(getattr(jax_model, sub), f) for sub, f in fields}
    with torch.device("meta"):
        model = (DenoiserStudent if denoise else JEPA)(tc)
    got = {f"{sub}.{f}": (getattr(model, sub).remat if sub == "extract_audio" else
                          {getattr(layer, f) for layer in getattr(model, sub).layers}.pop())
           for sub, f in fields}
    assert got == want
    # every layer of a stack alike
    for sub in ("encoder",) if denoise else ("encoder", "decoder"):
        assert len({(layer.remat, layer.remat_save_probs)
                    for layer in getattr(model, sub).layers}) == 1
