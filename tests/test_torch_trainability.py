"""The trainability probe of tests/test_trainability.py on the port, on the
CPU: the same tiny model, tone-pair clips from the same numpy seeds, 400
steps of the port's composed SSL recipe (time-inverse masker, EMA teacher
annealed over the first half, warmup AdamW), then the same linear probe
(the JAX package's ``_train_probe``, on the port's mean-pooled embeddings).
The trained encoder must beat chance by 0.30 and a random-init encoder by
0.08, the JAX test's thresholds."""

import numpy as np
import torch

from tests.test_trainability import N_CLASSES, make_clips, probe_acc
from wavjepa_tpu_torch.masking import TimeInverseMaskConfig
from wavjepa_tpu_torch.models.jepa import JEPA, JEPAConfig
from wavjepa_tpu_torch.train.loop import step_seed
from wavjepa_tpu_torch.train.state import TrainState
from wavjepa_tpu_torch.train.step import (
    EMAConfig,
    OptimizerConfig,
    make_jepa_train_step,
    make_optimizer,
)

TINY = JEPAConfig(
    conv_spec=((32, 10, 5), (32, 3, 2)),
    encoder_layers=2,
    encoder_dim=32,
    encoder_heads=4,
    decoder_layers=2,
    decoder_dim=16,
    decoder_heads=4,
    sample_rate=1600,
    process_seconds=0.201,
    average_top_k_layers=2,
)
TINY_MASK = TimeInverseMaskConfig(
    target_masks_per_context=2,
    context_mask_prob=0.5,
    context_mask_length=4,
    target_prob=0.2,
    target_length=4,
    ratio_cutoff=0.1,
)


@torch.no_grad()
def embed(model, clips):
    outs = []
    for i in range(0, len(clips), 16):
        x = torch.from_numpy(np.ascontiguousarray(clips[i:i + 16, :, :TINY.target_length]))
        outs.append(model.represent(x).mean(dim=1).float().numpy())
    return np.concatenate(outs)


def test_ssl_training_beats_random_encoder_on_probe():
    steps = 400
    rng = np.random.default_rng(0)
    model = JEPA(TINY)
    model.init_parameters(torch.Generator().manual_seed(0))
    random_init = JEPA(TINY)
    random_init.load_state_dict(model.state_dict())
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    state = TrainState.create(model, make_optimizer(opt_cfg, model))
    step = make_jepa_train_step(opt_cfg, nr_samples_per_audio=2, masker_cfg=TINY_MASK,
                                ema_cfg=EMAConfig(anneal_end_step=steps // 2))
    generator = torch.Generator()
    first_loss = None
    for i in range(steps):
        clips, _ = make_clips(rng, 2)  # 16 fresh clips a step
        generator.manual_seed(step_seed(1, state.step))
        state, metrics = step(state, torch.from_numpy(clips), generator)
        if i == 0:
            first_loss = float(metrics["loss"])
    last_loss = float(metrics["loss"])
    assert np.isfinite(last_loss)
    assert last_loss < 0.6 * first_loss, (first_loss, last_loss)

    te_rng = np.random.default_rng(123)
    tr_clips, tr_y = make_clips(te_rng, 12)
    te_clips, te_y = make_clips(te_rng, 6)
    model.eval()
    acc_trained = probe_acc(embed(model, tr_clips), tr_y, embed(model, te_clips), te_y)
    acc_random = probe_acc(embed(random_init, tr_clips), tr_y, embed(random_init, te_clips), te_y)
    chance = 1.0 / N_CLASSES
    print(f"probe accuracy: trained {acc_trained:.3f}, random init {acc_random:.3f}, "
          f"chance {chance:.3f}")
    assert acc_trained > chance + 0.30, (acc_trained, chance)
    assert acc_trained > acc_random + 0.08, (acc_trained, acc_random)
