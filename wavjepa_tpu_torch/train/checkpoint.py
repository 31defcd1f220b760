"""Training checkpoints with ``torch.save``, and the ``model_config.json``
sidecar.

Counterpart of ``wavjepa_tpu/train/checkpoint.py``. A checkpoint is one file
``<dir>/step_<N>.ckpt`` holding

  * ``state_dict``: the state's whole weights under the reference's names
    (a JEPA run's student and ``teacher_encoder.*``; a denoise run's
    student, the encoder side alone), so the HEAR runtimes of both packages
    (and the reference's loaders) read it as a reference-format checkpoint;
  * ``optimizer``: the AdamW state;
  * ``step``.

A state is a ``TrainState`` or a ``DenoiseTrainState``: anything with
``full_state()``, ``load_full_state()`` and ``step``. Under tensor
parallelism the first gathers the whole tensors over the tensor-parallel
group and the second cuts a rank's shard from them, so a file always holds
the whole model, in one format at any ``trainer.model_parallel``: a run
resumes from it at another, and the serving runtimes read it as they read
any other.

``write_model_config``/``read_model_config`` keep the JEPAConfig beside the
run in the JAX package's JSON format, so a loader rebuilds the architecture
the weights were trained with.
"""

from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Optional

import torch

from wavjepa_tpu_torch.models.jepa import JEPAConfig, jepa_config_from_dict, jepa_config_to_dict
from wavjepa_tpu_torch.parallel.mesh import barrier, from_rank_zero, process_group

MODEL_CONFIG_NAME = "model_config.json"
_CKPT = re.compile(r"step_(\d+)\.ckpt$")


class CheckpointManager:
    """Saves every ``every`` steps (or when forced) and keeps the newest
    ``keep`` files (0 = all). In a torch.distributed process group rank 0
    alone writes, every rank takes part in gathering what it writes, and
    every rank waits at each save until the file is there, so that all of
    them read the same directory. Whether a save or a restore is due is
    decided from what every rank knows alike (the steps, ``saved``, rank
    0's listing), never from a rank's own look at the directory, which
    rank 0 may be writing: a rank that decided otherwise would skip a
    collective the others wait in."""

    def __init__(self, directory: "str | Path", keep: int = 0, every: int = 1):
        self.directory = Path(directory).absolute()
        self.writer = process_group()[0] == 0
        if self.writer:
            self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.every = max(1, every)
        self.saved: Optional[int] = None  # the step last saved or restored, on every rank

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(m.group(1)) for p in self.directory.iterdir()
                      if (m := _CKPT.search(p.name)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}.ckpt"

    def save(self, step: int, state, force: bool = False) -> bool:
        if not force and step % self.every:
            return False
        weights, opt_state = state.full_state()  # every rank takes part in the gather
        if self.writer:
            blob = {"state_dict": {k: v.detach().cpu() for k, v in weights.items()},
                    "optimizer": opt_state, "step": state.step}
            tmp = self.path(step).with_suffix(".tmp")
            torch.save(blob, tmp)
            os.replace(tmp, self.path(step))  # a reader never sees half a file
            if self.keep:
                for old in self.steps()[:-self.keep]:
                    self.path(old).unlink()
        barrier()
        self.saved = step
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load a checkpoint (the newest by default, as rank 0 lists the
        directory) into ``state`` in place, each rank its shard. The file
        is this program's own: it is unpickled in full."""
        step = from_rank_zero(self.latest_step()) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        blob = torch.load(self.path(step), map_location="cpu", weights_only=False)
        state.load_full_state(blob["state_dict"], blob["optimizer"])
        state.step = int(blob["step"])
        self.saved = step
        return state


def write_model_config(run_dir: "str | Path", model_config: JEPAConfig) -> Path:
    """Write ``model_config.json`` into ``run_dir``."""
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    out = run_dir / MODEL_CONFIG_NAME
    out.write_text(json.dumps(jepa_config_to_dict(model_config), indent=1))
    return out


def read_model_config(path: "str | Path") -> Optional[JEPAConfig]:
    """The ``model_config.json`` of a checkpoint: looked for at ``path`` and
    up to three directories above it. None when there is none."""
    p = Path(path).absolute()
    for candidate in (p, *list(p.parents)[:3]):
        f = candidate / MODEL_CONFIG_NAME
        if f.is_file():
            return jepa_config_from_dict(json.loads(f.read_text()))
    return None
