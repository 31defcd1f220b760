"""ARCH evaluation of the PyTorch port: recipes of the 12 ARCH benchmarks,
embedding datasets, the probes, and the WavJEPA model contract."""

from wavjepa_tpu_torch.eval.arch.model import (  # noqa: F401
    HFWrapperModel,
    Model,
    WavJEPAModel,
)
from wavjepa_tpu_torch.eval.arch.datasets import ClassificationDataset  # noqa: F401
from wavjepa_tpu_torch.eval.arch.probes import (  # noqa: F401
    ClassificationProbe,
    SequenceProbe,
)
from wavjepa_tpu_torch.eval.arch.recipes import (  # noqa: F401
    AudioMNIST,
    EMOVO,
    ESC50,
    FMASmall,
    FSD50K,
    IRMAS,
    MagnaTagATune,
    MedleyDB,
    RAVDESS,
    SLURP,
    US8K,
    VIVAE,
)
