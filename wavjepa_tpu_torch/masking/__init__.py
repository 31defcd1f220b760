from wavjepa_tpu_torch.masking.maskers import (  # noqa: F401
    SpeechMaskConfig,
    TimeInverseMaskConfig,
    format_mask,
    speech_masks,
    time_inverse_block_masks,
)
from wavjepa_tpu_torch.masking.span import (  # noqa: F401
    filter_small_runs,
    max_spans,
    sample_span_mask_np,
    sample_span_masks,
)
