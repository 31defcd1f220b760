"""The train step's useful FLOPs (``count/flops.jepa_step_flops``, no
recomputation) over the untraced window's time, as a share of the H100's
dense bf16 peak."""

from wavbench.count.flops import H100_BF16_PEAK_FLOPS


def read(record):
    if record.get("driver") != "train" or not record["steps"]:
        return None
    rate = record["flops_per_step"] * record["steps"] / record["window_s"]
    return 100.0 * rate / H100_BF16_PEAK_FLOPS
