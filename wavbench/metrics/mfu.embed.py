"""The served windows' useful FLOPs (``count/flops.encoder_path_flops``)
over the untraced window's time, as a share of the H100's dense bf16
peak."""

from wavbench.count.flops import H100_BF16_PEAK_FLOPS


def read(record):
    if record.get("driver") != "embed" or not record["requests"]:
        return None
    rate = record["flops_per_window"] * record["windows"] / record["window_s"]
    return 100.0 * rate / H100_BF16_PEAK_FLOPS
