"""WavLM's served utterances' useful FLOPs (``count/relbias.utterance_flops``,
each utterance at its own length: padding is not useful work) over the
untraced window's time, as a share of the H100's dense bf16 peak."""

from wavbench.count.flops import H100_BF16_PEAK_FLOPS


def read(record):
    if record.get("driver") != "embed_wavlm" or not record["requests"]:
        return None
    return 100.0 * record["useful_flops"] / record["window_s"] / H100_BF16_PEAK_FLOPS
