"""Serving's attention against its roofline: the least time the chip needs
for the traced requests' attention (``count/attention.serve_seconds`` of
their windows), over the device time of every kernel that implements
attention in them, matched by name."""

import re

# the port's flash kernels and projection-fused blocks, and the library's
# flash, memory-efficient and cuDNN attention kernels
ATTENTION_KERNELS = re.compile(
    r"wavjepa::(flash|fused)|flash_fwd|flash_bwd|fmha|scaled_dot_product|"
    r"efficient_attention|cudnn.*(attn|attention|sdpa)", re.I)


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed" or not tr:
        return None
    spent = sum(s for name, s in tr["kernel_s_by_name"].items() if ATTENTION_KERNELS.search(name))
    if spent <= 0:
        return None
    return 100.0 * record["attention_bound_s"] / spent
