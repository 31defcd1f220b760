"""The gated relative-position bias attention against its roofline: the
least time the chip needs for the traced requests' biased attention
(``count/relbias.request_seconds``, at each request's padded length) over
the device time of the ``relbias_flash`` kernels in them, matched by name."""

import re

RELBIAS_KERNELS = re.compile(r"wavjepa::relbias_flash")


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed_wavlm" or not tr:
        return None
    spent = sum(s for name, s in tr["kernel_s_by_name"].items() if RELBIAS_KERNELS.search(name))
    if spent <= 0:
        return None
    return 100.0 * record["relbias_bound_s"] / spent
