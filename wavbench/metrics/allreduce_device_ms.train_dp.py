"""The gradient all-reduce's device time a step on rank 0: the card's time
under the program's span ``train.all_reduce`` (``count/spans.read``: the
NCCL kernels and the bucket copies it launches) in the traced steps, over
their number. A program without the span, or a run on one card, reads
nothing."""


def read(record):
    tr = record.get("trace")
    if record.get("world", 1) < 2 or not tr:
        return None
    spent = tr.get("spans", {}).get("device_s_by_span", {}).get("train.all_reduce")
    if not spent:
        return None
    return 1000.0 * spent / record["traced_steps"]
