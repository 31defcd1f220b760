"""Kernels the card ran in the traced steps, a step: a count, which repeats
exactly while the program is unchanged."""


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "train" or not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / record["traced_steps"]
