"""The share of the untraced window in which the card would run no kernel,
copy or set: 1 - (device-busy seconds a served window of 200 tokens in
the traced requests) / (the untraced window's seconds a served window).
The profiler lengthens the traced requests' wall time with its own host
work, and barely the device's intervals, so the busy time is read from
the trace and the wall time from the window."""


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed" or not tr or not tr["busy_s"]:
        return None
    busy = tr["busy_s"] / record["traced_windows"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["windows"]))
