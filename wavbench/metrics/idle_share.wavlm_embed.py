"""The share of the untraced window in which the card would run no kernel,
copy or set: 1 - (device-busy seconds a second of audio in the traced
requests) / (the untraced window's seconds a second of audio served). The
traced requests are the pool once over, the window's mix; the profiler
lengthens their wall time, and barely the device's intervals, so the busy
time is read from the trace and the wall time from the window."""


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed_wavlm" or not tr or not tr["busy_s"]:
        return None
    busy = tr["busy_s"] / record["traced_audio_s"]
    return 100.0 * (1.0 - busy / (record["window_s"] / record["audio_s"]))
