"""WavLM's positional convolution's device time a request: the card's time
under the program's span ``wavlm.pos_conv`` (``count/spans.read``) in the
traced requests, over their number."""


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed_wavlm" or not tr:
        return None
    spent = tr.get("spans", {}).get("device_s_by_span", {}).get("wavlm.pos_conv")
    if not spent:
        return None
    return 1000.0 * spent / record["traced_requests"]
