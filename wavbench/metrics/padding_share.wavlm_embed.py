"""The share of the encoder's tokens that are padding in the traced
requests, from the serving entry's counters ``embed.padded_tokens`` and
``embed.tokens`` (a request's utterances padded to its longest)."""


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "embed_wavlm" or not tr:
        return None
    counters = tr.get("counters", {})
    if not counters.get("embed.tokens"):
        return None
    return 100.0 * counters.get("embed.padded_tokens", 0) / counters["embed.tokens"]
