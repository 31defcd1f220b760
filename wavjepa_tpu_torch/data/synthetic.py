"""Synthetic audio: endless batches of random 10-s clips, and FLAC shards.

Counterpart of ``wavjepa_tpu/data/synthetic.py``, for smoke runs and
benchmarks: the model side is the real one, only decoding is skipped. Clips
are white noise through a one-pole low-pass, so the per-crop norms see a
decaying spectrum rather than flat noise.

For tests and smoke runs of the shard path it also writes FLAC, as test
data (``eval/synthetic.py`` writes WAV tasks the same way):

  * ``encode_flac``: 16-bit PCM → a FLAC stream of the kind ``flac -5``
    writes: 4096-sample blocks (the last one short), CONSTANT, VERBATIM,
    FIXED (orders 0-4) and LPC (order ≤ 8, 12-bit quantised coefficients)
    subframes, partitioned Rice residuals (partition order ≤ 5, parameter
    methods 0 and 1), and independent, left/side, right/side or mid/side
    stereo, chosen a frame by the smallest size; CRC-8, CRC-16 and the
    STREAMINFO MD5 filled in. Vectorised over blocks and samples,
    so minutes of audio encode in seconds.
  * ``speech_like_audio``: harmonic tones under a syllable-rate envelope
    plus low noise, which LPC compresses as it does real speech.
  * ``write_librispeech_shards``: LibriSpeech's layout (keys
    ``{speaker}-{chapter}-{utterance:04d}``, ``.flac`` and ``.txt``
    members, 16 kHz mono, durations with its training utterances' mean
    and maximum), and
    ``write_audioset_shards``: 10-s clips at 44.1 kHz stereo with ``.flac``
    and ``.json`` members.
"""

from __future__ import annotations

import functools
import hashlib
import io
import json
import os
import tarfile
from typing import Iterator

import numpy as np


def synthetic_audio_batches(
    batch_size: int,
    in_channels: int = 1,
    seconds: float = 10.0,
    sr: int = 16000,
    seed: int = 0,
    start_batch: int = 0,
) -> Iterator[np.ndarray]:
    """(batch_size, in_channels, seconds·sr) f32 batches. Batch i is a pure
    function of (seed, i), so a resumed run restarts the stream at
    ``start_batch`` in O(1)."""
    length = int(seconds * sr)
    i = start_batch
    while True:
        rng = np.random.default_rng((seed, i))
        i += 1
        # f32 draws: float64 generation is far slower on some hosts
        white = rng.standard_normal((batch_size, in_channels, length), dtype=np.float32)
        batch = white.copy()
        batch[..., 1:] = 0.7 * white[..., :-1] + 0.3 * white[..., 1:]
        yield batch


# ------------------------------------------------------------ FLAC writer

BLOCKSIZE = 4096
MAX_LPC_ORDER = 8
QLP_PRECISION = 12  # libFLAC's coefficient precision at 4096-sample blocks
MAX_PARTITION_ORDER = 5
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6, 24000: 7,
             32000: 8, 44100: 9, 48000: 10, 96000: 11}
STEREO_MODES = {"independent": 1, "left_side": 8, "right_side": 9, "mid_side": 10}


def _crc_table(poly: int, width: int) -> np.ndarray:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = np.zeros(256, np.int64)
    for b in range(256):
        c = b << (width - 8)
        for _ in range(8):
            c = (c << 1) ^ poly if c & top else c << 1
        table[b] = c & mask
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


@functools.cache
def _crc16_shifts(levels: int) -> tuple:
    """Tables that take a CRC-16 remainder past 2^l zero bytes, l < levels."""
    c = np.arange(65536, dtype=np.int64)
    s = ((c << 8) & 0xFFFF) ^ _CRC16[c >> 8]
    out = [s]
    for _ in range(levels - 1):
        s = s[s]
        out.append(s)
    return tuple(out)


def crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8[c ^ b])
    return c


def crc16(data: np.ndarray) -> int:
    """FLAC's CRC-16 (polynomial 0x8005, initial 0) of uint8 ``data``. The
    remainder is linear and leading zero bytes leave it unchanged, so the
    bytes' own remainders are combined pairwise in a tree."""
    n = len(data)
    levels = max(1, (n - 1).bit_length())
    v = np.zeros(1 << levels, np.int64)
    v[v.size - n:] = _CRC16[data]
    for shift in _crc16_shifts(levels):
        v = shift[v[0::2]] ^ v[1::2]
    return int(v[0])


class _Bits:
    """Bit fields (value, width), most significant bit first, packed at once."""

    def __init__(self):
        self.values: list = []
        self.widths: list = []

    def put(self, value, width) -> None:
        self.values.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.widths.append(np.broadcast_to(np.asarray(width, np.int64),
                                           self.values[-1].shape))

    def put_signed(self, value, width: int) -> None:
        self.put(np.asarray(value, np.int64) & ((1 << width) - 1), width)

    def bytes(self) -> np.ndarray:
        """The fields as uint8, zero-padded to a whole byte."""
        v, w = np.concatenate(self.values), np.concatenate(self.widths)
        total = int(w.sum())
        idx = np.repeat(np.arange(v.size), w)
        shift = np.cumsum(w)[idx] - 1 - np.arange(total)
        bits = ((v[idx] >> np.minimum(shift, 62)) & 1).astype(np.uint8)
        return np.packbits(np.concatenate([bits, np.zeros(-total % 8, np.uint8)]))


def _utf8_number(n: int) -> list:
    """FLAC's UTF-8-like coding of a frame number."""
    if n < 0x80:
        return [n]
    nbytes = next(k for k, limit in ((2, 1 << 11), (3, 1 << 16), (4, 1 << 21), (5, 1 << 26),
                                     (6, 1 << 31), (7, 1 << 36)) if n < limit)
    tail = []
    for _ in range(nbytes - 1):
        tail.append(0x80 | (n & 0x3F))
        n >>= 6
    return [((0xFF << (8 - nbytes)) & 0xFF) | n] + tail[::-1]


def _zigzag(r: np.ndarray) -> np.ndarray:
    return np.where(r >= 0, 2 * r, -2 * r - 1)


def _lpc(x: np.ndarray, max_order: int) -> tuple[list, np.ndarray]:
    """Levinson-Durbin on the Tukey(0.5)-windowed autocorrelation of each
    block (row of ``x``): the predictor of every order 1..max_order and
    its error, (nb, max_order)."""
    nb, n = x.shape
    m = max(1, int(0.25 * n))  # Tukey(0.5): cosine tapers over a quarter each side
    w = np.ones(n)
    ramp = 0.5 * (1 - np.cos(np.pi * np.arange(m) / m))
    w[:m], w[n - m:] = ramp, ramp[::-1]
    xw = x * w
    r = np.stack([np.einsum("ij,ij->i", xw[:, lag:], xw[:, :n - lag])
                  for lag in range(max_order + 1)], axis=1)
    err = np.maximum(r[:, 0], 1e-9)
    a = np.zeros((nb, 0))
    coefs, errs = [], []
    for i in range(max_order):
        acc = r[:, i + 1] - (a * r[:, i:0:-1][:, :i]).sum(axis=1) if i else r[:, 1].copy()
        k = acc / err
        a = np.concatenate([a - k[:, None] * a[:, ::-1], k[:, None]], axis=1)
        err = np.maximum(err * (1 - k * k), 1e-9)
        coefs.append(a.copy())
        errs.append(err.copy())
    return coefs, np.stack(errs, axis=1)


def _quantize(a: np.ndarray, precision: int) -> tuple[np.ndarray, np.ndarray]:
    """libFLAC's coefficient quantisation: a shift that puts the largest
    coefficient in ``precision`` signed bits (clamped to 0..15), then
    rounding with the error carried to the next coefficient."""
    _, log2cmax = np.frexp(np.abs(a).max(axis=1))
    prec = precision - 1
    shift = np.clip(prec - log2cmax, 0, 15).astype(np.int64)
    q = np.zeros(a.shape, np.int64)
    carry = np.zeros(a.shape[0])
    for j in range(a.shape[1]):
        carry = carry + a[:, j] * np.exp2(shift)
        q[:, j] = np.clip(np.round(carry), -(1 << prec), (1 << prec) - 1)
        carry -= q[:, j]
    return q, shift


def _lpc_residual(x: np.ndarray, q: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """x[n] − (Σ_j q_j·x[n−1−j] >> shift) for n ≥ order, as the decoder
    predicts in int64."""
    p, n = q.shape[1], x.shape[1]
    pred = np.zeros((x.shape[0], n - p), np.int64)
    for j in range(p):
        pred += q[:, j, None] * x[:, p - 1 - j:n - 1 - j]
    return x[:, p:] - (pred >> shift[:, None])


def _candidates(x: np.ndarray, bps: int) -> dict:
    """The cheapest predictor of each block (row of ``x``, int64), judged
    by an estimate of its Rice size: FIXED 0-4, or LPC at libFLAC's
    estimated best order. Returns per block the subframe kind and its
    parameters, the zigzagged residual (warm-up positions 0) and the number
    of warm-up samples."""
    nb, n = x.shape
    cands = []  # (est bits (nb,), kind, order, residual (nb, n − order), q, shift)

    def est(res, overhead):
        m = res.shape[1]
        mean = np.abs(res).sum(axis=1) * 2.0 / max(m, 1)
        return m * (np.log2(1.0 + mean) + 1.0) + overhead

    for order in range(min(5, n)):
        res = np.diff(x, n=order, axis=1) if order else x
        cands.append((est(res, order * bps + 6), "fixed", order, res, None, None))
    if n > MAX_LPC_ORDER:
        coefs, errs = _lpc(x.astype(np.float64), MAX_LPC_ORDER)
        orders = np.arange(1, MAX_LPC_ORDER + 1)
        bits_per = np.maximum(0.5 * np.log2(np.maximum(errs * 0.5 / n, 1e-30)), 0.0)
        est_bits = bits_per * (n - orders) + orders * (QLP_PRECISION + bps)
        best = est_bits.argmin(axis=1) + 1
        for order in np.unique(best):
            rows = np.nonzero(best == order)[0]
            q, shift = _quantize(coefs[order - 1][rows], QLP_PRECISION)
            res = np.zeros((nb, n - order), np.int64)
            res[rows] = _lpc_residual(x[rows], q, shift)
            qq = np.zeros((nb, order), np.int64)
            qq[rows] = q
            ss = np.zeros(nb, np.int64)
            ss[rows] = shift
            e = np.full(nb, np.inf)
            e[rows] = est(res[rows], order * (bps + QLP_PRECISION) + 15)
            cands.append((e, "lpc", int(order), res, qq, ss))
    costs = np.stack([c[0] for c in cands])
    pick = costs.argmin(axis=0)
    u = np.zeros((nb, n), np.int64)
    warm = np.zeros(nb, np.int64)
    choice = []
    for b in range(nb):
        _, kind, order, res, q, shift = cands[pick[b]]
        u[b, order:] = _zigzag(res[b])
        warm[b] = order
        choice.append((kind, order, None if q is None else q[b], None if q is None else
                       int(shift[b])))
    return {"choice": choice, "u": u, "warm": warm}


def _rice_plan(u: np.ndarray, warm: np.ndarray) -> tuple:
    """The cheapest partition order (≤ 5, dividing the block, each
    partition longer than the warm-up) and Rice parameter a partition, per
    block: (partition order (nb,), parameters (list of arrays), method
    (nb,), residual bits (nb,))."""
    nb, n = u.shape
    orders = [o for o in range(MAX_PARTITION_ORDER + 1)
              if n % (1 << o) == 0 and (n >> o) > int(warm.max())]
    finest = 1 << orders[-1]
    ks = np.arange(min(int(u.max()).bit_length(), 30) + 1)
    ur = u.reshape(nb, finest, n // finest)
    s = np.stack([(ur >> k).sum(axis=2) for k in ks])  # (K, nb, finest)
    cnt = np.full((nb, finest), n // finest, np.int64)
    cnt[:, 0] -= warm
    best_bits = np.full(nb, np.inf)
    plan_order = np.zeros(nb, np.int64)
    plan_k: list = [None] * nb
    for o in orders:
        parts = 1 << o
        so = s.reshape(len(ks), nb, parts, -1).sum(axis=3)
        co = cnt.reshape(nb, parts, -1).sum(axis=2)
        bits = so + co[None] * (ks[:, None, None] + 1)
        kbest, bmin = bits.argmin(axis=0), bits.min(axis=0)
        param_bits = np.where((kbest > 14).any(axis=1), 5, 4)
        total = bmin.sum(axis=1) + parts * param_bits + 6
        better = total < best_bits
        best_bits[better], plan_order[better] = total[better], o
        for b in np.nonzero(better)[0]:
            plan_k[b] = kbest[b]
    method = np.array([int((k > 14).any()) for k in plan_k])
    return plan_order, plan_k, method, best_bits


def _put_residual(bits: _Bits, u: np.ndarray, warm: int, part_order: int, ks: np.ndarray,
                  method: int) -> None:
    n = u.size
    bits.put(method, 2)
    bits.put(part_order, 4)
    size = n >> part_order
    k_at = np.repeat(ks, size)[warm:]
    uu = u[warm:]
    values = (1 << k_at) | (uu & ((1 << k_at) - 1))
    widths = (uu >> k_at) + 1 + k_at
    # each partition's parameter ahead of its samples
    starts = np.arange(len(ks)) * size - np.r_[0, np.full(len(ks) - 1, warm)]
    pw = 5 if method else 4
    bits.put(np.insert(values, starts, ks), np.insert(widths, starts, pw))


def _subframes(x: np.ndarray, bps: int) -> dict:
    """Everything needed to write the subframes of one signal, block by
    block, and their sizes in bits (exact)."""
    cand = _candidates(x, bps)
    order, ks, method, res_bits = _rice_plan(cand["u"], cand["warm"])
    nb, n = x.shape
    size = np.empty(nb)
    kinds = []
    for b in range(nb):
        kind, p, q, shift = cand["choice"][b]
        head = 8 + p * bps + (4 + 5 + p * QLP_PRECISION if kind == "lpc" else 0)
        if (x[b] == x[b, 0]).all():
            kinds.append(("constant",))
            size[b] = 8 + bps
        elif head + res_bits[b] >= 8 + n * bps:
            kinds.append(("verbatim",))
            size[b] = 8 + n * bps
        else:
            kinds.append((kind, p, q, shift, order[b], ks[b], method[b]))
            size[b] = head + res_bits[b]
    return {"x": x, "u": cand["u"], "kinds": kinds, "bits": size, "bps": bps}


def _put_subframe(bits: _Bits, sub: dict, b: int) -> None:
    x, bps, kind = sub["x"][b], sub["bps"], sub["kinds"][b]
    bits.put(0, 1)
    if kind[0] == "constant":
        bits.put(0, 6)
        bits.put(0, 1)
        bits.put_signed(x[0], bps)
    elif kind[0] == "verbatim":
        bits.put(1, 6)
        bits.put(0, 1)
        bits.put_signed(x, bps)
    else:
        name, p, q, shift, part_order, ks, method = kind
        bits.put(8 + p if name == "fixed" else 32 + p - 1, 6)
        bits.put(0, 1)
        bits.put_signed(x[:p], bps)
        if name == "lpc":
            bits.put(QLP_PRECISION - 1, 4)
            bits.put_signed(shift, 5)
            bits.put_signed(q, QLP_PRECISION)
        _put_residual(bits, sub["u"][b], p, int(part_order), ks, int(method))


def _blocks(x: np.ndarray) -> list:
    """A 1-D signal as a (blocks, 4096) array of its whole blocks and a
    (1, n) array of its short last block, each where there is one."""
    nb = x.size // BLOCKSIZE
    whole = x[:nb * BLOCKSIZE].reshape(nb, BLOCKSIZE) if nb else None
    rest = x[nb * BLOCKSIZE:][None] if x.size % BLOCKSIZE else None
    return [part for part in (whole, rest) if part is not None]


def encode_flac(samples: np.ndarray, sr: int) -> bytes:
    """16-bit PCM ``samples`` ((C, T) or (T,) integers in [−32768, 32767],
    C ≤ 2) → a FLAC stream; a stereo frame takes the smallest of the four
    channel assignments."""
    x = np.asarray(samples)
    if x.ndim == 1:
        x = x[None]
    if x.dtype.kind not in "iu" or x.min(initial=0) < -32768 or x.max(initial=0) > 32767:
        raise ValueError("encode_flac takes 16-bit integer samples")
    channels, total = x.shape
    if channels not in (1, 2) or total == 0:
        raise ValueError(f"encode_flac takes 1 or 2 channels of samples, got {x.shape}")
    x = x.astype(np.int64)
    bps = 16
    signals = {"left": x[0]} if channels == 1 else {
        "left": x[0], "right": x[1], "side": x[0] - x[1], "mid": (x[0] + x[1]) >> 1}
    extra = {"side": 1}
    parts = {name: [_subframes(blk, bps + extra.get(name, 0)) for blk in _blocks(sig)]
             for name, sig in signals.items()}
    layouts = {"independent": ("left", "right"), "left_side": ("left", "side"),
               "right_side": ("side", "right"), "mid_side": ("mid", "side")}
    frames, frame_no = [], 0
    for part_idx, first in enumerate(parts["left"]):
        nb, n = first["x"].shape
        if channels == 1:
            modes, codes = [("left",)] * nb, [0] * nb
        else:
            names = list(layouts)
            best = np.argmin(np.stack([sum(parts[s][part_idx]["bits"] for s in layouts[m])
                                       for m in names]), axis=0)
            modes = [layouts[names[i]] for i in best]
            codes = [STEREO_MODES[names[i]] for i in best]
        for b in range(nb):
            bits = _Bits()
            bits.put(0x3FFE, 14)
            bits.put(0, 2)  # reserved, fixed-blocksize stream
            bs_code = 12 if n == BLOCKSIZE else (6 if n <= 256 else 7)
            bits.put(bs_code, 4)
            bits.put(_SR_CODES.get(sr, 0), 4)
            bits.put(codes[b], 4)
            bits.put(0b100, 3)  # 16 bits a sample
            bits.put(0, 1)
            bits.put(np.array(_utf8_number(frame_no)), 8)
            if bs_code != 12:
                bits.put(n - 1, 8 if bs_code == 6 else 16)
            header = bits.bytes()
            bits = _Bits()
            for name in modes[b]:
                _put_subframe(bits, parts[name][part_idx], b)
            body = np.concatenate([header, np.array([crc8(header.tobytes())], np.uint8),
                                   bits.bytes()])
            c = crc16(body)
            frames.append(np.concatenate([body, np.array([c >> 8, c & 0xFF], np.uint8)]))
            frame_no += 1
    sizes = [f.size for f in frames]
    info = _Bits()
    info.put(BLOCKSIZE if total >= BLOCKSIZE else total, 16)
    info.put(BLOCKSIZE if total >= BLOCKSIZE else total, 16)
    info.put(min(sizes), 24)
    info.put(max(sizes), 24)
    info.put(sr, 20)
    info.put(channels - 1, 3)
    info.put(bps - 1, 5)
    info.put(total, 36)
    md5 = hashlib.md5(np.ascontiguousarray(x.T).astype("<i2").tobytes()).digest()
    vendor = b"wavjepa_tpu_torch synthetic"
    comment = len(vendor).to_bytes(4, "little") + vendor + (0).to_bytes(4, "little")
    return b"".join([
        b"fLaC",
        bytes([0x00]) + (34).to_bytes(3, "big") + info.bytes().tobytes() + md5,
        bytes([0x80 | 4]) + len(comment).to_bytes(3, "big") + comment,  # VORBIS_COMMENT, last
        *(f.tobytes() for f in frames),
    ])


# ------------------------------------------------------------ test audio


def speech_like_audio(rng: np.random.Generator, seconds: float, sr: int,
                      channels: int = 1) -> np.ndarray:
    """(channels, seconds·sr) int16: a voice-like harmonic tone (a
    fundamental of 90-240 Hz with vibrato, harmonics falling as 1/h below
    4 kHz, read from a one-period table) under a syllable-rate envelope
    (3-6 Hz, some syllables silent), plus noise 50 dB down. A second
    channel is the first, a few samples later and slightly quieter, with
    noise of its own."""
    n = int(round(seconds * sr))
    t = np.arange(n) / sr
    f0 = rng.uniform(90.0, 240.0)
    freq = f0 * (1.0 + 0.04 * np.sin(2 * np.pi * rng.uniform(2.0, 6.0) * t
                                     + rng.uniform(0, 2 * np.pi)))
    phase = np.cumsum(freq) / sr  # in periods
    table_n = 4096
    theta = 2 * np.pi * np.arange(table_n) / table_n
    harmonics = max(1, int(min(4000.0, 0.45 * sr) / (f0 * 1.05)))
    table = sum(rng.uniform(0.5, 1.0) / h * np.sin(h * theta + rng.uniform(0, 2 * np.pi))
                for h in range(1, harmonics + 1))
    pos = (phase % 1.0) * table_n
    i0 = pos.astype(np.int64) % table_n
    frac = pos - np.floor(pos)
    voice = table[i0] * (1 - frac) + table[(i0 + 1) % table_n] * frac
    rate = rng.uniform(3.0, 6.0)
    syll = np.floor(t * rate).astype(np.int64)
    gain = rng.uniform(0.2, 1.0, syll.max() + 1) * (rng.random(syll.max() + 1) > 0.15)
    env = gain[syll] * np.sin(np.pi * (t * rate % 1.0)) ** 2
    x = voice * env
    x = x / max(np.abs(x).max(), 1e-9)
    out = [x]
    if channels == 2:
        delay = int(rng.integers(1, 6))
        out.append(0.8 * np.r_[np.zeros(delay), x[:n - delay]])
    peak = 32767 * 10 ** (-3 / 20)  # −3 dBFS
    noise = rng.standard_normal((channels, n)) * peak * 10 ** (-50 / 20)
    return np.clip(np.round(np.stack(out) * peak + noise), -32768, 32767).astype(np.int16)


# LibriSpeech's training subsets: 100.6 + 363.6 + 496.7 = 960.9 h
# (Panayotov et al., "LibriSpeech: an ASR corpus based on public domain
# audio books", ICASSP 2015, Table 1) in 28,539 + 104,014 + 148,688 =
# 281,241 utterances (the lines of the subsets' transcripts), a mean of
# 12.30 s an utterance; its training segments are at most 35 s long
# (ibid.). It publishes no distribution of the lengths.
LIBRISPEECH_MEAN_S = 960.9 * 3600 / 281241
LIBRISPEECH_MAX_S = 35.0
# the spread about the mean: not published, chosen so that some utterances
# fall short of a 10-s clip and are padded
LIBRISPEECH_SPREAD_S = 6.0


def librispeech_durations(rng: np.random.Generator, n: int, longest: bool = False) -> np.ndarray:
    """Seconds of ``n`` utterances fitted to the two numbers LibriSpeech
    publishes of its training utterances' lengths, the mean and the
    maximum: evenly spaced over the mean ± LIBRISPEECH_SPREAD_S, so that
    their mean is the corpus's, in a random order; with ``longest`` the
    longest of them is the 35-s maximum instead."""
    d = LIBRISPEECH_MEAN_S + LIBRISPEECH_SPREAD_S * ((2 * np.arange(n) + 1) / n - 1)
    if longest:
        d[-1] = LIBRISPEECH_MAX_S
    return np.round(rng.permutation(d), 3)


def _add(tar: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tar.addfile(info, io.BytesIO(data))


_WORDS = ("THE", "OF", "AND", "A", "TO", "IN", "HE", "WAS", "THAT", "IT", "HIS", "HER",
          "WITH", "AS", "HAD", "FOR", "SHE", "NOT", "AT", "BUT", "BE", "ON", "YOU", "HIM")


def _librispeech_shard(root: str, s: int, per_shard: int) -> dict:
    rng = np.random.default_rng((0, s))
    speaker, chapter = int(rng.integers(19, 8000)), int(rng.integers(100, 300000))
    durations = librispeech_durations(rng, per_shard, longest=s == 0)
    written = {}
    with tarfile.open(os.path.join(root, f"shard-{s:04d}.tar"), "w") as tar:
        for u in range(per_shard):
            key = f"{speaker}-{chapter}-{u:04d}"
            pcm = speech_like_audio(rng, durations[u], 16000)
            words = rng.choice(_WORDS, int(rng.integers(3, 40)))
            _add(tar, f"{key}.flac", encode_flac(pcm, 16000))
            _add(tar, f"{key}.txt", " ".join(words).encode())
            written[key] = pcm
    return written


def _audioset_shard(root: str, s: int, per_shard: int, seconds: float) -> dict:
    rng = np.random.default_rng((1, s))
    alphabet = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789-_"))
    written = {}
    with tarfile.open(os.path.join(root, f"shard-{s:04d}.tar"), "w") as tar:
        for _ in range(per_shard):
            key = "".join(rng.choice(alphabet, 11))
            pcm = speech_like_audio(rng, seconds, 44100, 2)
            labels = sorted(int(v) for v in rng.choice(527, int(rng.integers(1, 4)),
                                                       replace=False))
            _add(tar, f"{key}.flac", encode_flac(pcm, 44100))
            _add(tar, f"{key}.json", json.dumps({"labels": labels}).encode())
            written[key] = pcm
    return written


def _write_shards(root: str, n_shards: int, workers: int, fn, *args) -> tuple[str, dict]:
    """``fn(root, s, *args)`` for each shard s, in ``workers`` spawned
    processes (in this one at 1); the brace pattern and the samples."""
    os.makedirs(root, exist_ok=True)
    if workers > 1:
        import concurrent.futures
        import multiprocessing

        with concurrent.futures.ProcessPoolExecutor(
                min(workers, n_shards), mp_context=multiprocessing.get_context("spawn")) as ex:
            parts = list(ex.map(fn, *zip(*[(root, s, *args) for s in range(n_shards)])))
    else:
        parts = [fn(root, s, *args) for s in range(n_shards)]
    written = {k: v for part in parts for k, v in part.items()}
    return os.path.join(root, f"shard-{{0000..{n_shards - 1:04d}}}.tar"), written


def write_librispeech_shards(root: str, n_shards: int = 8, per_shard: int = 8,
                             workers: int = 1) -> tuple[str, dict]:
    """LibriSpeech-layout WebDataset shards of FLAC utterances (16-bit mono
    at 16 kHz) under ``root``: ``shard-{0000..}.tar``, each sample a key
    ``{speaker}-{chapter}-{utterance:04d}`` with ``.flac`` and ``.txt``
    members, one speaker and chapter a shard, durations by
    ``librispeech_durations`` (shard 0's longest the corpus's 35-s
    maximum). A shard is a function of its index, so
    ``workers`` processes may write them. Returns the shards' brace pattern
    and the written samples by key, (1, T) int16."""
    return _write_shards(root, n_shards, workers, _librispeech_shard, per_shard)


def write_audioset_shards(root: str, n_shards: int = 8, per_shard: int = 4,
                          seconds: float = 10.0, workers: int = 1) -> tuple[str, dict]:
    """AudioSet-layout WebDataset shards of FLAC clips under ``root``:
    ``shard-{0000..}.tar``, each sample an 11-character YouTube-style key
    with ``.flac`` (16-bit stereo at 44.1 kHz, ``seconds`` long) and
    ``.json`` (its labels) members; written as
    ``write_librispeech_shards``'. Returns the brace pattern and the
    written samples by key, (2, T) int16."""
    return _write_shards(root, n_shards, workers, _audioset_shard, per_shard, seconds)
