"""WebDataset tar shards without the webdataset package.

Counterpart of ``wavjepa_tpu/data/shards.py``. A shard is a tar archive
whose members share a basename key and differ by extension
(``clip0001.flac``, ``clip0001.json``). Shards are assigned to (host,
worker) by a fixed two-level stripe, as WebDataset's ``split_by_node`` then
``split_by_worker`` do, and a corrupt shard is skipped with a warning, as
``warn_and_continue`` does.
"""

from __future__ import annotations

import re
import tarfile
from pathlib import Path
from typing import Iterator, Sequence

_BRACE_RE = re.compile(r"\{(\d+)\.\.(\d+)\}")


def expand_shard_pattern(pattern: str) -> list[str]:
    """Expand WebDataset brace notation, 'shard-{000000..000019}.tar' → 20
    zero-padded paths; a comma joins several patterns; a plain path passes
    through."""
    if "," in pattern:
        out: list[str] = []
        for part in pattern.split(","):
            out.extend(expand_shard_pattern(part.strip()))
        return out
    match = _BRACE_RE.search(pattern)
    if not match:
        return [pattern]
    lo, hi = match.group(1), match.group(2)
    width = len(lo)
    prefix, suffix = pattern[: match.start()], pattern[match.end():]
    return [f"{prefix}{i:0{width}d}{suffix}" for i in range(int(lo), int(hi) + 1)]


def split_shards(shards: Sequence[str], host_id: int = 0, num_hosts: int = 1,
                 worker_id: int = 0, num_workers: int = 1) -> list[str]:
    """Shards striped over hosts, then over the workers of this host."""
    per_host = list(shards[host_id::num_hosts])
    return per_host[worker_id::num_workers]


def _sample_key(name: str) -> tuple[str, str]:
    """Member name → (sample key, extension); the extension is everything
    after the first dot of the basename (the WebDataset convention)."""
    path = Path(name)
    base = path.name
    if "." in base:
        key, ext = base.split(".", 1)
    else:
        key, ext = base, ""
    return str(path.parent / key), ext.lower()


def iter_tar_samples(path: str) -> Iterator[tuple[str, dict[str, bytes]]]:
    """(key, {extension: payload}) groups of one shard, streamed. Members of
    one sample are consecutive (shards are written grouped)."""
    with tarfile.open(path, mode="r|*") as tar:
        current_key: str | None = None
        current: dict[str, bytes] = {}
        for member in tar:
            if not member.isfile():
                continue
            key, ext = _sample_key(member.name)
            payload = tar.extractfile(member)
            if payload is None:
                continue
            data = payload.read()
            if current_key is None:
                current_key = key
            if key != current_key:
                if current:
                    yield current_key, current
                current_key, current = key, {}
            current[ext] = data
        if current_key is not None and current:
            yield current_key, current


def iter_shard_samples(shards: Sequence[str], repeat: bool = True,
                       handler: str = "warn") -> Iterator[tuple[str, dict[str, bytes]]]:
    """Samples of many shards in order, forever with ``repeat``. A corrupt
    or missing shard is skipped with a warning (``handler="warn"``) or
    raises (``"raise"``). A pass over every shard that yields no sample
    raises, where repeating it would spin without end."""
    while True:
        n = 0
        for shard in shards:
            try:
                for sample in iter_tar_samples(shard):
                    n += 1
                    yield sample
            except (tarfile.TarError, OSError) as exc:
                if handler == "raise":
                    raise
                print(f"[data] skipping corrupt shard {shard}: {exc}", flush=True)
        if not repeat:
            return
        if n == 0:
            raise RuntimeError(f"no readable sample in any of {len(shards)} shards "
                               f"({', '.join(list(shards)[:3])}{', ...' if len(shards) > 3 else ''})")
