"""Builds the host data path's C++ sources into one shared library.

``flac_decoder.cc`` and ``resampler.cc`` are compiled by ``g++`` into
``build/wavjepa_tpu_torch/libwavjepa_native-<hash>.so`` at the root of the
checkout and loaded with ``ctypes``. The library is compiled with
``-march=native``, so the hash covers the sources, the flags, this file and a
fingerprint of this host's CPU: a library built for another host's ISA is
never loaded (an illegal instruction in a data worker cannot be caught).
Nothing is built when a module is imported, and nothing is written into the
package: the first call that needs the library builds it, in a temporary
directory whose library is then renamed into place, so several worker
processes that reach it at once each see a whole library or none. A failed
build raises with the compiler's output; there is no fallback.

    python -m wavjepa_tpu_torch.data._native.build
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCES = (HERE / "flac_decoder.cc", HERE / "resampler.cc")
BUILD_DIR = HERE.parents[2] / "build" / "wavjepa_tpu_torch"
FLAGS = (
    "-O3", "-std=c++17", "-shared", "-fPIC", "-Wall",
    # fast-math and the host's ISA let the resampler's FMA reduction
    # vectorize; FLAC decoding is integer-exact and unaffected
    "-ffast-math", "-march=native", "-funroll-loops",
)


def cpu_fingerprint() -> str:
    """This host's ISA: the model names and feature flags of /proc/cpuinfo,
    or the machine type where that file does not exist."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.machine()
    lines = sorted({line for line in text.splitlines()
                    if line.startswith(("model name", "flags", "Features"))})
    return "\n".join(lines)


def library_path() -> Path:
    digest = hashlib.sha256()
    for source in (*SOURCES, Path(__file__)):  # this file holds the build's steps
        digest.update(source.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    digest.update(cpu_fingerprint().encode())
    return BUILD_DIR / f"libwavjepa_native-{digest.hexdigest()[:16]}.so"


def compiler() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = name and shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C++ compiler found: set CXX or put g++ on PATH")


def build() -> Path:
    """The library's path, compiled first if no library of this hash exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cxx = compiler()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [os.path.join(work, f"{s.stem}.o") for s in SOURCES]
        # compiled with FLAGS, linked without -ffast-math: linked with it,
        # the library would set flush-to-zero for the whole process it is
        # loaded into (crtfastmath.o)
        cmds = [[cxx, *FLAGS, "-c", str(s), "-o", o] for s, o in zip(SOURCES, objects)]
        tmp = os.path.join(work, out.name)
        cmds.append([cxx, "-shared", "-o", tmp, *objects])
        for cmd in cmds:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed (exit {proc.returncode}): "
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded library, built at first use (once a process)."""
    return ctypes.CDLL(str(build()))


if __name__ == "__main__":
    print(f"built {build()}")
