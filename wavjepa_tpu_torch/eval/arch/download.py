"""ARCH dataset download and preparation.

The port's copy of ``wavjepa_tpu/eval/arch/download.py``: a registry of
(archives, post-extract moves) a dataset, covering all 12 ARCH tasks,
runnable as

    python -m wavjepa_tpu_torch.eval.arch.download esc50 us8k --root audio_datasets
    python -m wavjepa_tpu_torch.eval.arch.download --all --dry-run

``--dry-run`` prints the fetch and extract plan and touches neither the
network nor the disk. Downloads use urllib; archives are unpacked with
the standard library (zip, tar), and the multi-part FSD50K and
MagnaTagATune zips with ``7z``, which must be on PATH.
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import subprocess
import sys
import tarfile
import urllib.request
import zipfile
from pathlib import Path
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Archive:
    url: str
    unpack: str = "auto"  # "auto" | "zip" | "tar" | "7z" | "none"


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    subdir: str
    archives: tuple
    # optional post-extract rename/move steps: (src, dst) relative to subdir
    renames: tuple = ()
    note: str = ""


REGISTRY: dict[str, DatasetSpec] = {
    spec.name: spec
    for spec in [
        DatasetSpec(
            "esc50",
            "esc50",
            (Archive("https://github.com/karoldvl/ESC-50/archive/master.zip"),),
            renames=(("ESC-50-master", "."),),
        ),
        DatasetSpec(
            "us8k",
            "us8k",  # subdir names match the eval CLI's --data-dir layout
            (Archive("https://zenodo.org/record/1203745/files/UrbanSound8K.tar.gz"),),
            renames=(("UrbanSound8K", "."),),
        ),
        DatasetSpec(
            "fsd50k",
            "fsd50k",
            (
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.z01", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.z02", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.z03", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.z04", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.z05", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.dev_audio.zip", "7z"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.eval_audio.z01", "none"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.eval_audio.zip", "7z"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.ground_truth.zip"),
                Archive("https://zenodo.org/record/4060432/files/FSD50K.metadata.zip"),
            ),
            note="multi-part zip; needs 7z on PATH",
        ),
        DatasetSpec(
            "vivae",
            "vivae",
            (Archive("https://zenodo.org/record/4066235/files/VIVAE.zip"),),
        ),
        DatasetSpec(
            "fma_small",
            "fma_small",
            (
                Archive("https://os.unil.cloud.switch.ch/fma/fma_small.zip"),
                Archive("https://os.unil.cloud.switch.ch/fma/fma_metadata.zip"),
            ),
        ),
        DatasetSpec(
            "magnatagatune",
            "magnatagatune",
            (
                # 7z must be pointed at the FIRST part of .001/.002/.003
                # split archives (unlike z01/.zip spanned sets), so the other
                # parts download first and .001 triggers extraction last
                Archive("https://mirg.city.ac.uk/datasets/magnatagatune/mp3.zip.002", "none"),
                Archive("https://mirg.city.ac.uk/datasets/magnatagatune/mp3.zip.003", "none"),
                Archive("https://mirg.city.ac.uk/datasets/magnatagatune/mp3.zip.001", "7z"),
                Archive("https://mirg.city.ac.uk/datasets/magnatagatune/annotations_final.csv", "none"),
            ),
            note="multi-part zip; needs 7z on PATH",
        ),
        DatasetSpec(
            "irmas",
            "irmas",
            (
                Archive("https://zenodo.org/record/1290750/files/IRMAS-TrainingData.zip"),
                Archive("https://zenodo.org/record/1290750/files/IRMAS-TestingData-Part1.zip"),
                Archive("https://zenodo.org/record/1290750/files/IRMAS-TestingData-Part2.zip"),
                Archive("https://zenodo.org/record/1290750/files/IRMAS-TestingData-Part3.zip"),
            ),
        ),
        DatasetSpec(
            "medleydb",
            "medleydb",
            (Archive("https://zenodo.org/record/1344103/files/Medley-solos-DB_0.0.2.tar.gz"),),
            note="Medley-solos-DB public subset",
        ),
        DatasetSpec(
            "ravdess",
            "ravdess",
            (Archive("https://zenodo.org/record/1188976/files/Audio_Speech_Actors_01-24.zip"),),
        ),
        DatasetSpec(
            "audio_mnist",
            "audio_mnist",
            (Archive("https://github.com/soerenab/AudioMNIST/archive/master.zip"),),
            renames=(("AudioMNIST-master", "."),),
        ),
        DatasetSpec(
            "slurp",
            "slurp",
            (
                Archive("https://zenodo.org/record/4274930/files/slurp_real.tar.gz"),
                Archive("https://github.com/pswietojanski/slurp/archive/master.zip"),
            ),
            # the repo zip nests the jsonl annotations; the recipe reads
            # <path>/{train,devel,test}.jsonl and <path>/slurp_real/*
            renames=(("slurp-master/dataset/slurp", "."),),
            note="audio from zenodo + annotations from the slurp repo",
        ),
        DatasetSpec(
            "emovo",
            "emovo",
            (Archive("https://drive.google.com/uc?id=1P7lzkkfbLDfPGMvpQnWELFJnPpGNUDGg", "zip"),),
            note="hosted on Google Drive; may need manual download",
        ),
    ]
}


def _fetch(url: str, dest: Path, dry_run: bool) -> Path:
    out = dest / url.rstrip("/").split("/")[-1].split("?")[0]
    if dry_run:
        print(f"  fetch   {url} -> {out}")
        return out
    if out.exists():
        print(f"  cached  {out}")
        return out
    print(f"  fetch   {url}")
    tmp = out.with_suffix(out.suffix + ".part")
    urllib.request.urlretrieve(url, tmp)  # noqa: S310
    tmp.rename(out)
    return out


def _unpack(path: Path, dest: Path, how: str, dry_run: bool):
    if how == "auto":
        name = path.name.lower()
        how = "zip" if name.endswith(".zip") else (
            "tar" if name.endswith((".tar.gz", ".tgz", ".tar")) else "none"
        )
    if how == "none":
        return
    if dry_run:
        print(f"  unpack  {path.name} ({how}) -> {dest}")
        return
    print(f"  unpack  {path.name}")
    if how == "zip":
        with zipfile.ZipFile(path) as z:
            z.extractall(dest)
    elif how == "tar":
        with tarfile.open(path) as t:
            t.extractall(dest)
    elif how == "7z":
        if shutil.which("7z") is None:
            raise RuntimeError("7z not found on PATH (needed for multi-part zips)")
        subprocess.run(["7z", "x", "-y", str(path), f"-o{dest}"], check=True)


def download(name: str, root: Path, dry_run: bool = False) -> Path:
    spec = REGISTRY[name]
    dest = root / spec.subdir
    print(f"[{name}] -> {dest}" + (f"  ({spec.note})" if spec.note else ""))
    if not dry_run:
        dest.mkdir(parents=True, exist_ok=True)
    for arc in spec.archives:
        fetched = _fetch(arc.url, dest, dry_run)
        _unpack(fetched, dest, arc.unpack, dry_run)
    for src, dst in spec.renames:
        if dry_run:
            print(f"  move    {src} -> {dst}")
            continue
        src_p = dest / src
        if src_p.exists():
            target = dest if dst == "." else dest / dst
            for item in src_p.iterdir():
                shutil.move(str(item), str(target / item.name))
            src_p.rmdir()
    return dest


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("datasets", nargs="*", help=f"any of: {', '.join(REGISTRY)}")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--root", default="audio_datasets")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    names = list(REGISTRY) if args.all else args.datasets
    if not names:
        ap.error("no datasets given (or use --all)")
    unknown = [n for n in names if n not in REGISTRY]
    if unknown:
        ap.error(f"unknown datasets: {unknown}")
    root = Path(args.root)
    for n in names:
        download(n, root, dry_run=args.dry_run)
    print(f"datasets root: {root.resolve()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
