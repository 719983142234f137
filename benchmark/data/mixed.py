"""The mixed corpus: general-purpose bytes, rotated by the seed.

A frozen copy of ``tpucomp_torch.utils.corpus.load_corpus``: the file
``corpus/mixed_v1.bin.gz`` (a Silesia-profile mix of text, source, an ELF
binary, structured records, redundant database text and near-random
bytes), rotated by ``(seed * 1009001) % len`` bytes when the seed is not
0, repeated to the size asked for.  The traffic file pins the file's
sha256; a file that differs raises before any timing.
"""

from __future__ import annotations

import gzip
import hashlib
from pathlib import Path


def make(total_bytes: int, seed: int, root: Path, params: dict) -> bytes:
    """``total_bytes`` of the corpus named by ``params["file"]`` (relative
    to ``root``), whose gzip file must hash to ``params["sha256"]``."""
    path = root / params["file"]
    if not path.exists():
        raise FileNotFoundError(f"the mixed corpus {path} is missing")
    raw = path.read_bytes()
    digest = hashlib.sha256(raw).hexdigest()
    if digest != params["sha256"]:
        raise RuntimeError(f"{path} has sha256 {digest}, not the {params['sha256']} the traffic file pins")
    blob = gzip.decompress(raw)
    if seed:
        k = (seed * 1009001) % len(blob)
        blob = blob[k:] + blob[:k]
    reps = -(-total_bytes // len(blob))
    return (blob * reps)[:total_bytes]
