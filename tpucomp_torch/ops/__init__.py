"""Stage primitives: delta, run-length encode, frame-of-reference bitpack.

Import the submodules directly (``from tpucomp_torch.ops import bitpack``).
"""

from tpucomp_torch.ops import bitpack, delta, rle

__all__ = ["bitpack", "delta", "rle"]
