"""Bit-twiddling primitives shared by the codecs.

torch on the CPU has no ``<<``, ``>>``, ``+``, ``min`` or ``scatter_`` for
uint16/32/64, so the port holds every element of width w as an int64
"unit": the unsigned value for w <= 4 (in [0, 2**(8w))), the raw two's
complement bits for w == 8.  Unsigned dtypes appear only in ``.view``s.
Arithmetic that wraps in the element width is ``(a op b) & unit_mask(w)``;
int64 arithmetic itself wraps, which is the w == 8 case.
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.types import SIGNED_OF_WIDTH


def unit_mask(width: int) -> int:
    """Mask of a unit's bits, as an int64 constant (-1 for w == 8)."""
    return -1 if width == 8 else (1 << (8 * width)) - 1


def to_signed(x: torch.Tensor, width: int) -> torch.Tensor:
    """Signed reading of int64 units (sign-extends from 8*width bits)."""
    if width == 8:
        return x
    top = 1 << (8 * width - 1)
    return ((x & unit_mask(width)) ^ top) - top


def shl(x: torch.Tensor, s) -> torch.Tensor:
    """64-bit left shift with ``s >= 64`` (or ``s < 0``) yielding 0."""
    s = torch.as_tensor(s, device=x.device)
    ok = (s >= 0) & (s < 64)
    return torch.where(ok, x << s.clamp(0, 63), torch.zeros_like(x))


def shr(x: torch.Tensor, s) -> torch.Tensor:
    """64-bit *logical* right shift with ``s >= 64`` (or ``s < 0``) yielding 0."""
    s = torch.as_tensor(s, device=x.device)
    sc = s.clamp(1, 63)
    # arithmetic shift, then clear the copies of the sign bit
    logical = (x >> sc) & ((torch.ones_like(sc) << (64 - sc)) - 1)
    out = torch.where(s == 0, x, logical)
    return torch.where((s >= 0) & (s < 64), out, torch.zeros_like(x))


def mask_of_bits(nbits) -> torch.Tensor:
    """(1 << nbits) - 1 as int64, with nbits >= 64 yielding all ones."""
    nbits = torch.as_tensor(nbits)
    return torch.where(
        nbits >= 64, torch.full_like(nbits, -1, dtype=torch.int64),
        (torch.ones_like(nbits, dtype=torch.int64) << nbits.clamp(0, 63)) - 1,
    )


def bit_width(r: torch.Tensor) -> torch.Tensor:
    """Significant bits of int64 ``r`` read as unsigned 64-bit (64 - clz)."""
    neg = r < 0
    r = torch.where(neg, torch.zeros_like(r), r)
    bw = torch.zeros_like(r)
    shift = 32
    while shift:
        high = r >> shift
        has = high != 0
        bw = bw + torch.where(has, shift, 0)
        r = torch.where(has, high, r)
        shift //= 2
    bw = bw + (r != 0).to(bw.dtype)
    return torch.where(neg, torch.full_like(bw, 64), bw)


def _view(b: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b = b.contiguous()
    if b.storage_offset() % dtype.itemsize:
        b = b.clone()
    return b.view(dtype)


def bytes_to_units_le(b: torch.Tensor, width: int) -> torch.Tensor:
    """uint8[..., k*width] -> int64 units [..., k], little-endian."""
    if width == 1:
        return b.to(torch.int64)
    return _view(b, SIGNED_OF_WIDTH[width]).to(torch.int64) & unit_mask(width)


def units_to_bytes_le(u: torch.Tensor, width: int) -> torch.Tensor:
    """int64 units [..., k] -> uint8[..., k*width], little-endian."""
    if width == 1:
        return (u & 0xFF).to(torch.uint8)
    s = to_signed(u, width).to(SIGNED_OF_WIDTH[width]).contiguous()
    return s.view(torch.uint8)
