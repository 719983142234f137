"""BitPack stage: frame-of-reference + fixed-width bit packing.

PyTorch counterpart of ``tpucomp.ops.bitpack``.  The blob layout is the
reference's::

    [FOR: W bytes, raw little-endian signed minimum]
    [padding to 4B]
    [u32: (bitwidth << 16) | num_elements]
    [padding to max(4, W)]
    [packed bits: element i occupies bits [i*bw, (i+1)*bw) of a little-endian
     bit stream stored as u32 words]

Header size = roundUpTo(W + 4, max(4, W)): 8 bytes for W in {1, 2, 4},
16 for W == 8.  Min and max are taken on the *signed* reading of the
elements, widened to >= 32 bits; the range is wrapping u32 math for
W <= 4 and u64 for W == 8; the FOR subtraction wraps in the element width.
For n == 0 the frame and the bit width are both 0.

Elements are int64 units of ``width`` bytes (see utils/bits.py); functions
take a batch of buffers ``x[..., E]`` with valid counts ``n[...]``.
"""

from __future__ import annotations

import torch

from tpucomp_torch.core.sizing import round_up_to
from tpucomp_torch.utils import bits

_M32 = 0xFFFFFFFF


def bitpack_header_size(width: int) -> int:
    return round_up_to(width + 4, max(4, width))


def for_bitwidth(x: torch.Tensor, n: torch.Tensor, width: int):
    """Frame of reference (as a unit) and bit width of the valid prefix."""
    xs = bits.to_signed(x, width)
    valid = torch.arange(x.shape[-1], device=x.device) < n[..., None]
    top = 1 << (8 * width - 1)
    minimum = torch.where(valid, xs, top - 1).amin(-1)
    maximum = torch.where(valid, xs, -top).amax(-1)
    rng = maximum - minimum
    if width <= 4:
        rng = rng & _M32
    frame = torch.where(n > 0, minimum & bits.unit_mask(width), 0)
    bw = torch.where(n > 0, bits.bit_width(rng), 0)
    return frame, bw


def _pack_words(u: torch.Tensor, bw: torch.Tensor, max_words: int, width: int):
    """Scatter-add each element's bits into the 2 (W <= 4) or 3 (W == 8)
    u32 words it spans; parts have disjoint bits, so add == or."""
    i = torch.arange(u.shape[-1], device=u.device)
    bit0 = i * bw[..., None]
    w0 = bit0 >> 5
    s0 = bit0 & 31
    if width <= 4:
        parts = [(u << s0) & _M32, u >> (32 - s0)]
    else:
        parts = [bits.shl(u, s0) & _M32, bits.shr(u, 32 - s0) & _M32, bits.shr(u, 64 - s0) & _M32]
    words = torch.zeros(*u.shape[:-1], max_words + 1, dtype=torch.int64, device=u.device)
    for k, part in enumerate(parts):
        idx = w0 + k
        idx = torch.where((bw[..., None] > 0) & (idx < max_words), idx, max_words)
        words.scatter_add_(-1, idx, part)
    return words[..., :max_words]


def bitpack(x: torch.Tensor, n: torch.Tensor, max_words: int, width: int):
    """Pack the valid prefix of ``x`` into the reference blob format.

    Returns (blob uint8[..., header + 4*max_words], blob_size int64[...]);
    bytes past blob_size are zero.
    """
    hdr = bitpack_header_size(width)
    frame, bw = for_bitwidth(x, n, width)
    valid = torch.arange(x.shape[-1], device=x.device) < n[..., None]
    u = torch.where(valid, (x - frame[..., None]) & bits.unit_mask(width), 0)
    words = _pack_words(u, bw, max_words, width)
    blob_size = hdr + 4 * ((n * bw + 31) >> 5)

    lead = x.shape[:-1]
    header = torch.zeros(*lead, hdr, dtype=torch.uint8, device=x.device)
    header[..., :width] = bits.units_to_bytes_le(frame[..., None], width)
    bw_off = round_up_to(width, 4)
    bw_word = (bw << 16) | (n & _M32)
    header[..., bw_off : bw_off + 4] = bits.units_to_bytes_le(bw_word[..., None], 4)
    blob = torch.cat([header, bits.units_to_bytes_le(words, 4)], -1)
    t = torch.arange(blob.shape[-1], device=x.device)
    return torch.where(t < blob_size[..., None], blob, 0), blob_size
