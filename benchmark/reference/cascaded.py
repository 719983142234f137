"""Plain reference of the Cascaded compressor: the bytes tpucomp emits.

A frozen copy, in plain PyTorch, of the port's plain Cascaded encoder
(``codecs/cascaded.py`` ``_compress_plain`` with ``ops/{rle,delta,
bitpack}.py``), which the port's tests hold to the JAX package.  Each
partition: an 8-byte header (layer counts, type, byte count), then its
chunks of ``chunk_size`` bytes, each RLE'd and Delta'd in the layer
order, every count and final blob frame-of-reference bit-packed; a
partition whose blobs would pass roundUp4(n) + 8 bytes falls back to a
raw copy with zeroed layer counts.

``bw_round`` above 1 is the control: bit widths rounded up to a multiple
of it (byte-aligned packing at 8), still a valid, lossless stream that
records its widths, but not tpucomp's bytes.
"""

from __future__ import annotations

import struct

import torch

from benchmark.reference import _plain

PARTITION_HEADER = 8
M32 = 0xFFFFFFFF
CONTROL = {"bw_round": 8}  # the control: bit widths rounded up to whole bytes
ARTIFACT_FORMAT = 4  # the format byte of a manager's artifact


def artifact_header(opts: dict) -> bytes:
    """The format's own header in a manager's artifact: u64 chunk_size,
    u32 type, u32 num_RLEs, u32 num_deltas, u32 use_bp."""
    return struct.pack("<QIiii", int(opts["chunk_size"]), _plain.TYPE_BY_NAME[opts["type"]], int(opts["num_rles"]),
                       int(opts["num_deltas"]), int(bool(opts["use_bp"])))


def _opts(opts: dict):
    t = _plain.TYPE_BY_NAME[opts["type"]]
    return (int(opts["chunk_size"]), t, _plain.WIDTH_OF_TYPE[t], int(opts["num_rles"]), int(opts["num_deltas"]),
            bool(opts["use_bp"]))


def _bp_header(width: int) -> int:
    return _plain.round_up_to(width + 4, max(4, width))


def _schedule(nr: int, nd: int):
    """Compression op order: RLE before Delta within each layer."""
    ops, rle_rem, delta_rem = [], nr, nd
    for _ in range(max(nr, nd)):
        if rle_rem > 0:
            ops.append(("rle", nr - rle_rem))
            rle_rem -= 1
        if delta_rem > 0:
            ops.append(("delta", nd - delta_rem))
            delta_rem -= 1
    return ops


def _fit(t: torch.Tensor, size: int) -> torch.Tensor:
    if t.shape[-1] < size:
        return torch.nn.functional.pad(t, (0, size - t.shape[-1]))
    return t[..., :size]


def _rle(x: torch.Tensor, n: torch.Tensor):
    """(values, uint16 run counts, run count) of the valid prefix."""
    e = x.shape[-1]
    i = torch.arange(e, device=x.device)
    nn = n[..., None]
    is_end = (i == nn - 1) | ((i < nn - 1) & (x != torch.roll(x, -1, -1)))
    num_runs = is_end.sum(-1)
    rank = torch.where(is_end, torch.cumsum(is_end, -1) - 1, e)
    spare = torch.zeros(*x.shape[:-1], e + 1, dtype=x.dtype, device=x.device)
    vals = spare.clone().scatter_(-1, rank, x)[..., :e]
    ends = spare.scatter_(-1, rank, (i + 1).expand_as(x).to(x.dtype))[..., :e]
    counts = ends - torch.nn.functional.pad(ends[..., :-1], (1, 0))
    run_valid = i < num_runs[..., None]
    return torch.where(run_valid, vals, 0), torch.where(run_valid, counts & 0xFFFF, 0), num_runs


def _delta(x: torch.Tensor, n: torch.Tensor, width: int):
    """(x[i+1] - x[i] wrapping in the width, x[0], max(n - 1, 0))."""
    i = torch.arange(x.shape[-1], device=x.device)
    d = (torch.roll(x, -1, -1) - x) & _plain.unit_mask(width)
    d = torch.where(i < n[..., None] - 1, d, 0)
    return d, torch.where(n > 0, x[..., 0], 0), (n - 1).clamp(min=0)


def _bitpack(x: torch.Tensor, n: torch.Tensor, max_words: int, width: int, bw_round: int):
    """Frame of reference (signed minimum) and fixed-width packing into
    little-endian u32 words: (blob, size), zero past the size."""
    hdr = _bp_header(width)
    xs = _plain.to_signed(x, width)
    valid = torch.arange(x.shape[-1], device=x.device) < n[..., None]
    top = 1 << (8 * width - 1)
    minimum = torch.where(valid, xs, top - 1).amin(-1)
    maximum = torch.where(valid, xs, -top).amax(-1)
    rng = maximum - minimum
    if width <= 4:
        rng = rng & M32
    frame = torch.where(n > 0, minimum & _plain.unit_mask(width), 0)
    bw = torch.where(n > 0, _plain.bit_width(rng), 0)
    if bw_round > 1:
        bw = torch.minimum(_plain.ru(bw, bw_round), torch.full_like(bw, 8 * width))
    u = torch.where(valid, (x - frame[..., None]) & _plain.unit_mask(width), 0)
    i = torch.arange(u.shape[-1], device=u.device)
    bit0 = i * bw[..., None]
    w0, s0 = bit0 >> 5, bit0 & 31
    if width <= 4:
        parts = [(u << s0) & M32, u >> (32 - s0)]
    else:
        parts = [_plain.shl(u, s0) & M32, _plain.shr(u, 32 - s0) & M32, _plain.shr(u, 64 - s0) & M32]
    words = torch.zeros(*u.shape[:-1], max_words + 1, dtype=torch.int64, device=u.device)
    for k, part in enumerate(parts):
        idx = w0 + k
        idx = torch.where((bw[..., None] > 0) & (idx < max_words), idx, max_words)
        words.scatter_add_(-1, idx, part)  # disjoint bits: add == or
    words = words[..., :max_words]
    size = hdr + 4 * ((n * bw + 31) >> 5)
    header = torch.zeros(*x.shape[:-1], hdr, dtype=torch.uint8, device=x.device)
    header[..., :width] = _plain.units_to_bytes_le(frame[..., None], width)
    bw_off = _plain.round_up_to(width, 4)
    header[..., bw_off : bw_off + 4] = _plain.units_to_bytes_le(((bw << 16) | (n & M32))[..., None], 4)
    blob = torch.cat([header, _plain.units_to_bytes_le(words, 4)], -1)
    t = torch.arange(blob.shape[-1], device=x.device)
    return torch.where(t < size[..., None], blob, 0), size


def _pack_blob(x, n, width: int, use_bp: bool, blob_max: int, bw_round: int):
    if use_bp:
        blob, size = _bitpack(x, n, (blob_max - _bp_header(width)) // 4, width, bw_round)
        return _fit(blob, blob_max), size
    raw = _plain.units_to_bytes_le(x, width)
    size = n * width
    t = torch.arange(raw.shape[-1], device=x.device)
    return _fit(torch.where(t < size[..., None], raw, 0), blob_max), size


def max_compressed_size(n: int, opts: dict) -> int:
    """Output row bytes of an n-byte partition: roundUp4(n) + 8 (+ 4 for w = 8), to the width."""
    w = _opts(opts)[2]
    return _plain.round_up_to(PARTITION_HEADER + _plain.round_up_to(n, 4) + (4 if w == 8 else 0), max(4, w))


def _compress_block(data: torch.Tensor, lengths: torch.Tensor, opts: dict, bw_round: int):
    chunk_size, dtype, w, nr, nd, use_bp = _opts(opts)
    dev = data.device
    e = chunk_size // w
    ru, ru_int = _plain.ru, _plain.round_up_to
    b, c = data.shape
    k = max(1, -(-c // chunk_size))
    pmax = max_compressed_size(c, opts)
    meta_size = ru_int(4 + 4 * (nr + 1), w) + ru_int(w * nd, 4)
    counts_max = (8 + ru_int(2 * e, 4)) if use_bp else ru_int(2 * e, 4)
    final_max = (_bp_header(w) + ru_int(e * w, 4)) if use_bp else ru_int(e * w, 4)
    chunk_max = ru_int(meta_size + nr * ru_int(counts_max, 4) + ru_int(final_max, 4) + w, max(4, w))

    length = lengths.to(torch.int64)
    n_elems = length // w
    input_bytes = n_elems * w
    padded = torch.zeros(b, k * e * w, dtype=torch.uint8, device=dev)
    padded[:, :c] = data
    x = _plain.bytes_to_units_le(padded, w).view(b, k, e)
    chunk_n = (n_elems[:, None] - torch.arange(k, device=dev) * e).clamp(0, e)

    meta_words = torch.zeros(b, k, 2 + nr, dtype=torch.int64, device=dev)
    firsts = torch.zeros(b, k, max(nd, 1), dtype=torch.int64, device=dev)
    blobs = []  # (bytes uint8[B, k, L], position in the chunk, size)
    pos = torch.full((b, k), meta_size, dtype=torch.int64, device=dev)
    blob_end_max = torch.zeros_like(pos)
    cur_x, cur_n = x, chunk_n
    for kind, idx in _schedule(nr, nd):
        if kind == "rle":
            vals, counts, runs = _rle(cur_x, cur_n)
            blob, size = _pack_blob(counts, runs, 2, use_bp, counts_max, bw_round)
            blobs.append((blob, pos, size))
            meta_words[..., idx + 1] = size
            pos = pos + ru(size, 4)
            blob_end_max = torch.maximum(blob_end_max, pos)
            cur_x, cur_n = vals, runs
        else:
            cur_x, firsts[..., idx], cur_n = _delta(cur_x, cur_n, w)
    fpos = ru(pos, w)
    blob, size = _pack_blob(cur_x, cur_n, w, use_bp, final_max, bw_round)
    blobs.append((blob, fpos, size))
    meta_words[..., nr + 1] = size
    blob_end_max = torch.maximum(blob_end_max, fpos + ru(size, 4))
    total = ru(fpos + ru(size, 4), w)
    meta_words[..., 0] = total

    meta = torch.zeros(b, k, meta_size, dtype=torch.uint8, device=dev)
    meta[..., : 4 * (2 + nr)] = _plain.units_to_bytes_le(meta_words, 4)
    if nd:
        dh_off = ru_int(4 + 4 * (nr + 1), w)
        meta[..., dh_off : dh_off + w * nd] = _plain.units_to_bytes_le(firsts[..., :nd], w)
    blobs.append((meta, torch.zeros_like(pos), torch.full_like(pos, meta_size)))

    valid = chunk_n > 0
    totals = torch.where(valid, total, 0)
    offsets = PARTITION_HEADER + torch.cumsum(totals, -1) - totals
    total_size = PARTITION_HEADER + totals.sum(-1)
    limit = PARTITION_HEADER + ru(input_bytes, 4)
    oob = (valid & (offsets + blob_end_max > limit[:, None])).any(-1)
    use_fallback = oob | (nr == 0 and nd == 0 and not use_bp)

    width = max(pmax, PARTITION_HEADER + k * chunk_max)
    body = torch.zeros(b, width + 1, dtype=torch.uint8, device=dev)
    row = (torch.arange(b, device=dev) * (width + 1))[:, None, None]
    for blob, rel, size in blobs:
        t = torch.arange(blob.shape[-1], device=dev)
        _plain.place(body, row + (offsets + rel)[..., None] + t, blob, valid[..., None] & (t < size[..., None]))
    body = body[:, :pmax]

    t = torch.arange(pmax, device=dev)
    shifted = _fit(torch.nn.functional.pad(padded, (PARTITION_HEADER, 0)), pmax)
    raw_body = torch.where((t >= PARTITION_HEADER) & (t < PARTITION_HEADER + input_bytes[:, None]), shifted, 0)
    out = torch.where(use_fallback[:, None], raw_body, body)
    keep = torch.where(use_fallback, 0, 1)
    out[:, 0] = (keep * nr).to(torch.uint8)
    out[:, 1] = (keep * nd).to(torch.uint8)
    out[:, 2] = (keep * int(use_bp)).to(torch.uint8)
    out[:, 3] = dtype
    out[:, 4:8] = _plain.units_to_bytes_le(input_bytes[:, None] & M32, 4)
    size = torch.where(use_fallback, PARTITION_HEADER + ru(input_bytes, 4), total_size)
    size = torch.where(length > 0, size, 0)
    out = torch.where((length > 0)[:, None], out, 0)
    return out, size.to(torch.int32)


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: dict, block_rows: int = 1024, bw_round: int = 1):
    """(streams uint8[B, max_compressed_size(C)], sizes int32[B]) of
    uint8[B, C] partitions under the Cascaded options ``opts``
    (``chunk_size``, ``type`` by name, ``num_rles``, ``num_deltas``,
    ``use_bp``)."""
    return _plain.in_blocks(lambda d, n: _compress_block(d, n, opts, bw_round), data, lengths, block_rows)
