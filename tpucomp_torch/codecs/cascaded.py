"""Batched Cascaded codec (RLE / Delta / BitPack pipeline).

PyTorch counterpart of ``tpucomp.codecs.cascaded``, producing the same
bytes.  Partition layout (one batch entry; offsets relative to the
partition start)::

    byte 0: num_RLEs   byte 1: num_deltas   byte 2: use_bp   byte 3: dtype
    bytes 4..7: uncompressed byte count (u32 LE)
    then, aligned up to the element width, a sequence of chunks:
      chunk metadata: u32 chunk_total | u32 rle_blob_bytes x num_RLEs |
                      u32 final_blob_bytes | delta first-elements
      RLE count blobs (uint16 runs, optionally bitpacked), each 4B-aligned
      final element blob, aligned to max(4, W)
      trailing padding to the element width

Incompressible partitions fall back to a raw copy with zeroed layer counts,
capping output at roundUp4(n) + 8.

``_compress_plain`` / ``_decompress_plain`` are the plain PyTorch
formulation (the counterparts of the JAX package's ``_compress_xla`` /
``_decompress_xla``): dense tensor math over [batch, chunk, element] that
runs on CPU and CUDA tensors alike.  The public ``compress`` /
``decompress`` route by device alone: a CPU tensor takes the plain
formulation, a CUDA tensor the hand-written kernels in
``kernels/cascaded_cuda.py``, every element type included
(``config.use_cuda_kernels`` can refuse either).
"""

from __future__ import annotations

import torch

from tpucomp_torch import config
from tpucomp_torch.core.options import CascadedOpts
from tpucomp_torch.core.sizing import PARTITION_HEADER, partition_output_max, round_up_to
from tpucomp_torch.core.types import DataType, Status, width_of
from tpucomp_torch.kernels import cascaded_cuda
from tpucomp_torch.ops import bitpack as bp
from tpucomp_torch.ops import delta as dl
from tpucomp_torch.ops import rle as rl
from tpucomp_torch.utils import bits, permute
from tpucomp_torch.utils.profiling import span


def chunk_metadata_size(opts: CascadedOpts) -> int:
    w = width_of(opts.type)
    return round_up_to(4 + 4 * (opts.num_rles + 1), w) + round_up_to(w * opts.num_deltas, 4)


def _counts_blob_max(opts: CascadedOpts) -> int:
    e = opts.chunk_num_elements
    return (8 + round_up_to(2 * e, 4)) if opts.use_bp else round_up_to(2 * e, 4)


def _final_blob_max(opts: CascadedOpts) -> int:
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    return (bp.bitpack_header_size(w) + round_up_to(e * w, 4)) if opts.use_bp else round_up_to(e * w, 4)


def chunk_output_max(opts: CascadedOpts) -> int:
    """Worst-case bytes one chunk can occupy (metadata + blobs + padding)."""
    w = width_of(opts.type)
    total = (
        chunk_metadata_size(opts)
        + opts.num_rles * round_up_to(_counts_blob_max(opts), 4)
        + round_up_to(_final_blob_max(opts), 4)
    )
    return round_up_to(total + w, max(4, w))


def _schedule(opts: CascadedOpts):
    """Compression op order: RLE before Delta within each layer."""
    ops = []
    rle_rem, delta_rem = opts.num_rles, opts.num_deltas
    for _ in range(max(opts.num_rles, opts.num_deltas)):
        if rle_rem > 0:
            ops.append(("rle", opts.num_rles - rle_rem))
            rle_rem -= 1
        if delta_rem > 0:
            ops.append(("delta", opts.num_deltas - delta_rem))
            delta_rem -= 1
    return ops


def _inverse_schedule(opts: CascadedOpts):
    """Decompression op order: delta when delta_rem >= rle_rem, then rle
    when rle_rem >= delta_rem, per layer."""
    ops = []
    rle_rem, delta_rem = opts.num_rles, opts.num_deltas
    for _ in range(max(opts.num_rles, opts.num_deltas)):
        if delta_rem > 0 and delta_rem >= rle_rem:
            ops.append(("delta", delta_rem - 1))
            delta_rem -= 1
        if rle_rem > 0 and rle_rem >= delta_rem:
            ops.append(("rle", rle_rem - 1))
            rle_rem -= 1
    return ops


def _ru(x, y: int):
    return (x + (y - 1)) // y * y


def _fit(t: torch.Tensor, size: int) -> torch.Tensor:
    """Zero-pad or trim the last axis to ``size``."""
    if t.shape[-1] < size:
        return torch.nn.functional.pad(t, (0, size - t.shape[-1]))
    return t[..., :size]


# ---------------------------------------------------------------------------
# plain compression


def _pack_blob(x, n, width: int, use_bp: bool, blob_max: int):
    """Raw bytes or a bitpack blob of each buffer: (uint8[..., blob_max],
    size); bytes past size are zero."""
    if use_bp:
        max_words = (blob_max - bp.bitpack_header_size(width)) // 4
        blob, size = bp.bitpack(x, n, max_words, width)
        return _fit(blob, blob_max), size
    raw = bits.units_to_bytes_le(x, width)
    size = n * width
    t = torch.arange(raw.shape[-1], device=x.device)
    return _fit(torch.where(t < size[..., None], raw, 0), blob_max), size


def _compress_plain(data: torch.Tensor, lengths: torch.Tensor, opts: CascadedOpts):
    """data uint8[B, C], lengths int32[B] -> (comp uint8[B, PMAX], sizes int32[B])."""
    dev = data.device
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    nr, nd = opts.num_rles, opts.num_deltas
    b, c = data.shape
    k = max(1, -(-c // opts.chunk_size))
    pmax = partition_output_max(c, opts)
    meta_size = chunk_metadata_size(opts)
    counts_max = _counts_blob_max(opts)

    length = lengths.to(torch.int64)
    n_elems = length // w
    input_bytes = n_elems * w

    padded = torch.zeros(b, k * e * w, dtype=torch.uint8, device=dev)
    padded[:, :c] = data
    x = bits.bytes_to_units_le(padded, w).view(b, k, e)
    chunk_n = (n_elems[:, None] - torch.arange(k, device=dev) * e).clamp(0, e)

    # ---- per-chunk pipeline, batched over [B, k]
    meta_words = torch.zeros(b, k, 2 + nr, dtype=torch.int64, device=dev)
    firsts = torch.zeros(b, k, max(nd, 1), dtype=torch.int64, device=dev)
    blobs = []  # (bytes uint8[B, k, L], chunk-relative position, size)
    pos = torch.full((b, k), meta_size, dtype=torch.int64, device=dev)
    blob_end_max = torch.zeros_like(pos)
    cur_x, cur_n = x, chunk_n
    for kind, idx in _schedule(opts):
        if kind == "rle":
            vals, counts, runs = rl.rle_encode(cur_x, cur_n)
            blob, size = _pack_blob(counts, runs, 2, opts.use_bp, counts_max)
            blobs.append((blob, pos, size))
            meta_words[..., idx + 1] = size
            pos = pos + _ru(size, 4)
            blob_end_max = torch.maximum(blob_end_max, pos)
            cur_x, cur_n = vals, runs
        else:
            cur_x, firsts[..., idx], cur_n = dl.delta_encode(cur_x, cur_n, w)
    fpos = _ru(pos, w)
    blob, size = _pack_blob(cur_x, cur_n, w, opts.use_bp, _final_blob_max(opts))
    blobs.append((blob, fpos, size))
    meta_words[..., nr + 1] = size
    blob_end_max = torch.maximum(blob_end_max, fpos + _ru(size, 4))
    total = _ru(fpos + _ru(size, 4), w)
    meta_words[..., 0] = total

    meta = torch.zeros(b, k, meta_size, dtype=torch.uint8, device=dev)
    meta[..., : 4 * (2 + nr)] = bits.units_to_bytes_le(meta_words, 4)
    if nd:
        dh_off = round_up_to(4 + 4 * (nr + 1), w)
        meta[..., dh_off : dh_off + w * nd] = bits.units_to_bytes_le(firsts[..., :nd], w)
    blobs.append((meta, torch.zeros_like(pos), torch.full_like(pos, meta_size)))

    # ---- assembly: chunks packed gaplessly behind the partition header
    valid = chunk_n > 0
    totals = torch.where(valid, total, 0)
    offsets = PARTITION_HEADER + torch.cumsum(totals, -1) - totals
    total_size = PARTITION_HEADER + totals.sum(-1)
    # fallback: any blob ending past 8B header + roundUp4(input_bytes)
    limit = PARTITION_HEADER + _ru(input_bytes, 4)
    oob = (valid & (offsets + blob_end_max > limit[:, None])).any(-1)
    no_layers = nr == 0 and nd == 0 and not opts.use_bp
    use_fallback = oob | no_layers

    width = max(pmax, PARTITION_HEADER + k * chunk_output_max(opts))
    body = torch.zeros(b, width + 1, dtype=torch.uint8, device=dev)  # +1: spare slot
    row = (torch.arange(b, device=dev) * (width + 1))[:, None, None]
    for blob, rel, size in blobs:
        t = torch.arange(blob.shape[-1], device=dev)
        tgt = row + (offsets + rel)[..., None] + t
        permute.place(body, tgt, blob, valid[..., None] & (t < size[..., None]))
    body = body[:, :pmax]

    # fallback body: raw elements at byte 8, zero past input_bytes
    t = torch.arange(pmax, device=dev)
    shifted = _fit(torch.nn.functional.pad(padded, (PARTITION_HEADER, 0)), pmax)
    raw_body = torch.where(
        (t >= PARTITION_HEADER) & (t < PARTITION_HEADER + input_bytes[:, None]), shifted, 0
    )
    out = torch.where(use_fallback[:, None], raw_body, body)

    keep = torch.where(use_fallback, 0, 1)
    out[:, 0] = (keep * nr).to(torch.uint8)
    out[:, 1] = (keep * nd).to(torch.uint8)
    out[:, 2] = (keep * int(opts.use_bp)).to(torch.uint8)
    out[:, 3] = int(opts.type)
    out[:, 4:8] = bits.units_to_bytes_le(input_bytes[:, None] & 0xFFFFFFFF, 4)
    fallback_size = PARTITION_HEADER + _ru(input_bytes, 4)
    size = torch.where(use_fallback, fallback_size, total_size)
    # empty input gets size 0; a sub-element-width input (0 < length < w)
    # still emits the 8-byte header-only partition
    size = torch.where(length > 0, size, 0)
    out = torch.where((length > 0)[:, None], out, 0)
    return out, size.to(torch.int32)


# ---------------------------------------------------------------------------
# plain decompression


def _fetch_units(words, data_off, unit_idx, width: int):
    """Units of ``width`` bytes at byte offset ``data_off`` (floored to a
    word) + unit_idx * width, read from each row's u32 words [B, NW] with
    every word index clamped into the row.  ``data_off`` is [B, ...] and
    broadcasts against ``unit_idx``."""
    last = words.shape[-1] - 1
    base = data_off // 4
    shape = torch.broadcast_shapes(base.shape, unit_idx.shape)
    b = words.shape[0]

    def word(i):
        i = (base + i).clamp(0, last).expand(shape).reshape(b, -1)
        return torch.gather(words, 1, i).view(shape)

    if width == 4:
        return word(unit_idx)
    if width == 2:
        return (word(unit_idx >> 1) >> (16 * (unit_idx & 1))) & 0xFFFF
    if width == 1:
        return (word(unit_idx >> 2) >> (8 * (unit_idx & 3))) & 0xFF
    return word(2 * unit_idx) | (word(2 * unit_idx + 1) << 32)


def _shr(x, s, width: int):
    """Logical right shift in the unit width (s < 8*width)."""
    return bits.shr(x, s) if width == 8 else x >> s


def _shl(x, s, width: int):
    """Left shift in the unit width, ``s >= 8*width`` yielding 0."""
    if width == 8:
        return bits.shl(x, s)
    return torch.where(s < 8 * width, (x << s.clamp(max=63)) & bits.unit_mask(width), 0)


def _mask(bw, width: int):
    """(1 << bw) - 1 in the unit width, all ones for bw >= 8*width."""
    if width == 8:
        return bits.mask_of_bits(bw)
    return torch.where(bw >= 8 * width, bits.unit_mask(width), (1 << bw.clamp(0, 32)) - 1)


def _read_blob_elems(words, off, size, width: int, out_elements: int, use_bp: bool):
    """A blob's elements read straight out of the row words: raw units or a
    bitpack blob.  ``off`` and ``size`` are [B, k].  Returns
    (units[B, k, out_elements], count[B, k]); the count is the blob's own
    and may exceed out_elements."""
    i = torch.arange(out_elements, device=words.device)
    if not use_bp:
        n = size // width
        elems = _fetch_units(words, off[..., None], i, width)
        return torch.where(i < n[..., None], elems, 0), n

    tbits = 8 * width
    w0 = _fetch_units(words, off, torch.zeros_like(off), 4)
    if width == 8:
        frame = w0 | (_fetch_units(words, off + 4, torch.zeros_like(off), 4) << 32)
    else:
        frame = w0 & bits.unit_mask(width)
    bw_word = _fetch_units(words, off + round_up_to(width, 4), torch.zeros_like(off), 4)
    n = bw_word & 0xFFFF
    bw = (bw_word >> 16).clamp(max=tbits)  # clamp corrupt widths

    da = (off + bp.bitpack_header_size(width))[..., None]
    bwe = bw[..., None]
    bit0 = i * bwe
    lo = bit0 // tbits
    offs = bit0 - lo * tbits
    hi = (bit0 + bwe.clamp(min=1) - 1) // tbits
    v = _shr(_fetch_units(words, da, lo, width), offs, width)
    high = _shl(_fetch_units(words, da, hi, width), tbits - offs, width)
    v = torch.where((hi > lo) & (offs != 0), v | high, v) & _mask(bwe, width)
    # add the frame; elements past n read 0, and bw == 0 reads the frame
    x = torch.where(bwe > 0, (v + frame[..., None]) & bits.unit_mask(width), frame[..., None])
    return torch.where(i < n[..., None], x, 0), n


def _walk_chunks(words, row_bytes: int, comp_size, opts: CascadedOpts, k: int):
    """Chunk start offsets [B, k], liveness [B, k] and the end position [B]
    via the reference's pointer walk: each chunk's total (clamped to
    row_bytes + 8) steps to the next at roundUp(pos + max(total, 4), w)."""
    w = width_of(opts.type)
    b = words.shape[0]
    end4 = (comp_size // 4) * 4
    pos = torch.full((b,), round_up_to(PARTITION_HEADER, w), dtype=torch.int64, device=words.device)
    offs = torch.empty(b, k, dtype=torch.int64, device=words.device)
    live = torch.zeros(b, k, dtype=torch.bool, device=words.device)
    for step in range(k):
        in_range = pos < end4
        offs[:, step] = pos
        live[:, step] = in_range
        if not bool(in_range.any()):
            offs[:, step:] = pos[:, None]  # no row moves again
            break
        word = _fetch_units(words, pos, torch.zeros_like(pos), 4)
        total = word.clamp(max=row_bytes + 8)
        pos = torch.where(in_range, _ru(pos + total.clamp(min=4), w), pos)
    return offs, live, pos


def _decompress_chunks(comp, words, comp_size, chunk_off, opts: CascadedOpts):
    """Inverse pipeline of every chunk [B, k] of the rows ``comp``.  Returns
    (units[B, k, E], count[B, k], ok[B, k])."""
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    nr, nd = opts.num_rles, opts.num_deltas
    meta_size = chunk_metadata_size(opts)
    cmax = comp.shape[1]
    end_words = (comp_size // 4)[:, None]

    ok = (chunk_off + meta_size) // 4 <= end_words

    # metadata bytes, zero past the row's end
    t = chunk_off[..., None] + torch.arange(meta_size, device=comp.device)
    meta = torch.gather(comp, 1, t.clamp(max=cmax - 1).view(comp.shape[0], -1)).view(t.shape)
    meta = torch.where(t < cmax, meta, 0)
    blob_sizes = bits.bytes_to_units_le(meta[..., : 4 * (2 + nr)], 4).clamp(max=cmax + 8)
    if nd:
        dh_off = round_up_to(4 + 4 * (nr + 1), w)
        firsts = bits.bytes_to_units_le(meta[..., dh_off : dh_off + w * nd], w)

    rle_offsets = [torch.zeros_like(chunk_off)]
    for kk in range(nr - 1):
        rle_offsets.append(_ru(rle_offsets[kk] + blob_sizes[..., kk + 1], 4))
    final_off = _ru(rle_offsets[-1] + blob_sizes[..., nr], max(4, w)) if nr else rle_offsets[0]
    base = chunk_off + meta_size

    def in_bounds(off, size):
        return (base + off) // 4 + (size + 3) // 4 <= end_words

    final_size = blob_sizes[..., nr + 1]
    ok &= in_bounds(final_off, final_size)
    cur_x, cur_n = _read_blob_elems(words, base + final_off, final_size, w, e, opts.use_bp)
    for kind, idx in _inverse_schedule(opts):
        if kind == "delta":
            cur_x, cur_n = dl.delta_decode(cur_x, firsts[..., idx], cur_n, w)
            cur_n = cur_n.clamp(max=e)
        else:
            csize = blob_sizes[..., idx + 1]
            ok &= in_bounds(rle_offsets[idx], csize)
            counts, _ = _read_blob_elems(words, base + rle_offsets[idx], csize, 2, e, opts.use_bp)
            cur_x, cur_n = rl.rle_decode(cur_x, counts, cur_n, e)
    return cur_x, torch.where(ok, cur_n, 0), ok


def _decompress_plain(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: CascadedOpts,
                      out_capacity: int):
    """comp uint8[B, CMAX], comp_sizes int32[B] -> (data uint8[B, out_capacity],
    out_bytes int32[B], statuses int32[B])."""
    dev = comp.device
    w = width_of(opts.type)
    e = opts.chunk_num_elements
    if out_capacity % w:
        raise ValueError("out_capacity must be a multiple of the element width")
    cap_elems = out_capacity // w
    k = max(1, -(-out_capacity // opts.chunk_size))
    b, cmax = comp.shape
    comp_size = comp_sizes.to(torch.int64)

    padded = _fit(comp, max(PARTITION_HEADER, round_up_to(cmax, 4)))
    words = bits.bytes_to_units_le(padded, 4)
    hdr_ok = comp_size >= PARTITION_HEADER
    nr, nd, ubp, dt = (padded[:, j].to(torch.int64) for j in range(4))
    # the u32 byte count is read as int32, as the JAX package does
    n_bytes = bits.to_signed(words[:, 1], 4)
    n_elems = n_bytes // w

    fits = out_capacity >= n_bytes
    is_fallback = (nr == 0) & (nd == 0) & (ubp == 0)
    matches = ((nr == opts.num_rles) & (nd == opts.num_deltas)
               & (ubp == int(opts.use_bp)) & (dt == int(opts.type)))

    # ---- fallback raw-copy path
    fb_ok = comp_size >= PARTITION_HEADER + n_elems * w
    t = torch.arange(out_capacity, device=dev)
    fb_out = torch.where(t < (n_elems * w)[:, None], _fit(comp[:, PARTITION_HEADER:], out_capacity), 0)

    # ---- chunked pipeline path
    offs, live, end_pos = _walk_chunks(words, cmax, comp_size, opts, k)
    elems, counts, ok_k = _decompress_chunks(comp, words, comp_size, offs, opts)
    counts = torch.where(live, counts, 0)
    cum = torch.cumsum(counts, -1)
    ok_pipeline = (ok_k | ~live).all(-1)
    ok_pipeline &= cum[:, -1] == n_elems
    ok_pipeline &= (cum <= n_elems[:, None]).all(-1)
    ok_pipeline &= end_pos >= (comp_size // 4) * 4  # all chunks consumed

    # ragged concat of the chunks' first min(count, E) elements
    placed = counts.clamp(max=e)
    el_off = torch.cumsum(placed, -1) - placed
    j = torch.arange(e, device=dev)
    tgt = el_off[..., None] + j
    out_elems = torch.zeros(b, cap_elems + 1, dtype=torch.int64, device=dev)
    row = (torch.arange(b, device=dev) * (cap_elems + 1))[:, None, None]
    permute.place(out_elems, row + tgt, elems, (j < placed[..., None]) & (tgt < cap_elems))
    pipe_out = bits.units_to_bytes_le(out_elems[:, :cap_elems], w)

    ok = torch.where(is_fallback, fb_ok, ok_pipeline & matches) & hdr_ok & fits & (comp_size > 0)
    out = torch.where(is_fallback[:, None], fb_out, pipe_out)
    out = torch.where(ok[:, None], out, 0)
    out_bytes = torch.where(ok, n_elems * w, 0).to(torch.int32)
    status = torch.where(ok, int(Status.SUCCESS), int(Status.ERROR_CANNOT_DECOMPRESS))
    return out, out_bytes, status.to(torch.int32)


# ---------------------------------------------------------------------------
# public entry points


def compress(data: torch.Tensor, lengths: torch.Tensor, opts: CascadedOpts):
    """Batched cascaded compression.

    data: uint8[B, C]; lengths: int32[B].  Returns (comp uint8[B, PMAX],
    comp_sizes int32[B]).  Lengths that are not a multiple of the element
    width are truncated.  A CPU batch takes the plain formulation, a CUDA
    batch the encode kernel (``config.kernels_enabled``), whatever the
    element type.  Span ``compress.cascaded``.
    """
    with span("compress.cascaded"):
        opts.validate()
        if not config.kernels_enabled(data.device):
            return _compress_plain(data, lengths, opts)
        return cascaded_cuda.compress(data, lengths, opts)


def decompress(comp: torch.Tensor, comp_sizes: torch.Tensor, opts: CascadedOpts, out_capacity: int):
    """Batched cascaded decompression.

    Returns (data uint8[B, out_capacity], lengths int32[B], statuses
    int32[B]).  Partitions whose stream metadata does not match ``opts``
    (other than the raw fallback) report ERROR_CANNOT_DECOMPRESS.  A CPU
    batch takes the plain formulation, a CUDA batch the decode kernel
    (``config.kernels_enabled``), whatever the element type.  Span
    ``decompress.cascaded``.
    """
    with span("decompress.cascaded"):
        opts.validate()
        if not config.kernels_enabled(comp.device):
            return _decompress_plain(comp, comp_sizes, opts, out_capacity)
        return cascaded_cuda.decompress(comp, comp_sizes, opts, out_capacity)


def detect_opts(comp: torch.Tensor, comp_sizes: torch.Tensor, chunk_size: int | None = None) -> CascadedOpts:
    """Recover CascadedOpts from a compressed batch's partition headers.

    Peeks at the first non-fallback partition's header bytes on the host.
    ``chunk_size`` is not recorded in the stream; it defaults to 4096.
    """
    heads = comp[:, :4].cpu().numpy()
    sizes = comp_sizes.cpu().numpy()
    pick = None
    for b in range(heads.shape[0]):
        if sizes[b] >= PARTITION_HEADER:
            pick = heads[b]
            if heads[b][:3].any():  # prefer a non-fallback partition
                break
    if pick is None:
        return CascadedOpts(chunk_size=chunk_size or 4096)
    nr, nd, use_bp, dt = (int(x) for x in pick)
    if nr == 0 and nd == 0 and use_bp == 0:
        # all-fallback batch: layer config unknown; defaults still decode
        return CascadedOpts(chunk_size=chunk_size or 4096, type=DataType(dt))
    return CascadedOpts(
        chunk_size=chunk_size or 4096,
        type=DataType(dt),
        num_rles=nr,
        num_deltas=nd,
        use_bp=bool(use_bp),
    )


def get_decompress_size(comp: torch.Tensor, comp_sizes: torch.Tensor) -> torch.Tensor:
    """Uncompressed byte count per partition (the u32 at offset 4, read as
    int32); 0 where the stream is shorter than the header."""
    sizes = bits.to_signed(bits.bytes_to_units_le(comp[:, 4:8], 4)[:, 0], 4)
    return torch.where(comp_sizes >= PARTITION_HEADER, sizes, 0).to(torch.int32)
