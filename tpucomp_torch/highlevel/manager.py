"""High-level interface ("HLIF"): managers over one contiguous buffer that
write self-describing artifacts (counterpart of ``tpucomp.highlevel.manager``).

  - configure_compression / compress / configure_decompression /
    decompress / get_compressed_output_size mirror the manager API;
  - the buffer is cut into ``uncomp_chunk_size`` chunks, which the
    low-level codec compresses as one batch; the streams are packed
    gaplessly, in chunk order, after an exclusive cumsum of their sizes;
  - headers (CommonHeader, FormatSpecHeader, the u64 offset and size
    tables, reserved-zero checksum sections) are byte-compatible with the
    reference and the JAX package (``headers.py``), so artifacts decode
    across the two packages;
  - PyTorch's caching allocator owns scratch: the scratch size is 0 and
    ``set_scratch_buffer`` does nothing.

Data stays on its device: ``compress`` takes bytes, a numpy array, a
sequence of byte values or a tensor, and returns the artifact on the
tensor's device, or on the manager's ``device`` (default ``"cuda"``) for
host input; ``decompress`` likewise.  Routing is by device
(``config.kernels_enabled``), for the codecs and for the artifact's own
bytes alike: on the card, the assembly and the slicing are one launch
each of the batched stream-copy kernel (``kernels/manager_cuda.py``,
``csrc/manager_copy.cu``), which builds no index tensor; on the CPU they
are the plain versions below, whose placement indices are int64, so
artifacts of 1 GiB and more need no switch on either route.

Spans of the port's tracer (``utils/profiling.py``): ``compress.manager``
with ``.stage`` (flatten, pad, lengths) and ``.assemble``
(``_assemble_artifact`` and its size read, timed on the device's clock);
``decompress.manager.open`` (``create_manager``'s header read); and
``decompress.manager`` with ``.read_header`` and ``.slice``
(``_slice_streams``, timed on the device's clock).  On the card each of
``.assemble`` and ``.slice`` holds the copy kernel's ``.launch``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpucomp_torch import config
from tpucomp_torch.core.options import CascadedOpts, LZ4Opts, SnappyOpts
from tpucomp_torch.core.sizing import (
    cascaded_max_compressed_chunk_size,
    lz4_max_compressed_chunk_size,
    snappy_max_compressed_chunk_size,
)
from tpucomp_torch.highlevel import headers as hdr
from tpucomp_torch.utils import permute
from tpucomp_torch.utils.profiling import span


@dataclasses.dataclass
class CompressionConfig:
    uncompressed_buffer_size: int
    num_chunks: int
    max_compressed_buffer_size: int


@dataclasses.dataclass
class DecompressionConfig:
    decomp_data_size: int
    num_chunks: int


def _flat_bytes(data, device) -> torch.Tensor:
    """uint8[n] of ``data``: a tensor stays on its device (values cast to
    uint8, as the JAX package's ``jnp.asarray(data, jnp.uint8)``), host
    input goes to ``device``."""
    if isinstance(data, torch.Tensor):
        return data.reshape(-1).to(torch.uint8)
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, np.uint8)
    else:
        arr = np.asarray(data, np.uint8)
    return torch.from_numpy(arr.reshape(-1).copy()).to(device)


def _head(artifact, nbytes: int) -> bytes:
    """The first ``nbytes`` of an artifact, on the host."""
    if isinstance(artifact, torch.Tensor):
        return artifact[:nbytes].cpu().numpy().tobytes()
    if isinstance(artifact, (bytes, bytearray, memoryview)):
        return bytes(artifact[:nbytes])
    return np.asarray(artifact, np.uint8).reshape(-1)[:nbytes].tobytes()


def _u64le(v: torch.Tensor) -> torch.Tensor:
    """int64[k] -> uint8[k, 8], little-endian."""
    return ((v[:, None] >> (8 * torch.arange(8, device=v.device))) & 0xFF).to(torch.uint8)


def _assemble_artifact(comp: torch.Tensor, sizes: torch.Tensor, static_head: bytes, *,
                       data_off: int, sections_off: int, out_max: int):
    """The artifact uint8[out_max] and its size in bytes.

    Writes the static header, comp_data_size (offset 8, u64 LE), the chunk
    offset and size tables (u64 LE each), and places every chunk's stream
    at ``data_off`` + the exclusive cumsum of the sizes before it.  The
    checksum sections stay reserved zeros.  A batch on the card takes the
    copy kernel (``manager_cuda.pack``), a CPU one ``_assemble_plain``."""
    if config.kernels_enabled(comp.device):
        from tpucomp_torch.kernels import manager_cuda

        artifact, total = manager_cuda.pack(comp, sizes, static_head, data_off=data_off,
                                            sections_off=sections_off, out_max=out_max)
        return artifact, data_off + int(total)
    return _assemble_plain(comp, sizes, static_head, data_off=data_off, sections_off=sections_off,
                           out_max=out_max)


def _assemble_plain(comp: torch.Tensor, sizes: torch.Tensor, static_head: bytes, *,
                    data_off: int, sections_off: int, out_max: int):
    """``_assemble_artifact``'s plain version, on any device: one int64
    target a byte of the rows and one ``index_put_``."""
    k, row = comp.shape
    dev = comp.device
    sizes = sizes.to(torch.int64)
    inc = sizes.cumsum(0)
    offsets = inc - sizes
    artifact = torch.zeros(out_max + 1, dtype=torch.uint8, device=dev)  # + permute.place's spare
    artifact[: len(static_head)] = torch.from_numpy(np.frombuffer(static_head, np.uint8).copy()).to(dev)
    artifact[8:16] = _u64le(inc[-1:])[0]
    artifact[sections_off : sections_off + 8 * k] = _u64le(offsets).reshape(-1)
    artifact[sections_off + 8 * k : sections_off + 16 * k] = _u64le(sizes).reshape(-1)
    col = torch.arange(row, device=dev)[None, :]
    permute.place(artifact, data_off + offsets[:, None] + col, comp, col < sizes[:, None])
    return artifact[:out_max], data_off + int(inc[-1])


def _slice_streams(artifact: torch.Tensor, common: hdr.CommonHeader, sections_off: int, max_chunk: int):
    """(rows uint8[k, max_chunk], sizes int32[k]): every chunk's stream cut
    out of the packed region by the u64 offset and size tables, zero past
    its size.  An artifact on the card takes the copy kernel
    (``manager_cuda.unpack``), a CPU one ``_slice_plain``."""
    if config.kernels_enabled(artifact.device):
        from tpucomp_torch.kernels import manager_cuda

        return manager_cuda.unpack(artifact, common.num_chunks, common.comp_data_offset, sections_off, max_chunk)
    return _slice_plain(artifact, common, sections_off, max_chunk)


def _slice_plain(artifact: torch.Tensor, common: hdr.CommonHeader, sections_off: int, max_chunk: int):
    """``_slice_streams``' plain version, on any device: one int64 source
    index a byte of the rows, clamped into the artifact, and a gather."""
    k = common.num_chunks
    dev = artifact.device
    tables = artifact[sections_off : sections_off + 16 * k].view(2, k, 8).to(torch.int64)
    offsets, sizes = (tables << (8 * torch.arange(8, device=dev))).sum(-1)
    t = torch.arange(max_chunk, device=dev)[None, :]
    src = (common.comp_data_offset + offsets[:, None] + t).clamp(0, artifact.numel() - 1)
    rows = torch.where(t < sizes[:, None], artifact[src], 0).to(torch.uint8)
    return rows, sizes.to(torch.int32)


class Manager:
    """Base manager; subclasses bind a format id, codec and options."""

    format_id: int

    def __init__(self, uncomp_chunk_size: int, opts, device="cuda"):
        self.uncomp_chunk_size = int(uncomp_chunk_size)
        self.opts = opts
        self.device = torch.device(device)

    # ---- format-specific hooks
    def _codec_compress(self, data, lengths):
        raise NotImplementedError

    def _codec_decompress(self, comp, sizes, out_capacity):
        raise NotImplementedError

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        raise NotImplementedError

    # ---- manager API
    def get_required_scratch_buffer_size(self) -> int:
        return 0

    def set_scratch_buffer(self, _buffer) -> None:
        pass

    def configure_compression(self, uncomp_size: int) -> CompressionConfig:
        num_chunks = max(1, -(-uncomp_size // self.uncomp_chunk_size))
        max_chunk = self._max_comp_chunk_size(self.uncomp_chunk_size)
        total = hdr.data_region_offset(self.format_id, num_chunks) + num_chunks * max_chunk
        return CompressionConfig(uncomp_size, num_chunks, total)

    def compress(self, data) -> tuple[torch.Tensor, int]:
        """Compress one contiguous buffer into a self-describing artifact.

        ``data``: bytes, a numpy array, a sequence of byte values or a
        tensor.  Returns (artifact uint8[max_size], actual_size)."""
        with span("compress.manager"):
            with span("compress.manager.stage"):
                flat = _flat_bytes(data, self.device)
                n = flat.numel()
                cfg = self.configure_compression(n)
                cs, k = self.uncomp_chunk_size, cfg.num_chunks
                padded = torch.zeros(k * cs, dtype=torch.uint8, device=flat.device)
                padded[:n] = flat
                lengths = (n - torch.arange(k, device=flat.device) * cs).clamp(0, cs).to(torch.int32)
            comp, sizes = self._codec_compress(padded.view(k, cs), lengths)
            data_off = hdr.data_region_offset(self.format_id, k)
            common = hdr.CommonHeader(format=self.format_id, comp_data_size=0, decomp_data_size=n,
                                      num_chunks=k, uncomp_chunk_size=cs, comp_data_offset=data_off)
            with span("compress.manager.assemble", device=comp.device):
                return _assemble_artifact(
                    comp, sizes, common.pack() + hdr.pack_format_spec(self.format_id, self.opts),
                    data_off=data_off, sections_off=hdr.sections_offset(self.format_id),
                    out_max=cfg.max_compressed_buffer_size)

    def configure_decompression(self, artifact) -> DecompressionConfig:
        common = hdr.CommonHeader.unpack(_head(artifact, hdr.COMMON_HEADER_SIZE))
        return DecompressionConfig(common.decomp_data_size, common.num_chunks)

    def decompress(self, artifact):
        """Returns (data uint8[decomp_size], statuses int32[num_chunks])."""
        with span("decompress.manager"):
            artifact = _flat_bytes(artifact, self.device)
            with span("decompress.manager.read_header"):
                common = hdr.CommonHeader.unpack(_head(artifact, hdr.COMMON_HEADER_SIZE))
            cs = common.uncomp_chunk_size
            with span("decompress.manager.slice", device=artifact.device):
                rows, sizes = _slice_streams(artifact, common, hdr.sections_offset(self.format_id),
                                             self._max_comp_chunk_size(cs))
            out, _, statuses = self._codec_decompress(rows, sizes, cs)
            return out.reshape(-1)[: common.decomp_data_size], statuses

    def get_compressed_output_size(self, artifact) -> int:
        common = hdr.CommonHeader.unpack(_head(artifact, hdr.COMMON_HEADER_SIZE))
        return common.comp_data_offset + common.comp_data_size


class LZ4Manager(Manager):
    """LZ4 artifacts.  Like the JAX package's manager, it compresses at
    byte granularity whatever ``opts.data_type`` says, and writes that
    data type into the format header."""

    format_id = hdr.FORMAT_LZ4

    def __init__(self, uncomp_chunk_size: int = 65536, opts: LZ4Opts | None = None, device="cuda"):
        super().__init__(uncomp_chunk_size, opts or LZ4Opts(), device)

    def _codec_compress(self, data, lengths):
        from tpucomp_torch.codecs import lz4

        return lz4.compress(data, lengths)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp_torch.codecs import lz4

        return lz4.decompress(comp, sizes, out_capacity=out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return lz4_max_compressed_chunk_size(chunk_bytes)


class SnappyManager(Manager):
    format_id = hdr.FORMAT_SNAPPY

    def __init__(self, uncomp_chunk_size: int = 65536, opts: SnappyOpts | None = None, device="cuda"):
        super().__init__(uncomp_chunk_size, opts or SnappyOpts(), device)

    def _codec_compress(self, data, lengths):
        from tpucomp_torch.codecs import snappy

        return snappy.compress(data, lengths)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp_torch.codecs import snappy

        return snappy.decompress(comp, sizes, out_capacity=out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return snappy_max_compressed_chunk_size(chunk_bytes)


class CascadedManager(Manager):
    """Cascaded artifacts: the manager's chunk is the codec's partition;
    ``opts.chunk_size`` is the scheme's internal chunk."""

    format_id = hdr.FORMAT_CASCADED

    def __init__(self, uncomp_chunk_size: int = 4096, opts: CascadedOpts | None = None, device="cuda"):
        super().__init__(uncomp_chunk_size, opts or CascadedOpts(), device)

    def _codec_compress(self, data, lengths):
        from tpucomp_torch.codecs import cascaded

        return cascaded.compress(data, lengths, self.opts)

    def _codec_decompress(self, comp, sizes, out_capacity):
        from tpucomp_torch.codecs import cascaded

        return cascaded.decompress(comp, sizes, self.opts, out_capacity)

    def _max_comp_chunk_size(self, chunk_bytes: int) -> int:
        return cascaded_max_compressed_chunk_size(chunk_bytes)


_MANAGERS = {hdr.FORMAT_LZ4: LZ4Manager, hdr.FORMAT_SNAPPY: SnappyManager, hdr.FORMAT_CASCADED: CascadedManager}


def create_manager(artifact, device=None) -> Manager:
    """The manager of a self-describing artifact, from its first 64 + 24
    bytes.  The manager works on the artifact's device (a tensor's own,
    else ``device``, default ``"cuda"``)."""
    with span("decompress.manager.open"):
        head = _head(artifact, hdr.COMMON_HEADER_SIZE + 24)
        common = hdr.CommonHeader.unpack(head[: hdr.COMMON_HEADER_SIZE])
        opts = hdr.unpack_format_spec(common.format, head[hdr.COMMON_HEADER_SIZE :])
    if device is None:
        device = artifact.device if isinstance(artifact, torch.Tensor) else "cuda"
    return _MANAGERS[common.format](common.uncomp_chunk_size, opts, device)
