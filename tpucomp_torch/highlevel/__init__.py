"""High-level interface ("HLIF"): self-describing artifacts
(counterpart of ``tpucomp.highlevel``)."""

from tpucomp_torch.highlevel.manager import (
    CascadedManager,
    CompressionConfig,
    DecompressionConfig,
    LZ4Manager,
    Manager,
    SnappyManager,
    create_manager,
)

__all__ = [
    "CascadedManager",
    "CompressionConfig",
    "DecompressionConfig",
    "LZ4Manager",
    "Manager",
    "SnappyManager",
    "create_manager",
]
