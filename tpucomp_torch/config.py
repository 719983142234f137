"""Runtime configuration: the kernel-routing flag.

``use_cuda_kernels`` decides what the codecs' public ``compress`` and
``decompress`` run (counterpart of ``tpucomp.config.use_pallas_kernels``):

  - None (default): the batch's device decides: a CPU tensor takes the
    plain PyTorch version, any other the hand-written CUDA kernels (whose
    wrappers refuse a tensor that is not on a CUDA device)
  - False: the plain PyTorch version; a batch on any other device than
    the CPU raises ``ValueError`` (a tensor on the card takes its kernel
    or raises; pass ``device="cpu"`` for the plain version)
  - True: the kernels; a CPU batch raises ``ValueError`` (the kernels
    have no interpreted form to run on the CPU)

So the flag never changes what a batch runs: it asserts the route, and
refuses a batch whose device would take the other one.  Every codec and
element type follows it, the 8-byte Cascaded types included.
"""

from __future__ import annotations

import torch

use_cuda_kernels: bool | None = None


def kernels_enabled(device) -> bool:
    """True when a batch on ``device`` goes to the CUDA kernels."""
    device = torch.device(device)
    on_cpu = device.type == "cpu"
    if use_cuda_kernels is None:
        return not on_cpu
    if use_cuda_kernels and on_cpu:
        raise ValueError(
            f"config.use_cuda_kernels is True, but the batch lies on {device}: "
            "the CUDA kernels take CUDA tensors only"
        )
    if not use_cuda_kernels and not on_cpu:
        raise ValueError(
            f"config.use_cuda_kernels is False, but the batch lies on {device}: "
            "the plain versions run on CPU tensors only (pass device='cpu')"
        )
    return bool(use_cuda_kernels)
