"""The JAX package's and the port's Cascaded entry points with numpy in
and out, for the port's tests: the same seeded inputs go through both.

On the CPU, tpucomp.codecs.cascaded.compress / decompress run their XLA
path (Pallas is off without a TPU): that is the reference.  The port's
CPU path is its plain PyTorch formulation.
"""

import jax.numpy as jnp
import numpy as np

from tpucomp.codecs import cascaded as jcc
from tpucomp.core.options import CascadedOpts as JaxOpts
from tpucomp.core.types import DataType as JaxType

from tpucomp_torch.codecs import cascaded as tcc
from tpucomp_torch.core.chunking import ChunkBatch
from tpucomp_torch.core.options import opts_from_fields

import torch_cases


def jax_opts(fields: dict) -> JaxOpts:
    return JaxOpts(**{**fields, "type": JaxType(fields["type"])})


def jax_compress(fields, arr, lens):
    comp, sizes = jcc.compress(jnp.asarray(arr), jnp.asarray(lens), jax_opts(fields))
    return np.asarray(comp), np.asarray(sizes)


def jax_decompress(fields, comp, sizes, cap):
    out = jcc.decompress(jnp.asarray(comp), jnp.asarray(sizes), jax_opts(fields), cap)
    return [np.asarray(x) for x in out]


def port_compress(fields, arr, lens):
    batch = ChunkBatch.from_numpy(arr, lens, "cpu")
    comp, sizes = tcc.compress(batch.data, batch.lengths, opts_from_fields(fields))
    return ChunkBatch(comp, sizes).to_numpy()


def port_decompress(fields, comp, sizes, cap):
    batch = ChunkBatch.from_numpy(comp, sizes, "cpu")
    data, lengths, status = tcc.decompress(batch.data, batch.lengths, opts_from_fields(fields), cap)
    return [*ChunkBatch(data, lengths).to_numpy(), status.numpy()]


def assert_decode_equal(got, want, label=""):
    for name, g, w in zip(("data", "bytes", "status"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")


def capacity(fields, arr):
    w = torch_cases.WIDTH[fields["type"]]
    return arr.shape[1] - arr.shape[1] % w
