"""tpucomp_torch stage primitives held to tpucomp.ops (exact equality).

The same numpy inputs go through the JAX stage (vmapped over a batch) and
the port's batched torch stage; blobs, values, counts and sizes must be
identical for all 8 element types.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucomp.ops import bitpack as jbp
from tpucomp.ops import delta as jdl
from tpucomp.ops import rle as jrl

from tpucomp_torch.ops import bitpack as bp
from tpucomp_torch.ops import delta as dl
from tpucomp_torch.ops import rle as rl

from oracles.cascaded_oracle import bitpack_oracle

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32, np.uint64, np.int64]
E = 128


def _unsigned(dtype):
    return np.dtype(f"u{np.dtype(dtype).itemsize}")


def to_units(u: np.ndarray) -> torch.Tensor:
    """Unsigned numpy array -> the port's int64 units."""
    return torch.from_numpy(u.view(np.int64) if u.dtype == np.uint64 else u.astype(np.int64))


def from_units(t: torch.Tensor, width: int) -> np.ndarray:
    a = t.numpy()
    return a.view(np.uint64) if width == 8 else a.astype(np.dtype(f"u{width}"))


def _batch(rng, dtype, e=E):
    """Rows of runs, small ranges, full-range bytes, constants and ramps,
    with valid counts including 0, 1 and e."""
    d = np.dtype(dtype)
    rows = [
        np.repeat(rng.integers(0, 5, e), rng.integers(1, 9, e))[:e].astype(d),
        rng.integers(100, 131, e).astype(d),
        rng.integers(0, 256, e * d.itemsize, dtype=np.uint8).view(d),
        np.full(e, 42, d),
        (np.arange(e) * 3 + 7).astype(d),
        rng.integers(0, 256, e * d.itemsize, dtype=np.uint8).view(d),
    ]
    x = np.stack(rows).view(_unsigned(dtype))
    n = np.array([e, 37, e, 1, 2, 0], np.int32)
    return x, n


@pytest.mark.parametrize("dtype", DTYPES)
def test_delta_matches_tpucomp(rng, dtype):
    w = np.dtype(dtype).itemsize
    x, n = _batch(rng, dtype)
    jd, jfirst, jcnt = jax.vmap(jdl.delta_encode)(jnp.asarray(x), jnp.asarray(n))
    d, first, cnt = dl.delta_encode(to_units(x), torch.from_numpy(n).long(), w)
    np.testing.assert_array_equal(from_units(d, w), np.asarray(jd))
    np.testing.assert_array_equal(from_units(first, w), np.asarray(jfirst))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))

    jy, jn = jax.vmap(jdl.delta_decode)(jd, jfirst, jcnt)
    y, ny = dl.delta_decode(d, first, cnt, w)
    np.testing.assert_array_equal(from_units(y, w), np.asarray(jy))
    np.testing.assert_array_equal(ny.numpy(), np.asarray(jn))
    for i, k in enumerate(n):
        np.testing.assert_array_equal(from_units(y, w)[i, :k], x[i, :k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_rle_matches_tpucomp(rng, dtype):
    w = np.dtype(dtype).itemsize
    x, n = _batch(rng, dtype)
    jv, jc, jr = jax.vmap(jrl.rle_encode)(jnp.asarray(x), jnp.asarray(n))
    v, c, r = rl.rle_encode(to_units(x), torch.from_numpy(n).long())
    np.testing.assert_array_equal(from_units(v, w), np.asarray(jv))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc).astype(np.int64))
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))

    jy, jt = jax.vmap(lambda a, b, k: jrl.rle_decode(a, b, k, E))(jv, jc, jr)
    y, t = rl.rle_decode(v, c, r, E)
    np.testing.assert_array_equal(from_units(y, w), np.asarray(jy))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))


def test_rle_decode_unclipped_total_and_corrupt_counts(rng):
    """rle_decode clips the output but returns the unclipped total; zero
    counts and run counts past the buffer behave as in tpucomp."""
    vals = rng.integers(0, 1000, (4, 64)).astype(np.uint32)
    counts = rng.integers(0, 4, (4, 64)).astype(np.uint16)
    counts[1] = 65535
    num_runs = np.array([64, 10, 0, 1000], np.int32)
    jy, jt = jax.vmap(lambda a, b, k: jrl.rle_decode(a, b, k, 64))(
        jnp.asarray(vals), jnp.asarray(counts), jnp.asarray(num_runs))
    y, t = rl.rle_decode(to_units(vals), torch.from_numpy(counts.astype(np.int64)),
                         torch.from_numpy(num_runs).long(), 64)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    assert int(t[1]) == 10 * 65535


@pytest.mark.parametrize("dtype", DTYPES)
def test_bitpack_blobs_match_tpucomp(rng, dtype):
    w = np.dtype(dtype).itemsize
    x, n = _batch(rng, dtype)
    max_words = E * w // 4 + 1
    jblob, jsize = jax.vmap(lambda a, k: jbp.bitpack(a, k, max_words))(jnp.asarray(x), jnp.asarray(n))
    blob, size = bp.bitpack(to_units(x), torch.from_numpy(n).long(), max_words, w)
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jblob))
    np.testing.assert_array_equal(size.numpy(), np.asarray(jsize))
    for i, k in enumerate(n):
        if k:
            assert blob.numpy()[i, : size[i]].tobytes() == bitpack_oracle(x[i, :k])


@pytest.mark.parametrize("dtype", DTYPES)
def test_bitpack_every_bitwidth(rng, dtype):
    """One row per bit width 0..8w, each anchored so its range needs
    exactly that many bits; signed types read the same bits signed."""
    w = np.dtype(dtype).itemsize
    u = _unsigned(dtype)
    rows = []
    for bw in range(8 * w + 1):
        raw = rng.integers(0, 256, size=E * 8, dtype=np.uint8).view(np.uint64)
        if bw < 64:
            raw = raw & np.uint64((1 << bw) - 1)
        xr = raw.astype(u)
        xr[0] = 0
        xr[1] = u.type(((1 << bw) - 1) & ((1 << (8 * w)) - 1)) if bw else 0
        rows.append(xr)
    x = np.stack(rows)
    n = np.full(len(rows), E, np.int32)
    max_words = E * w // 4 + 1
    jblob, jsize = jax.vmap(lambda a, k: jbp.bitpack(a, k, max_words))(jnp.asarray(x), jnp.asarray(n))
    blob, size = bp.bitpack(to_units(x), torch.from_numpy(n).long(), max_words, w)
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jblob))
    np.testing.assert_array_equal(size.numpy(), np.asarray(jsize))
    frame, bw = bp.for_bitwidth(to_units(x), torch.from_numpy(n).long(), w)
    jframe, jbw = jax.vmap(jbp.for_bitwidth)(jnp.asarray(x), jnp.asarray(n))
    np.testing.assert_array_equal(bw.numpy(), np.asarray(jbw))
    np.testing.assert_array_equal(from_units(frame, w), np.asarray(jframe))


def test_for_bitwidth_narrow_dtypes(rng):
    """The shape of tests/test_ops.py::test_for_bitwidth_narrow_dtypes_under_jit
    (2048 elements, n = 2047): min and max on the signed reading, numpy as
    ground truth, equal to tpucomp under jit."""
    for np_dt in (np.uint8, np.uint16, np.uint32):
        w = np.dtype(np_dt).itemsize
        x = rng.integers(0, 2 ** (8 * w), 2048, dtype=np.uint64).astype(np_dt)
        frame, bw = bp.for_bitwidth(to_units(x), torch.tensor(2047), w)
        jf, jb = jax.jit(jbp.for_bitwidth)(jnp.asarray(x), jnp.int32(2047))
        s = x[:2047].view(np.dtype(f"i{w}"))
        rng_v = (int(s.max()) - int(s.min())) & 0xFFFFFFFF
        assert int(bw) == rng_v.bit_length() == int(jb), np_dt
        assert int(frame) == int(s.min()) % 2 ** (8 * w) == int(jf), np_dt
