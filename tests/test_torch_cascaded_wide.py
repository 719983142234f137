"""The port's Cascaded codec held to tpucomp over the rest of the option
space (the largest chunk, seven layers, unaligned rows, signed data) and
random cases, with randomly damaged streams (exact equality)."""

import numpy as np
import pytest

import torch_cases
from torch_reference import (assert_decode_equal, capacity, jax_compress, jax_decompress,
                             port_compress, port_decompress)

WIDE = torch_cases.wide_cases() + torch_cases.fuzz_cases(7, 3)


@pytest.mark.parametrize("label,fields,arr,lens", WIDE, ids=[c[0] for c in WIDE])
def test_wide_options_and_damaged_streams_identical(label, fields, arr, lens):
    """The rest of the option space and random cases; each stream also
    decodes identically after random byte flips and size changes."""
    ref_comp, ref_sizes = jax_compress(fields, arr, lens)
    comp, sizes = port_compress(fields, arr, lens)
    np.testing.assert_array_equal(sizes, ref_sizes)
    np.testing.assert_array_equal(comp, ref_comp)
    cap = capacity(fields, arr)
    damaged = torch_cases.damage(np.random.default_rng(5), comp, sizes)
    for rows, szs in ((comp, sizes), damaged):
        assert_decode_equal(port_decompress(fields, rows, szs, cap),
                            jax_decompress(fields, rows, szs, cap), label)
