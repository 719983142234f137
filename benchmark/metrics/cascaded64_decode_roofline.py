"""The 64-bit Cascaded decode kernel's share of its roofline: the least
time a decompress could take over the device time of
``cascaded_decode_kernel<unsigned long long>`` a call, in %
(``_kernel_roofline.py``); None where no 64-bit decode ran."""

from benchmark.metrics import _kernel_roofline


def read(run):
    return _kernel_roofline.read(run, "decompress", "cascaded_decode_kernel", "unsigned long long")
