"""The 64-bit Cascaded encode kernel's share of its roofline: the least
time a compress could take over the device time of
``cascaded_encode_kernel<unsigned long long, ...>`` a call, in %
(``_kernel_roofline.py``); None where no 64-bit encode ran."""

from benchmark.metrics import _kernel_roofline


def read(run):
    return _kernel_roofline.read(run, "compress", "cascaded_encode_kernel", "unsigned long long")
