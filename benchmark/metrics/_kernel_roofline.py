"""A kernel's share of its roofline: the least time a call could take
(every byte it must read and write moved once at the H100's 3.35 TB/s,
``stats.roofline_s`` of the entry's ``io_bytes``) over the device time of
one instantiation of the kernel a call in the phase's traced window
(``Window.op_s``), in %.  The instantiation is matched by the start of its
template arguments in the name the profiler records
(``cascaded_encode_kernel<unsigned long long, false>(...)``), so the
whole-call ``<codec>_<phase>_roofline``'s other operations (the copy of
the sizes) and the other instantiations are left out."""

from __future__ import annotations

from benchmark import stats


def read(run, phase: str, kernel: str, template: str) -> float | None:
    """None where the window ran no such instantiation."""
    w = run.windows.get(phase)
    if w is None or not w.calls:
        return None
    kernel_s = sum(v for k, v in w.op_s.items() if f"{kernel}<{template}" in k)
    if kernel_s <= 0:
        return None
    return 100.0 * stats.roofline_s(*run.entry.io_bytes(phase)) / (kernel_s / w.calls)
