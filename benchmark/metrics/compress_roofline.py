"""`<codec>_compress_roofline`: the least time a compress could take (every
byte it must read and write moved once at the H100's 3.35 TB/s) over the
device busy time of one compress in the traced window, in %."""

from benchmark import stats


def read(run):
    w = run.windows.get("compress")
    if w is None or w.busy_s <= 0:
        return None
    return 100.0 * stats.roofline_s(*run.entry.io_bytes("compress")) / (w.busy_s / w.calls)
