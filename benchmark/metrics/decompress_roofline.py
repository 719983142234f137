"""`<codec>_decompress_roofline`: the least time a decompress could take (every
byte it must read and write moved once at the H100's 3.35 TB/s) over the
device busy time of one decompress in the traced window, in %."""

from benchmark import stats


def read(run):
    w = run.windows.get("decompress")
    if w is None or w.busy_s <= 0:
        return None
    return 100.0 * stats.roofline_s(*run.entry.io_bytes("decompress")) / (w.busy_s / w.calls)
