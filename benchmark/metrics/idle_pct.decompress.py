"""Share of the traced window of back-to-back decompress calls in which no
device operation ran, in %."""


def read(run):
    w = run.windows.get("decompress")
    if w is None or w.busy_s <= 0:
        return None
    return w.idle_pct
