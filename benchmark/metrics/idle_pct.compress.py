"""Share of the traced window of back-to-back compress calls in which no
device operation ran, in %."""


def read(run):
    w = run.windows.get("compress")
    if w is None or w.busy_s <= 0:
        return None
    return w.idle_pct
