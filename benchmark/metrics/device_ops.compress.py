"""Device operations (kernels, copies, fills) in one compress call, counted
in the traced window."""


def read(run):
    w = run.windows.get("compress")
    if w is None or w.ops == 0:
        return None
    return w.ops / w.calls
