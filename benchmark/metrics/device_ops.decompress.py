"""Device operations (kernels, copies, fills) in one decompress call, counted
in the traced window."""


def read(run):
    w = run.windows.get("decompress")
    if w is None or w.ops == 0:
        return None
    return w.ops / w.calls
