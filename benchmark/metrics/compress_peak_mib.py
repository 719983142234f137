"""Device memory one compress allocates at its peak above what was
allocated before it, read on one call before the window: the scratch a
caller must leave free beside its data, in MiB."""


def read(run):
    if run.compress_peak_bytes is None:
        return None  # off the card
    return run.compress_peak_bytes / 2**20
