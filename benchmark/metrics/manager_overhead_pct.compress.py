"""Share of a manager compress that the manager layer itself takes: 1 -
(the same chunks through the batch API) / (the manager's call), medians
of calls in turns, each ended by its host read, in %."""


def read(run):
    pair = run.paired_ms("compress")
    if pair is None:
        return None
    manager_ms, codec_ms = pair
    return 100.0 * (1.0 - codec_ms / manager_ms)
