"""``cascaded_wasted_chunk_pct`` in the cell of 4 KB partitions, where it
moves that cell's own rate: 100 x the chunks the encode kernel ran through
its pipeline in partitions that then fell back raw over all the chunks it
ran, in % (``benchmark/metrics/_port_spans.py``)."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.share_pct("cascaded.encode.chunks_discarded", "cascaded.encode.chunks")
