"""How often the match-table kernel's costly path engages: 100 x the valid
positions it grouped into buckets of more than 32, which it sorts
(``lz.table.large_bucket_positions``), over all the positions it grouped
(``lz.table.positions``), counted in the kernel while tracing was on, in %
(``benchmark/metrics/_port_spans.py``).  None from a port whose table
kernel does not count."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.share_pct("lz.table.large_bucket_positions", "lz.table.positions")
