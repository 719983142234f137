"""How often the match-table kernel's costly path engages under Snappy's
limits (a 32768-byte window, the last candidate at n - 4): 100 x the valid
positions it grouped into buckets of more than 32, which it sorts
(``lz.table.large_bucket_positions``), over all the positions it grouped
(``lz.table.positions``), counted in the kernel while tracing was on, in %.
The counters are ``lz_table_large_bucket_pct``'s, which moves LZ4's rate."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.share_pct("lz.table.large_bucket_positions", "lz.table.positions")
