"""Which warp sets the pace of the LZ4 decode kernel: 100 x the hand-offs
at which its walker warp found the ring to its copier warp full and
waited (``lz4.decode.walker_waits``), over the ring slots the walker
filled (``lz4.decode.handoffs``), counted in the kernel while tracing was
on, in % (``benchmark/metrics/_port_spans.py``).  Near 100: the copies
set the pace; near 0: the walk.  None from a port whose decode kernel
does not count hand-offs."""

from benchmark.metrics import _port_spans as port_spans


def read(run):
    return port_spans.share_pct("lz4.decode.walker_waits", "lz4.decode.handoffs")
