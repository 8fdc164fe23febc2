"""dispatch_host_ms.moe: Mean milliseconds of the host's work before a
dispatch block is enqueued: the shard-pack lookup, the index draws and the
copies of masks, weights and indices (the program's ``dispatch.prepare``
span)."""
from bench.readers import port_span_ms

LAYER = "dispatch block: core/server.FedRAC.dispatch_rounds"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return port_span_ms(run, "dispatch.prepare")
