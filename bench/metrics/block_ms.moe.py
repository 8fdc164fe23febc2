"""block_ms.moe: Mean milliseconds of a dispatch block: the program's fenced
``block_exec`` span."""
from bench.readers import port_span_ms

LAYER = "dispatch block: core/server.FedRAC.dispatch_rounds"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return port_span_ms(run, "block_exec")
