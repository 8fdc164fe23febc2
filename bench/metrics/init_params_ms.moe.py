"""init_params_ms.moe: Milliseconds a train() call spends drawing each
level's initial parameters on the host and copying them to the card (the
benchmark's span, ending in a synchronize)."""
from bench.readers import span_ms

LAYER = "engine host: core/server.FedRAC.init_params"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "tokens_per_s"


def read(run):
    return span_ms(run, "init_params")
