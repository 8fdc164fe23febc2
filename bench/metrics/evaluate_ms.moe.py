"""evaluate_ms.moe: Milliseconds a train() call spends in the per-round
evaluations (the benchmark's span)."""
from bench.readers import span_ms

LAYER = "evaluation: core/server.FedRAC.evaluate"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "tokens_per_s"


def read(run):
    return span_ms(run, "evaluate")
