"""init_draw_ms.moe: Milliseconds a train() call spends drawing each
level's initial parameters on the host (the program's
``init_params.draw`` spans, the part of ``init_params_ms`` before the
copy to the card)."""
from bench.port_spans import per_call_ms

LAYER = "engine host: core/server.FedRAC.init_params"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return per_call_ms(run, "init_params.draw")
