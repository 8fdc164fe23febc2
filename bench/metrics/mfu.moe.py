"""mfu.moe: Model FLOPs of the untraced train() calls of a traced run (no
span timed, nothing fenced) over their seconds and the TF32 peak
(495 TFLOP/s)."""
from bench.readers import mfu

LAYER = "whole step: core/server.FedRAC.train"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "tokens_per_s"


def read(run):
    return mfu(run)
