"""teacher_fwd_ms.moe: Device milliseconds of the KD teacher's forward in a
train() call outside its MoE layers: the union across streams of the
intervals of the kernels launched inside the program's innermost
``teacher_forward`` ranges, each kernel counted once by its launch, in the
one call profiled with the program's ranges.  The teacher's MoE layers
fall in their own ``moe`` ranges (``moe_ms.moe``)."""
from bench.readers import range_ms

LAYER = "dispatch block: core/server.FedRAC.dispatch_rounds"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return range_ms(run, "teacher_forward")
