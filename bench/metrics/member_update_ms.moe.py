"""member_update_ms.moe: Device milliseconds of the members' local updates
in a train() call outside their MoE layers: the union across streams of
the intervals of the kernels launched inside the program's innermost
``member_update`` ranges, each kernel counted once by its launch, in the
one call profiled with the program's ranges.  The MoE layers' kernels
fall in their own ``moe`` and ``moe_bwd`` ranges (``moe_ms.moe``)."""
from bench.readers import range_ms

LAYER = "dispatch block: core/server.FedRAC.dispatch_rounds"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return range_ms(run, "member_update")
