"""moe_ms.moe: Device milliseconds of the MoE layers in a train() call:
the kernels launched inside the program's innermost ``moe`` ranges
(``models/moe.apply_moe``: routing, the sort, the grouped GEMMs and the
combine of every forward, the member steps', the teacher's and the
evaluations') and ``moe_bwd`` ranges (the grouped products' backward),
each range's union across streams, summed, in the one call profiled with
the program's ranges.  None where neither range launched a kernel."""
from bench.readers import range_ms

LAYER = "model: models/moe.apply_moe"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    parts = [range_ms(run, n) for n in ("moe", "moe_bwd")]
    parts = [p for p in parts if p is not None]
    return sum(parts) if parts else None
