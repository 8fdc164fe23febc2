"""fedagg_roofline.moe: The fedagg kernel's share of its bound at the calls'
(capacity, D_pad) shapes: each input and output byte once at 3.35 TB/s."""
from bench.readers import fedagg_roofline

LAYER = "kernel: kernels/fedagg"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return fedagg_roofline(run)
