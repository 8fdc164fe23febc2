"""flash_roofline.moe: The flash forward kernel's share of its bound at the
calls' shapes: q, k, v and o once at 3.35 TB/s against the unmasked
pairs at 495 TFLOP/s, the larger."""
from bench.readers import flash_roofline

LAYER = "kernel: kernels/flash"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return flash_roofline(run)
