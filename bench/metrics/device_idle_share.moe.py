"""device_idle_share.moe: Percent of the traced window in which no kernel,
copy or set ran on the card."""
from bench.readers import idle_share

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "tokens_per_s"


def read(run):
    return idle_share(run)
