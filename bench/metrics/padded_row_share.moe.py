"""padded_row_share.moe: Percent of the member rows the dispatch blocks
ran that were padding up to the capacity (the program's ``block_exec``
span's args ``members``, ``capacity`` and ``R``)."""
from bench.port_spans import padded_row_share

LAYER = "dispatch block: core/server.FedRAC.dispatch_rounds"
UNIT = "%"
SOURCE = "program_span"
MOVES = "tokens_per_s"


def read(run):
    return padded_row_share(run)
