"""Arithmetic of the per-layer readers over the program's own spans
(``run.port_events``: the program tracer's events in the calls that time
spans).  A reader returns None when the program records no such span, as
a program without these spans does not."""
from __future__ import annotations


def per_call_ms(run, name: str):
    """Milliseconds a ``train()`` call spends in the program's spans
    ``name``: their total over the calls that timed spans."""
    durs = [e["dur"] for e in run.port_events if e["name"] == name]
    if not durs or not run.calls:
        return None
    return sum(durs) / len(run.calls) / 1e3


def padded_row_share(run):
    """Percent of the member rows the dispatch blocks ran that were
    padding: Σ (capacity − members) · R over Σ capacity · R, from the
    ``block_exec`` spans' args."""
    blocks = [e.get("args", {}) for e in run.port_events
              if e["name"] == "block_exec"]
    blocks = [a for a in blocks if "members" in a]
    rows = sum(a["capacity"] * a["R"] for a in blocks)
    if not rows:
        return None
    pad = sum((a["capacity"] - a["members"]) * a["R"] for a in blocks)
    return 100.0 * pad / rows
