"""Validate observability artifacts (the CI metrics-smoke gate).

Checks, in order:

1. **metrics JSONL schema** — every line is a JSON object with a known
   ``kind`` (counter/gauge/histogram/table/row) and the per-kind required
   fields; every ``row`` names a previously declared table and carries
   exactly that table's columns.
2. **trace schema + coverage** — the trace file is loadable Chrome-trace
   JSON and (when ``--coverage-root`` is given) the union of spans nested
   inside the root covers at least ``--min-coverage`` of its duration.
3. **summary parity** (``--report report.json``) — per-round bytes /
   violations / banked / flushed / dropped totals recomputed from the
   JSONL table rows reproduce ``SimReport.summary()`` exactly.

Exit 0 on success; prints the first failure and exits 1 otherwise.

Usage::

    python -m repro_torch.obs.validate --metrics metrics.jsonl \
        --trace trace.json --coverage-root sim.run \
        --report report.json
"""
from __future__ import annotations

import argparse
import json
import sys

from .trace import span_coverage

_SCALAR_KINDS = {"counter", "gauge", "histogram"}


def validate_metrics_jsonl(path) -> dict:
    """Parse + schema-check a metrics JSONL file.

    Returns ``{"lines": n, "counters": {...}, "gauges": {...},
    "tables": {name: [row, ...]}, "dropped": {name: n}}``.
    """
    counters, gauges, tables, dropped = {}, {}, {}, {}
    schemas = {}
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            n += 1
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from None
            if not isinstance(rec, dict) or "kind" not in rec:
                raise ValueError(f"{path}:{lineno}: missing 'kind'")
            kind = rec["kind"]
            if kind in _SCALAR_KINDS:
                if "name" not in rec:
                    raise ValueError(f"{path}:{lineno}: {kind} without name")
                if kind == "counter":
                    counters[rec["name"]] = rec["value"]
                elif kind == "gauge":
                    gauges[rec["name"]] = rec["value"]
            elif kind == "table":
                schemas[rec["name"]] = set(rec["columns"])
                tables.setdefault(rec["name"], [])
                dropped[rec["name"]] = int(rec.get("dropped", 0))
            elif kind == "row":
                t = rec.get("table")
                if t not in schemas:
                    raise ValueError(
                        f"{path}:{lineno}: row for undeclared table {t!r}")
                got = set(rec) - {"kind", "table"}
                if got != schemas[t]:
                    raise ValueError(
                        f"{path}:{lineno}: row columns {sorted(got)} != "
                        f"declared {sorted(schemas[t])}")
                tables[t].append(rec)
            else:
                raise ValueError(f"{path}:{lineno}: unknown kind {kind!r}")
    return {"lines": n, "counters": counters, "gauges": gauges,
            "tables": tables, "dropped": dropped}


def validate_trace(path, *, coverage_root=None, min_coverage=0.95) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    for i, e in enumerate(events):
        if not isinstance(e, dict) or "ph" not in e or "name" not in e:
            raise ValueError(f"{path}: event {i} missing ph/name")
        if e["ph"] == "X" and ("ts" not in e or "dur" not in e):
            raise ValueError(f"{path}: span {e['name']!r} missing ts/dur")
    out = {"events": len(events)}
    if coverage_root is not None:
        cov = span_coverage(events, coverage_root)
        out["coverage"] = cov
        if cov < min_coverage:
            raise ValueError(
                f"{path}: spans cover {cov:.1%} of {coverage_root!r}, "
                f"need >= {min_coverage:.0%}")
    return out


def check_summary_parity(metrics: dict, report_path) -> dict:
    """Totals recomputed from the JSONL cluster-round rows must reproduce
    the engine's ``SimReport.summary()`` exactly (same floats: the export
    round-trips float64 through repr)."""
    with open(report_path) as f:
        summary = json.load(f)
    if "summary" in summary:            # allow a full to_dict() report file
        summary = summary["summary"]
    rows = metrics["tables"].get("sim/cluster_rounds")
    if rows is None:
        raise ValueError("metrics JSONL has no sim/cluster_rounds table")
    if metrics["dropped"].get("sim/cluster_rounds"):
        raise ValueError("sim/cluster_rounds ring wrapped; totals would be "
                         "partial — raise the table max_rows for this run")
    totals = {
        "total_bytes": sum(r["bytes"] for r in rows),
        "mar_violations": sum(r["violations"] for r in rows),
        "banked_total": sum(r["banked"] for r in rows),
        "flushed_total": sum(r["flushed"] for r in rows),
        "dropped_total": sum(r["dropped"] for r in rows),
    }
    for k, v in totals.items():
        if k not in summary:
            raise ValueError(f"report summary missing {k!r}")
        if summary[k] != v:
            raise ValueError(
                f"parity mismatch on {k}: metrics={v!r} report={summary[k]!r}")
    return totals


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.validate",
        description="Validate metrics JSONL / trace JSON artifacts")
    ap.add_argument("--metrics", help="metrics JSONL path")
    ap.add_argument("--trace", help="Chrome-trace JSON path")
    ap.add_argument("--coverage-root", default=None,
                    help="span name whose children must cover the run "
                         "(e.g. sim.run)")
    ap.add_argument("--min-coverage", type=float, default=0.95)
    ap.add_argument("--report", default=None,
                    help="SimReport summary/to_dict JSON to check parity "
                         "against (requires --metrics)")
    args = ap.parse_args(argv)
    if not args.metrics and not args.trace:
        ap.error("nothing to validate: pass --metrics and/or --trace")
    try:
        if args.metrics:
            m = validate_metrics_jsonl(args.metrics)
            print(f"metrics ok: {m['lines']} lines, "
                  f"{len(m['counters'])} counters, "
                  f"{len(m['tables'])} tables")
            if args.report:
                totals = check_summary_parity(m, args.report)
                print("summary parity ok: " +
                      ", ".join(f"{k}={v}" for k, v in totals.items()))
        if args.trace:
            t = validate_trace(args.trace, coverage_root=args.coverage_root,
                               min_coverage=args.min_coverage)
            cov = (f", coverage {t['coverage']:.1%}"
                   if "coverage" in t else "")
            print(f"trace ok: {t['events']} events{cov}")
    except (ValueError, OSError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
