"""Low-overhead metrics registry: counters, gauges, histograms, and
struct-of-arrays ring-buffer tables with numpy columnar export.

This is the engine's telemetry sink.  ``SimReport`` keeps its public API but
derives its numeric ``summary()`` from the registry's columnar tables
instead of Python-object iteration, so per-participant/round metrics scale
past per-event list appends (the ROADMAP item-1 fleet-simulator blocker).

Design constraints:

* **Append cost is O(1) numpy scalar stores** — a ``Table`` preallocates one
  numpy column per field, doubles capacity up to ``max_rows``, then wraps as
  a ring (overwritten rows are COUNTED in ``dropped`` and surfaced in every
  export — no silent truncation).
* **Host only** — numpy, no torch: the registry is importable from
  host-only tooling (validators, benchmark harnesses) without a device.
* **Exact export** — ``to_jsonl`` writes float64 values through Python's
  ``repr`` round-trip, so sums recomputed from the JSONL reproduce sums over
  the live columns bit-exactly (the summary-parity contract the CI smoke
  step checks).
"""
from __future__ import annotations

import json
import math

import numpy as np

# default histogram bounds: exponential decades covering µs..hours (seconds)
# and bytes..GBs equally well
_DEFAULT_BOUNDS = tuple(10.0 ** e for e in range(-7, 11))


class Counter:
    """Monotone float counter."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-value-wins float gauge (NaN until first set)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bound histogram: per-bucket counts plus count/sum/min/max."""
    __slots__ = ("bounds", "buckets", "count", "total", "min", "max")

    def __init__(self, bounds=_DEFAULT_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        self.buckets = np.zeros(len(self.bounds) + 1, np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.buckets[int(np.searchsorted(self.bounds, v, side="left"))] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": [[("inf" if i == len(self.bounds)
                              else self.bounds[i]), int(n)]
                            for i, n in enumerate(self.buckets.tolist())
                            if n]}


class Table:
    """Struct-of-arrays ring buffer: one preallocated numpy column per
    field.  Appends are scalar stores; reads return columnar numpy views in
    insertion order (oldest retained row first).  Beyond ``max_rows`` the
    buffer wraps and ``dropped`` counts the overwritten rows."""

    def __init__(self, name: str, columns: dict, *, capacity: int = 256,
                 max_rows: int = 1 << 20, defaults: dict | None = None):
        self.name = name
        self._defaults = dict(defaults or {})
        cap = max(1, min(capacity, max_rows))
        self._cols = {c: np.zeros(cap, dt) for c, dt in columns.items()}
        self._cap = cap
        self._max = max(1, max_rows)
        self._n = 0               # total rows ever appended (monotone)
        self.dropped = 0          # rows overwritten after the ring wrapped

    def __len__(self) -> int:
        return min(self._n, self._cap)

    @property
    def columns(self) -> tuple:
        return tuple(self._cols)

    def append(self, **vals) -> None:
        i = self._n
        if i >= self._cap and self._cap < self._max:
            new_cap = min(self._cap * 2, self._max)
            self._cols = {c: np.concatenate(
                [col, np.zeros(new_cap - self._cap, col.dtype)])
                for c, col in self._cols.items()}
            self._cap = new_cap
        slot = i % self._cap
        if i >= self._cap:
            self.dropped += 1
        dflt = self._defaults
        for c, col in self._cols.items():
            col[slot] = vals.get(c, dflt.get(c, 0))
        self._n = i + 1

    def column(self, name: str) -> np.ndarray:
        """One column, insertion-ordered (oldest retained first)."""
        col, n = self._cols[name], self._n
        if n <= self._cap:
            return col[:n]
        s = n % self._cap
        return np.concatenate([col[s:], col[:s]])

    def rows(self):
        cols = {c: self.column(c) for c in self._cols}
        for i in range(len(self)):
            yield {c: v[i].item() for c, v in cols.items()}

    def reset(self) -> None:
        """Drop all retained rows (capacity is kept).  Used by owners whose
        lifetime is one run (e.g. ``SimReport``) when they re-claim a table
        from a shared registry, so exports never mix two runs' rows."""
        self._n = 0
        self.dropped = 0

    def state(self) -> tuple[dict, dict]:
        """(JSON-safe meta, {column: ndarray}) snapshot — the retained rows
        in insertion order plus the ring counters, so ``load_state`` restores
        ``column()``/``dropped``/``_n`` bit-exactly."""
        meta = {"n": int(self._n), "cap": int(self._cap),
                "max": int(self._max), "dropped": int(self.dropped)}
        return meta, {c: self.column(c).copy() for c in self._cols}

    def load_state(self, meta: dict, columns: dict) -> None:
        """Inverse of ``state``: rebuilds the ring in place (object identity
        is preserved — holders like ``SimReport`` keep their reference)."""
        self._cap = int(meta["cap"])
        self._max = int(meta["max"])
        self._n = int(meta["n"])
        self.dropped = int(meta["dropped"])
        length = min(self._n, self._cap)
        cols = {}
        for c, arr in columns.items():
            col = np.zeros(self._cap, arr.dtype)
            if length:
                # i-th oldest retained row lives at slot (n - length + i)
                idx = (np.arange(length) + self._n - length) % self._cap
                col[idx] = arr[:length]
            cols[c] = col
        self._cols = cols

    def bump_last(self, col: str, delta, match: dict | None = None) -> bool:
        """In-place add ``delta`` to ``col`` of the newest retained row
        matching ``match`` (column -> value); returns False when no row
        matches.  The post-run edit hook (terminal bank flushes land in the
        final round's already-appended row)."""
        n = len(self)
        for back in range(1, n + 1):
            slot = (self._n - back) % self._cap
            if all(self._cols[c][slot] == v for c, v in (match or {}).items()):
                self._cols[col][slot] += delta
                return True
        return False


class MetricsRegistry:
    """Get-or-create namespace of counters, gauges, histograms and tables."""

    def __init__(self):
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}
        self.tables: dict[str, Table] = {}

    # ------------------------------------------------------------ factories
    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str, bounds=_DEFAULT_BOUNDS) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds)
        return h

    def table(self, name: str, columns: dict | None = None, **kw) -> Table:
        t = self.tables.get(name)
        if t is None:
            if columns is None:
                raise KeyError(f"table {name!r} does not exist yet and no "
                               "column schema was given")
            t = self.tables[name] = Table(name, columns, **kw)
        return t

    # ------------------------------------------------------------ checkpoint
    def state(self) -> tuple[dict, dict]:
        """(meta, arrays) for the whole registry: counters/gauges/histogram
        scalars in ``meta`` (non-finite floats survive — this feeds our own
        JSON reader, not strict exporters), bucket counts and table columns
        in ``arrays`` under ``hist/<name>/buckets`` and
        ``table/<name>/<column>`` keys."""
        meta = {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: {"bounds": list(h.bounds), "count": h.count,
                               "total": h.total, "min": h.min, "max": h.max}
                           for k, h in sorted(self.histograms.items())},
            "tables": {},
        }
        arrays = {}
        for k, h in sorted(self.histograms.items()):
            arrays[f"hist/{k}/buckets"] = h.buckets.copy()
        for k, t in sorted(self.tables.items()):
            t_meta, t_cols = t.state()
            t_meta["columns"] = list(t.columns)
            meta["tables"][k] = t_meta
            for c, arr in t_cols.items():
                arrays[f"table/{k}/{c}"] = arr
        return meta, arrays

    def load_state(self, meta: dict, arrays: dict) -> None:
        """Inverse of ``state``.  Existing metric objects are updated in
        place (shared holders keep their references); missing ones are
        created.  Restored compile/transfer counters keep counting from the
        checkpointed totals — a resumed process recompiles, so those exceed
        an uninterrupted run's; the per-round *tables* are what resume
        bit-exactly."""
        for k, v in meta.get("counters", {}).items():
            self.counter(k).value = float(v)
        for k, v in meta.get("gauges", {}).items():
            self.gauge(k).value = float(v)
        for k, hm in meta.get("histograms", {}).items():
            h = self.histogram(k, bounds=tuple(hm["bounds"]))
            h.bounds = tuple(float(b) for b in hm["bounds"])
            h.buckets = np.asarray(arrays[f"hist/{k}/buckets"],
                                   np.int64).copy()
            h.count = int(hm["count"])
            h.total = float(hm["total"])
            h.min = float(hm["min"])
            h.max = float(hm["max"])
        for k, tm in meta.get("tables", {}).items():
            cols = {c: arrays[f"table/{k}/{c}"] for c in tm["columns"]}
            t = self.tables.get(k)
            if t is None:
                t = self.tables[k] = Table(
                    k, {c: arr.dtype for c, arr in cols.items()})
            t.load_state(tm, cols)

    # ------------------------------------------------------------ export
    def snapshot(self) -> dict:
        """JSON-ready point-in-time view (the serve.py /metrics payload)."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
            "tables": {k: {"rows": len(t), "dropped": t.dropped,
                           "columns": list(t.columns)}
                       for k, t in sorted(self.tables.items())},
        }

    def render_text(self) -> str:
        """Prometheus-style text exposition of the scalar metrics."""
        lines = []
        for k, c in sorted(self.counters.items()):
            lines.append(f"# TYPE {_prom_name(k)} counter")
            lines.append(f"{_prom_name(k)} {c.value:.17g}")
        for k, g in sorted(self.gauges.items()):
            lines.append(f"# TYPE {_prom_name(k)} gauge")
            lines.append(f"{_prom_name(k)} {g.value:.17g}")
        for k, h in sorted(self.histograms.items()):
            n = _prom_name(k)
            lines.append(f"# TYPE {n} histogram")
            cum = 0
            for le, cnt in h.summary()["buckets"]:
                cum += cnt
                le_txt = "+Inf" if le == "inf" else f"{le:g}"
                lines.append(f'{n}_bucket{{le="{le_txt}"}} {cum}')
            lines.append(f"{n}_sum {h.total:.17g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"

    def to_jsonl(self, path) -> int:
        """Write the whole registry as JSON Lines; returns the line count.

        Line kinds: ``counter`` / ``gauge`` / ``histogram`` scalar records,
        one ``row`` record per retained table row (with its table name), and
        a ``table`` meta record per table (schema + dropped-row count, so a
        wrapped ring is never mistaken for full history)."""
        n = 0
        with open(path, "w") as f:
            for k, c in sorted(self.counters.items()):
                f.write(json.dumps({"kind": "counter", "name": k,
                                    "value": c.value}) + "\n")
                n += 1
            for k, g in sorted(self.gauges.items()):
                f.write(json.dumps({"kind": "gauge", "name": k,
                                    "value": _json_float(g.value)}) + "\n")
                n += 1
            for k, h in sorted(self.histograms.items()):
                f.write(json.dumps({"kind": "histogram", "name": k,
                                    **h.summary()}) + "\n")
                n += 1
            for k, t in sorted(self.tables.items()):
                f.write(json.dumps({"kind": "table", "name": k,
                                    "columns": list(t.columns),
                                    "rows": len(t),
                                    "dropped": t.dropped}) + "\n")
                n += 1
                for row in t.rows():
                    f.write(json.dumps(
                        {"kind": "row", "table": k,
                         **{c: _json_float(v) for c, v in row.items()}})
                        + "\n")
                    n += 1
        return n


def _prom_name(name: str) -> str:
    out = "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in name)
    return out if not out[:1].isdigit() else "_" + out


def _json_float(v):
    """JSON has no NaN/inf literals; export them as null (validators treat
    null as 'not measured')."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v
