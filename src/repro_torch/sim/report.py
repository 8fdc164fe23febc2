"""Per-round telemetry for the heterogeneity simulator.

One ``RoundRecord`` per communication round, holding per-cluster
``ClusterRoundStats``; ``SimReport`` aggregates the timeline, renders it as
text (the CLI/example output) and summarizes totals.

``SimReport`` is now a thin view over the obs metrics registry: ``add()``
appends one columnar row per cluster-round to the ``sim/cluster_rounds``
table (struct-of-arrays ring buffer) and one per round to ``sim/rounds``,
and ``summary()`` derives its numeric totals from those columns rather than
iterating Python objects — the registry is the sink that scales to fleet
sizes, the dataclasses remain for text/timeline rendering and per-pid sets.
Passing an ``Observability`` bundle shares the registry with the engine so
``--metrics-out`` exports reproduce ``summary()`` exactly.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field

from ..obs import MetricsRegistry

_CLUSTER_COLS = {
    "round": "int64", "level": "int64", "time": "float64",
    "bytes": "float64", "active": "int64", "masked": "int64",
    "dropped": "int64", "offline": "int64", "banked": "int64",
    "unselected": "int64", "violations": "int64", "flushed": "int64",
    "mean_loss": "float64", "acc": "float64",
}
_ROUND_COLS = {"round": "int64", "t_start": "float64",
               "duration": "float64", "events": "int64"}


@dataclass
class ClusterRoundStats:
    level: int
    time: float                    # cluster round duration (s)
    active: list = field(default_factory=list)     # pids that contributed
    dropped: list = field(default_factory=list)    # MAR-dropped this round
    offline: list = field(default_factory=list)    # not online this round
    masked: dict = field(default_factory=dict)     # pid -> steps granted (<S)
    violations: list = field(default_factory=list)  # pids with T_i > MAR
    banked: list = field(default_factory=list)     # late updates buffered
    unselected: list = field(default_factory=list)  # FedCS left out this round
    flushed: int = 0                               # stale updates merged
    bytes: float = 0.0
    mean_loss: float = float("nan")
    acc: float | None = None

    @property
    def participating(self) -> set:
        """Pids that contributed an update this round: fully active ones
        plus masked members (partial ⌊S·(MAR−T_c)/T_a⌋-step updates still
        reach the aggregate, whether or not the engine also listed them in
        ``active``)."""
        return set(self.active) | set(self.masked)


def encode_stats(c: "ClusterRoundStats") -> dict:
    """JSON-safe form of one ``ClusterRoundStats``.  ``masked`` is flattened
    to ``[pid, granted]`` pairs — JSON object keys are strings, so a plain
    ``asdict`` would silently stringify the pids."""
    return {
        "level": c.level, "time": c.time,
        "active": list(c.active), "dropped": list(c.dropped),
        "offline": list(c.offline),
        "masked": [[int(p), int(g)] for p, g in c.masked.items()],
        "violations": list(c.violations), "banked": list(c.banked),
        "unselected": list(c.unselected), "flushed": c.flushed,
        "bytes": c.bytes, "mean_loss": c.mean_loss, "acc": c.acc,
    }


def decode_stats(c: dict) -> "ClusterRoundStats":
    """Inverse of ``encode_stats``."""
    return ClusterRoundStats(
        level=int(c["level"]), time=float(c["time"]),
        active=[int(p) for p in c["active"]],
        dropped=[int(p) for p in c["dropped"]],
        offline=[int(p) for p in c["offline"]],
        masked={int(p): int(g) for p, g in c["masked"]},
        violations=[int(p) for p in c["violations"]],
        banked=[int(p) for p in c["banked"]],
        unselected=[int(p) for p in c["unselected"]],
        flushed=int(c["flushed"]), bytes=float(c["bytes"]),
        mean_loss=float(c["mean_loss"]),
        acc=None if c["acc"] is None else float(c["acc"]))


def encode_rows(rows: list) -> list:
    """JSON-safe form of ``[RoundRecord]`` for run-state checkpoints."""
    out = []
    for r in rows:
        out.append({
            "round": r.round, "t_start": r.t_start, "duration": r.duration,
            "events": list(r.events),
            "clusters": [encode_stats(c) for c in r.clusters],
        })
    return out


def decode_rows(data: list) -> list:
    """Inverse of ``encode_rows``."""
    rows = []
    for r in data:
        rows.append(RoundRecord(round=int(r["round"]),
                                t_start=float(r["t_start"]),
                                duration=float(r["duration"]),
                                clusters=[decode_stats(c)
                                          for c in r["clusters"]],
                                events=[str(e) for e in r["events"]]))
    return rows


@dataclass
class RoundRecord:
    round: int
    t_start: float
    duration: float                # schedule-combined round time (s)
    clusters: list = field(default_factory=list)   # [ClusterRoundStats]
    events: list = field(default_factory=list)     # human-readable strings

    @property
    def t_end(self) -> float:
        return self.t_start + self.duration

    @property
    def dropped(self) -> list:
        return [p for c in self.clusters for p in c.dropped]

    @property
    def violations(self) -> list:
        return [p for c in self.clusters for p in c.violations]

    @property
    def bytes(self) -> float:
        return sum(c.bytes for c in self.clusters)


@dataclass
class SimReport:
    scenario: str
    mar_policy: str
    schedule: str
    rows: list = field(default_factory=list)       # [RoundRecord]
    final_acc: dict = field(default_factory=dict)  # level -> accuracy
    obs: object = None             # Observability bundle (shared registry)

    def __post_init__(self):
        reg = self.obs.registry if self.obs is not None else MetricsRegistry()
        self._registry = reg
        self._t_clusters = reg.table("sim/cluster_rounds", _CLUSTER_COLS,
                                     defaults={"acc": math.nan,
                                               "mean_loss": math.nan})
        self._t_rounds = reg.table("sim/rounds", _ROUND_COLS)
        # a report's lifetime is one run: never mix rows from a prior run
        # that shared the same registry
        self._t_clusters.reset()
        self._t_rounds.reset()

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry

    def add(self, row: RoundRecord) -> None:
        self.rows.append(row)
        self._t_rounds.append(round=row.round, t_start=row.t_start,
                              duration=row.duration, events=len(row.events))
        for c in row.clusters:
            self._t_clusters.append(
                round=row.round, level=c.level, time=c.time, bytes=c.bytes,
                active=len(c.participating), masked=len(c.masked),
                dropped=len(c.dropped), offline=len(c.offline),
                banked=len(c.banked), unselected=len(c.unselected),
                violations=len(c.violations),
                flushed=c.flushed, mean_loss=c.mean_loss,
                acc=math.nan if c.acc is None else c.acc)

    def bump_flushed(self, level: int, delta: int) -> None:
        """Credit ``delta`` terminal bank flushes to the newest recorded
        round for ``level`` — in both the dataclass view and the registry
        table, keeping summary/export parity."""
        if not self.rows:
            return
        for c in self.rows[-1].clusters:
            if c.level == level:
                c.flushed += delta
                break
        self._t_clusters.bump_last(
            "flushed", delta,
            match={"round": self.rows[-1].round, "level": level})

    # ------------------------------------------------------------ summaries
    def summary(self) -> dict:
        n_parts = {p for r in self.rows for c in r.clusters
                   for p in (list(c.participating) + c.dropped
                             + c.offline + c.banked + c.unselected)}
        t = self._t_clusters
        col = t.column
        # Python sum over .tolist() keeps the sequential summation order the
        # JSONL validator uses, so recomputed totals match bit-exactly.
        active = int(sum(col("active").tolist()))
        banked = int(sum(col("banked").tolist()))
        total_slots = (active + banked + int(sum(col("dropped").tolist()))
                       + int(sum(col("offline").tolist()))
                       + int(sum(col("unselected").tolist())))
        # banked members participate — their (late) update reaches the next
        # round's aggregate
        active_slots = active + banked
        return {
            "scenario": self.scenario,
            "mar_policy": self.mar_policy,
            "schedule": self.schedule,
            "rounds": len(self._t_rounds),
            "wall_clock_s": round(
                float(sum(self._t_rounds.column("duration").tolist())), 3),
            "total_bytes": float(sum(col("bytes").tolist())),
            "participants": len(n_parts),
            "participation_rate": round(active_slots / total_slots, 4)
                                  if total_slots else 0.0,
            "mar_violations": int(sum(col("violations").tolist())),
            "dropped_total": int(sum(col("dropped").tolist())),
            "unselected_total": int(sum(col("unselected").tolist())),
            "banked_total": banked,
            "flushed_total": int(sum(col("flushed").tolist())),
            "final_acc": {k: round(v, 4) for k, v in self.final_acc.items()},
        }

    def timeline(self) -> str:
        lines = [f"# scenario={self.scenario} policy={self.mar_policy} "
                 f"schedule={self.schedule}"]
        for r in self.rows:
            cl = []
            for c in r.clusters:
                bits = f"C{c.level + 1} {len(c.active)}a"
                if c.dropped:
                    bits += f" {len(c.dropped)}drop"
                if c.masked:
                    bits += f" {len(c.masked)}mask"
                if c.banked:
                    bits += f" {len(c.banked)}bank"
                if c.unselected:
                    bits += f" {len(c.unselected)}unsel"
                if c.flushed:
                    bits += f" {c.flushed}flush"
                if c.offline:
                    bits += f" {len(c.offline)}off"
                if c.violations:
                    bits += f" viol={c.violations}"
                if c.acc is not None:
                    bits += f" acc={c.acc:.3f}"
                cl.append(bits)
            ev = ("  events: " + "; ".join(r.events)) if r.events else ""
            lines.append(
                f"r{r.round:03d}  t={r.t_start:8.1f}s  Δ={r.duration:7.2f}s  "
                f"{self._fmt_bytes(r.bytes):>9}  | " + " | ".join(cl) + ev)
        s = self.summary()
        lines.append(
            f"TOTAL wall-clock={s['wall_clock_s']:.1f}s  "
            f"bytes={self._fmt_bytes(s['total_bytes'])}  "
            f"participation={s['participation_rate']:.0%}  "
            f"mar_violations={s['mar_violations']}  "
            f"dropped={s['dropped_total']}  final_acc={s['final_acc']}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {"summary": self.summary(),
                "rows": [asdict(r) for r in self.rows]}

    @staticmethod
    def _fmt_bytes(b: float) -> str:
        for unit in ("B", "KB", "MB", "GB"):
            if abs(b) < 1024.0:
                return f"{b:.1f}{unit}"
            b /= 1024.0
        return f"{b:.1f}TB"
