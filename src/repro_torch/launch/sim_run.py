"""Heterogeneity-simulation launcher: Fed-RAC under an event trace.

  PYTHONPATH=src python -m repro_torch.launch.sim_run --trace dropout \
      --participants 16 --rounds 8 --mar-policy drop --dropout-rate 0.2 \
      [--device cpu]

Builds the usual Fed-RAC pipeline (clustering → compaction → Procedure-2
assignment) on synthetic federated data, then hands it to
``repro_torch.sim.HeterogeneitySim``: per-round MAR deadline enforcement,
dropouts/arrivals, resource drift through dynamic reassignment, straggler
spikes — and prints the per-round timeline plus summary (optionally JSON).
``--rounds-per-dispatch R`` (> 1) runs fused blocks of up to R rounds
between events.  ``--metrics-out``, ``--trace-out``, ``--report-out`` and
``--fence`` write the observability artifacts that
``python -m repro_torch.obs.validate`` checks.

``--mode async`` swaps the global round barrier for the continuous-time
async parameter server: per-cluster clocks, pull-version/push-delta
dispatch, streaming staleness-discounted merges, with ``--max-staleness``
bounding how far any cluster may lead the slowest (0 = synchronized
arrivals ≡ the sync buffered path, bit-for-bit).

``--fleet-size N`` switches to the vectorized orchestration simulator
(``repro_torch.sim.FleetSim``): N Table-III-resampled participants as a
struct-of-arrays ``Fleet``, columnar traces, sampled-Dunn Procedure 1, FedCS
selection — no model training, fleet-scale scheduling/accounting only.

  PYTHONPATH=src python -m repro_torch.launch.sim_run --fleet-size 100000 \
      --rounds 3 --trace mixed --select fedcs --select-budget 64

The crash-safety surface lives here too: ``--ckpt-dir`` arms round-boundary
run-state checkpoints (cadence ``--ckpt-every``, retention ``--ckpt-keep``),
``--resume`` continues from the newest *valid* one bit-identically, SIGTERM/
SIGINT flush telemetry and write a final checkpoint before exiting
``128+signum``, and the fault-injection knobs (``--kill-at-round``,
``--kill-mid-block``, ``--corrupt-ckpt``) drive the kill-and-resume tests.

``--mesh-shape D[xM]`` shards the dispatch blocks over a mesh of D·M ranks,
one process each (``core.server``): run alone, the launcher starts the
ranks itself and rendezvouses them through a file; under
``torch.distributed.run`` it uses the world it is given.  Rank r runs on
``cuda:(r % device_count)``, or the CPU with ``--device cpu``, over gloo
on the CPU, nccl when every rank has a card of its own, else gloo (NCCL
refuses two ranks on one card).  Rank 0 writes every output and prints; the
other ranks are silent.  On a 2D mesh the member forward runs
tensor-parallel over the model axis (``--tp-forward``, the default, as in
JAX: each rank trains its slice of every member model on a TP-layout
plane); ``--no-tp-forward`` gathers the plane's columns each round for a
replicated forward.

  PYTHONPATH=src python -m repro_torch.launch.sim_run --trace mixed \
      --mar-policy buffer --rounds-per-dispatch 4 --mesh-shape 2x2 \
      --device cpu

The flags are the JAX launcher's, plus ``--device`` (``cuda`` by default;
without a card it raises; on the fleet path it is where the setup's Lloyd
loop runs).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import signal
import sys
import tempfile
import zlib

import numpy as np
import torch

from repro_torch.ckpt.run_state import make_checkpointer
from repro_torch.core import server as srv
from repro_torch.core.families import cnn_family
from repro_torch.core.resources import (LAMBDA_EQUAL, LAMBDA_PAPER, Fleet,
                                        participants_from_matrix)
from repro_torch.core.tree import tree_leaves
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import (SPECS, make_classification,
                                        train_test_split)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import make_observability
from repro_torch.sim import (SCENARIOS, FleetSim, FleetSimConfig,
                             HeterogeneitySim, SimConfig, make_fleet_trace,
                             make_trace, sample_profiles, scenario_knobs)
from repro_torch.sim.faults import (CORRUPTION_MODES, FaultInjector,
                                    FaultPlan, GracefulShutdown,
                                    corrupt_checkpoint)

def _trace_knobs(args) -> dict:
    """CLI rate knobs the chosen scenario accepts, only when explicitly set
    (``make_trace`` rejects unknown knobs — a typo'd ``--dropout-rate`` on a
    drift trace must fail loudly, not silently no-op)."""
    knobs = {"dropout_rate": args.dropout_rate, "drift_rate": args.drift_rate,
             "spike_rate": args.spike_rate}
    explicit = {k: v for k, v in knobs.items() if v is not None}
    unknown = set(explicit) - scenario_knobs(args.trace)
    if unknown:
        raise SystemExit(
            f"--{sorted(unknown)[0].replace('_', '-')} does not apply to "
            f"trace {args.trace!r} (knobs: "
            f"{sorted(scenario_knobs(args.trace)) or 'none'})")
    return explicit


def _crash_harness(args, writer: bool = True):
    """(RunCheckpointer | None, FaultInjector | None) from the crash-safety
    flags; ``--corrupt-ckpt`` damages the newest checkpoint *before* the
    resume read so the degrade-to-previous-valid path is exercised."""
    if args.resume and not args.ckpt_dir:
        raise SystemExit("--resume requires --ckpt-dir")
    if args.corrupt_ckpt and not args.ckpt_dir:
        raise SystemExit("--corrupt-ckpt requires --ckpt-dir")
    if args.kill_mid_block is not None:
        if args.fleet_size:
            raise SystemExit("--kill-mid-block does not apply to the fleet "
                             "simulator (no dispatch blocks)")
        if args.rounds_per_dispatch <= 1:
            raise SystemExit("--kill-mid-block needs --rounds-per-dispatch "
                             ">1 (mid-block faults live inside dispatch "
                             "blocks)")
    if args.corrupt_ckpt and writer:
        path = corrupt_checkpoint(args.ckpt_dir, args.corrupt_ckpt)
        print(f"# corrupted newest checkpoint ({args.corrupt_ckpt}): {path}")
    ckpt = None
    if args.ckpt_dir:
        ckpt = make_checkpointer(args.ckpt_dir, every=args.ckpt_every,
                                 keep=args.ckpt_keep, resume=args.resume,
                                 writer=writer)
    faults = None
    if args.kill_at_round is not None or args.kill_mid_block is not None:
        faults = FaultInjector(FaultPlan(kill_at_round=args.kill_at_round,
                                         kill_mid_block=args.kill_mid_block))
    return ckpt, faults


@contextlib.contextmanager
def _graceful_signals():
    """SIGTERM/SIGINT raise ``GracefulShutdown`` inside the run loop so the
    launcher can flush telemetry and write a final checkpoint; the original
    handlers are restored on exit."""
    def handler(signum, frame):
        raise GracefulShutdown(signum)
    old = {s: signal.signal(s, handler)
           for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield
    finally:
        for s, h in old.items():
            signal.signal(s, h)


def _params_crc32(params: dict) -> dict:
    """Per-level CRC32 over the raveled parameter bytes — the report's
    bit-exactness witness for the kill-and-resume comparison."""
    out = {}
    for lvl in sorted(params):
        crc = 0
        for leaf in tree_leaves(params[lvl]):
            crc = zlib.crc32(np.ascontiguousarray(
                leaf.detach().cpu().numpy()).tobytes(), crc)
        out[str(lvl)] = crc
    return out


def _flush_obs(args, obs) -> None:
    if obs is None:
        return
    if args.metrics_out:
        n = obs.registry.to_jsonl(args.metrics_out)
        print(f"# metrics: {n} lines -> {args.metrics_out}")
    if args.trace_out:
        obs.tracer.write(args.trace_out)
        print(f"# trace: {len(obs.tracer.events())} spans -> "
              f"{args.trace_out}"
              + (" (fenced timings)" if args.fence else ""))


def _graceful_exit(args, sim, obs, signum) -> None:
    """The SIGTERM/SIGINT path: final checkpoint, telemetry flush, partial
    report, nonzero exit (128+signum, the shell convention)."""
    step = sim.save_now()
    print(f"# signal {signum}: "
          + (f"final checkpoint at round {step}" if step is not None
             else "no checkpoint written (none armed or no round done)"))
    _flush_obs(args, obs)
    if args.report_out and sim.report is not None:
        rep = sim.report
        doc = rep.to_dict() if hasattr(rep, "to_dict") else rep.summary()
        doc["interrupted"] = signum
        with open(args.report_out, "w") as f:
            json.dump(doc, f, default=float)
        print(f"# partial report -> {args.report_out}")
    raise SystemExit(128 + signum)


def build(args, mesh=None, device=None):
    ds = make_classification(args.dataset, args.samples, seed=args.seed)
    train, test = train_test_split(ds)
    idx = dirichlet_partition(train.y, args.participants,
                              alpha=args.dirichlet, seed=args.seed)
    V = sample_profiles(args.participants, seed=args.seed)
    parts = participants_from_matrix(V, n_data=[len(p) for p in idx])
    client_data = [{"x": train.x[p], "y": train.y[p]} for p in idx]
    shape, classes = SPECS[args.dataset]
    fam = cnn_family(classes=classes, in_channels=shape[-1],
                     alpha=args.alpha, base_width=args.base_width,
                     input_hw=shape[0])
    lam = LAMBDA_PAPER if args.lam == "paper" else LAMBDA_EQUAL
    cfg = srv.FLConfig(alpha=args.alpha, steps_per_round=args.steps_per_round,
                       lr=args.lr, lam=lam, compact_to=args.compact_to,
                       seed=args.seed, E=args.epochs, mar=args.mar,
                       kappa=args.kappa, pad_clusters=not args.no_pad,
                       aggregation=("buffered" if args.mar_policy == "buffer"
                                    else "sync"),
                       staleness_discount=args.staleness_discount,
                       rounds_per_dispatch=args.rounds_per_dispatch,
                       tp_forward=args.tp_forward)
    eng = srv.FedRAC(parts, client_data, fam, cfg, classes=classes,
                     device=device or args.device, mesh=mesh).setup()
    return eng, {"x": test.x, "y": test.y}


def run_fleet(args):
    """Vectorized fleet path: Fleet + FleetTrace + FleetSim, no training."""
    n = args.fleet_size
    ckpt, faults = _crash_harness(args)
    fleet = Fleet.from_matrix(sample_profiles(n, seed=args.seed))
    trace = make_fleet_trace(args.trace, n, args.rounds, seed=args.seed,
                             **_trace_knobs(args))
    lam = LAMBDA_PAPER if args.lam == "paper" else LAMBDA_EQUAL
    sim = FleetSim(fleet, trace, FleetSimConfig(
        rounds=args.rounds, mar_policy=args.mar_policy, select=args.select,
        select_budget=args.select_budget, schedule=args.schedule,
        mar=args.mar or 0.0, kappa=args.kappa, lam=lam, seed=args.seed,
        mode=args.mode), checkpoint=ckpt, faults=faults, device=args.device)
    with _graceful_signals():
        try:
            report = sim.run()
        except GracefulShutdown as e:
            _graceful_exit(args, sim, None, e.signum)
    s = report.summary()
    print(f"fleet={n} k={report.k} MAR={report.mar} "
          f"cluster_sizes={s['cluster_sizes']}")
    for r in report.rows:
        print(f"r{r.round:03d}  Δ={r.duration:8.3f}s  events={r.events}  "
              f"active={int(r.active.sum())} masked={int(r.masked.sum())} "
              f"dropped={int(r.dropped.sum())} off={int(r.offline.sum())} "
              f"unsel={int(r.unselected.sum())} "
              f"banked={int(r.banked.sum())} flushed={int(r.flushed.sum())}")
    if args.json:
        print(json.dumps(s, default=float))
    if args.report_out:
        with open(args.report_out, "w") as f:
            json.dump(s, f, default=float)
        print(f"# report -> {args.report_out}")
    return report


def run(args, mesh=None, rank: int = 0, device=None):
    """One simulation; on a mesh every rank runs it and rank 0 writes the
    outputs."""
    if args.fleet_size:
        return run_fleet(args)
    ckpt, faults = _crash_harness(args, writer=rank == 0)
    eng, testb = build(args, mesh=mesh, device=device)
    members = {l: len(v) for l, v in eng.assignment.members.items()}
    print(f"device={eng.device} k_optimal={eng.k_optimal} "
          f"compacted_to={eng.m} MAR(master)={eng.specs[0].mar:.2f}s "
          f"members={members}")
    if eng.mesh is not None:
        plane_txt = (f", plane columns sharded {eng._mesh_m}-way"
                     if eng._mesh_m > 1 else "")
        fwd_txt = ("" if eng._mesh_m == 1 else
                   ", tensor-parallel member forward" if eng._tp else
                   ", replicated member forward")
        backend = torch.distributed.get_backend()
        print(f"mesh={mesh_lib.mesh_shape(eng.mesh)} (member axis sharded "
              f"{eng._mesh_n}-way{plane_txt}{fwd_txt}) backend={backend}")
    trace = make_trace(args.trace, args.participants, args.rounds,
                       seed=args.seed, **_trace_knobs(args))
    obs = None
    if args.metrics_out or args.trace_out or args.fence:
        obs = make_observability(fence=args.fence)
    sim = HeterogeneitySim(eng, trace, SimConfig(
        rounds=args.rounds, mar_policy=args.mar_policy,
        schedule=args.schedule, eval_every=args.eval_every,
        select=args.select, select_budget=args.select_budget,
        mode=args.mode, max_staleness=args.max_staleness), obs=obs,
        checkpoint=ckpt, faults=faults)
    with _graceful_signals():
        try:
            report = sim.run(testb)
        except GracefulShutdown as e:
            if rank:
                raise SystemExit(128 + e.signum)
            _graceful_exit(args, sim, obs, e.signum)
    print(report.timeline())
    stats = eng.compile_stats()
    print(f"# round programs={len(stats)} builds={sum(stats.values())} "
          f"(padding {'on' if eng.cfg.pad_clusters else 'off'})")
    if rank:
        return report
    _flush_obs(args, obs)
    if args.report_out:
        doc = report.to_dict()
        doc["params_crc32"] = _params_crc32(sim.params)
        with open(args.report_out, "w") as f:
            json.dump(doc, f, default=float)
        print(f"# report -> {args.report_out}")
    if args.json:
        print(json.dumps(report.to_dict(), default=float))
    return report


def _check_mesh_flags(args) -> tuple:
    """(data, model) of ``--mesh-shape``, refused before any rank starts
    when the engine would refuse it."""
    n, m = mesh_lib.parse_sim_mesh_shape(args.mesh_shape)
    if args.rounds_per_dispatch <= 1:
        raise SystemExit("--mesh-shape shards the dispatch path: it needs "
                         "--rounds-per-dispatch >1")
    return n, m


def run_rank(args, rank: int, world: int, init_method: str,
             report_path: str | None = None):
    """One rank of a mesh run: join the world, build the mesh, run.  Rank
    0 pickles its report to ``report_path`` for the launching process."""
    torch.set_num_threads(1)
    mesh_lib.init_world(rank, world, init_method,
                        mesh_lib.default_backend(args.device, world))
    device = None
    if args.device == "cuda":
        device = torch.device("cuda", rank % max(1, torch.cuda.device_count()))
        torch.cuda.set_device(device)
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        mesh = mesh_lib.make_sim_mesh(args.mesh_shape,
                                      device_type=args.device)
        report = run(args, mesh=mesh, rank=rank, device=device)
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    if rank == 0 and report_path:
        report.obs = None
        with open(report_path, "wb") as f:
            pickle.dump(report, f)
    return report


def _spawned_rank(rank, args, world, init_method, report_path):
    run_rank(args, rank, world, init_method, report_path)


def run_mesh(args):
    """``--mesh-shape``: in the world ``torch.distributed.run`` gave, or
    in D·M ranks started here (one process each, a file rendezvous in a
    fresh temporary directory).  Returns rank 0's report."""
    n, m = _check_mesh_flags(args)
    if "WORLD_SIZE" in os.environ:
        return run_rank(args, int(os.environ["RANK"]),
                        int(os.environ["WORLD_SIZE"]), "env://")
    if args.device == "cuda":
        srv.resolve_device("cuda")
        from repro_torch.kernels import _build
        _build.build()                 # once here, not once per rank
    with tempfile.TemporaryDirectory(prefix="sim_mesh_") as d:
        report_path = os.path.join(d, "report.pkl")
        torch.multiprocessing.spawn(
            _spawned_rank, args=(args, n * m, f"file://{d}/rendezvous",
                                 report_path), nprocs=n * m)
        with open(report_path, "rb") as f:
            return pickle.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="dropout", choices=sorted(SCENARIOS))
    ap.add_argument("--mar-policy", default="drop",
                    choices=["drop", "mask", "wait", "buffer"])
    ap.add_argument("--staleness-discount", type=float, default=0.6,
                    help="per-round weight decay of banked updates "
                         "(buffer policy)")
    ap.add_argument("--no-pad", action="store_true",
                    help="disable capacity padding (a new program at every "
                         "cluster-cardinality change)")
    ap.add_argument("--rounds-per-dispatch", type=int, default=1,
                    help=">1 runs up to that many rounds per cluster as one "
                         "dispatch block between events (device-resident "
                         "shards, flat-plane aggregation on the fedagg "
                         "kernel)")
    ap.add_argument("--schedule", default="parallel",
                    choices=["parallel", "sequential"])
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="async: continuous-time parameter server — each "
                         "cluster runs on its own clock, pulls the plane "
                         "version, pushes its delta at its own completion "
                         "time (streaming staleness-discounted merge); "
                         "requires --schedule parallel")
    ap.add_argument("--max-staleness", type=int, default=None, metavar="K",
                    help="async: max version lead of any cluster over the "
                         "slowest one; 0 = synchronized arrivals "
                         "(reproduces the sync buffered path bit-exactly), "
                         "omitted = unbounded")
    ap.add_argument("--dropout-rate", type=float, default=None,
                    help="per-round dropout probability (dropout/mixed "
                         "traces; scenario default when omitted)")
    ap.add_argument("--drift-rate", type=float, default=None,
                    help="per-round resource-drift probability (drift/mixed)")
    ap.add_argument("--spike-rate", type=float, default=None,
                    help="per-round straggler-spike probability "
                         "(straggler/mixed)")
    ap.add_argument("--select", default="all", choices=["all", "fedcs"],
                    help="per-cluster client selection (fedcs: greedy "
                         "deadline-aware admission, arXiv:1804.08333)")
    ap.add_argument("--select-budget", type=int, default=0,
                    help="fedcs: max clients admitted per cluster per round "
                         "(0 = deadline-bounded only)")
    ap.add_argument("--dataset", default="synth-mnist", choices=list(SPECS))
    ap.add_argument("--participants", type=int, default=16)
    ap.add_argument("--samples", type=int, default=1600)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--steps-per-round", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--base-width", type=float, default=0.25)
    ap.add_argument("--dirichlet", type=float, default=1.0)
    ap.add_argument("--compact-to", type=int, default=3)
    ap.add_argument("--lam", default="paper", choices=["paper", "equal"])
    ap.add_argument("--mar", type=float, default=None,
                    help="explicit MAR budget (s); default auto-calibrates")
    ap.add_argument("--kappa", type=float, default=0.7)
    ap.add_argument("--eval-every", type=int, default=2)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="export the metrics registry (counters, gauges, "
                         "per-round tables) as JSON Lines")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Chrome-trace/Perfetto JSON of the round "
                         "pipeline (engine rounds, dispatch blocks, program "
                         "first calls, transfers)")
    ap.add_argument("--fence", action="store_true",
                    help="wait for the card inside spans so timings cover "
                         "device execution, not just the launches "
                         "(serializes the pipeline — measurement mode)")
    ap.add_argument("--report-out", default=None, metavar="PATH",
                    help="write report.to_dict() JSON (summary + rows) — "
                         "pairs with repro_torch.obs.validate --report")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="arm crash-safe run-state checkpoints: versioned "
                         "manifest + CRC32 snapshots of planes, bank, "
                         "sampler position, event queue, participant "
                         "resources and metrics tables at round boundaries")
    ap.add_argument("--ckpt-every", type=int, default=1, metavar="R",
                    help="checkpoint cadence in rounds (default 1)")
    ap.add_argument("--ckpt-keep", type=int, default=3, metavar="K",
                    help="retain the last K checkpoints (default 3)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the newest VALID checkpoint under "
                         "--ckpt-dir (corrupt/truncated ones are skipped "
                         "with a warning); bit-identical to the "
                         "uninterrupted run")
    ap.add_argument("--kill-at-round", type=int, default=None, metavar="R",
                    help="fault injection: SIGKILL this process at the "
                         "first round boundary >= R (after the boundary "
                         "checkpoint); with --mode async, R counts MERGE "
                         "EVENTS (the async checkpoint cadence)")
    ap.add_argument("--kill-mid-block", type=int, default=None, metavar="R",
                    help="fault injection: SIGKILL inside the dispatch "
                         "block covering round R, after its programs ran "
                         "but before its rounds are recorded")
    ap.add_argument("--corrupt-ckpt", default=None, choices=CORRUPTION_MODES,
                    help="damage the newest checkpoint under --ckpt-dir "
                         "before anything else runs (degradation testing)")
    ap.add_argument("--fleet-size", type=int, default=0, metavar="N",
                    help="run the vectorized fleet simulator on N "
                         "participants (no training; scheduling and "
                         "accounting only)")
    ap.add_argument("--mesh-shape", default=None, metavar="DATA[xMODEL]",
                    help="shard the dispatch path over a mesh of ranks, "
                         "e.g. '8', '8x1' (member axis only) or '4x2' "
                         "(members along data and plane/bank/teacher "
                         "columns along model).  Requires "
                         "--rounds-per-dispatch >1; a round's aggregation "
                         "becomes a local (rows x columns) fedagg plus one "
                         "all_reduce over data")
    ap.add_argument("--tp-forward", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="on a 2D mesh, run the member forward tensor-"
                         "parallel over the model axis (each rank trains "
                         "its slice of the model on a TP-layout plane); "
                         "--no-tp-forward gathers the plane's columns for "
                         "a replicated forward")
    args = ap.parse_args(argv)
    if args.mesh_shape and not args.fleet_size:
        return run_mesh(args)
    return run(args)


if __name__ == "__main__":
    main()
