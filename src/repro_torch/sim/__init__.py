"""Event-driven heterogeneity simulator for Fed-RAC, on the port's engine.

The paper's claims are about *time* — straggler-bound round time (Eq. 2),
the MAR deadline, parallel vs sequential master–slave schedules (Eq. 9/10).
``repro_torch.sim`` drives Fed-RAC round by round under participant
arrivals, dropouts, resource drift (Procedure-2 reassignment) and straggler
spikes, enforces each cluster's MAR budget (drop / mask / wait / buffer
policies), and records a per-round timeline of wall-clock, stragglers,
bytes and MAR violations.  Straggler and dropout decisions become step-mask
rows and weights of the engine's batched cluster update, so the simulator
and the training path share one program.

Besides the synchronous engine on both paths, the package holds the
continuous-time async server (``AsyncPlaneServer``, ``MasterBlock``,
``mode="async"``), run-state checkpoints and fault injection
(``sim.faults``), traces (scenarios and the columnar ``FleetTrace``), the
event queue and clocks, the report, and the vectorized fleet simulator
(``FleetSim``: scheduling and accounting at 10⁴–10⁶ participants, no
training).
"""
from repro_torch.sim.async_server import AsyncPlaneServer, MasterBlock
from repro_torch.sim.clock import ClusterClock, EventQueue, SimClock
from repro_torch.sim.engine import HeterogeneitySim, SimConfig
from repro_torch.sim.events import (Arrival, ClusterDone, Departure, Event,
                                    ResourceDrift, SpikeEnd, StragglerSpike,
                                    event_priority)
from repro_torch.sim.fleet import (FleetReport, FleetRoundRecord, FleetSim,
                                   FleetSimConfig)
from repro_torch.sim.report import ClusterRoundStats, RoundRecord, SimReport
from repro_torch.sim.traces import (SCENARIOS, FleetTrace, Trace,
                                    make_fleet_trace, make_trace,
                                    sample_profiles, scenario_knobs)

__all__ = [
    "Arrival", "AsyncPlaneServer", "ClusterClock", "ClusterDone",
    "ClusterRoundStats", "Departure", "Event", "EventQueue", "FleetReport",
    "FleetRoundRecord", "FleetSim", "FleetSimConfig", "FleetTrace",
    "HeterogeneitySim", "MasterBlock", "ResourceDrift", "RoundRecord",
    "SCENARIOS", "SimClock", "SimConfig", "SimReport", "SpikeEnd",
    "StragglerSpike", "Trace", "event_priority", "make_fleet_trace",
    "make_trace", "sample_profiles", "scenario_knobs",
]
