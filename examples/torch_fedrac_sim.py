"""Fed-RAC under realistic participant churn, on the PyTorch port: the
four scenarios of ``examples/fedrac_sim.py`` through
``repro_torch.launch.sim_run``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_fedrac_sim.py [--device cpu]

1. **dropout-heavy**: a fifth of the fleet blinks offline every round (flaky
   radios); the MAR `drop` policy excludes deadline violators and partial
   aggregation renormalizes the survivors.
2. **resource-drift**: device speeds/bandwidths random-walk; Procedure-2
   reassignment migrates participants between clusters mid-training (drift is
   *observed* by the server, so re-placement keeps devices inside the MAR).
3. **straggler spikes**: transient slowdowns the server cannot re-plan for —
   they surface as MAR violations, and the `mask` policy lets the straggler
   contribute only the local steps that still fit the deadline.
4. **buffered async**: the same spiky fleet under the `buffer` policy —
   violators train their full τ steps, miss the synchronous aggregate, and
   their banked update joins the NEXT round's FedAvg at a staleness-
   discounted weight (`FLConfig(aggregation="buffered")`): the round stays
   bounded by the on-time members and no work is thrown away.

All print the per-round timeline: wall-clock, per-cluster active/dropped/
masked/banked counts, MAR violations, bytes on the wire, and the applied
events.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import sim_run  # noqa: E402

COMMON = ["--participants", "14", "--samples", "1200", "--rounds", "6",
          "--base-width", "0.125", "--compact-to", "3", "--eval-every", "3"]

# (title, the scenario's own flags)
SCENARIOS = [
    ("scenario 1: dropout-heavy fleet, MAR policy = drop",
     ["--trace", "dropout", "--dropout-rate", "0.2", "--mar-policy", "drop"]),
    ("scenario 2: resource drift, MAR policy = mask",
     ["--trace", "drift", "--drift-rate", "0.25", "--mar-policy", "mask",
      "--schedule", "sequential"]),
    ("scenario 3: transient straggler spikes, MAR policy = mask",
     ["--trace", "straggler", "--spike-rate", "0.3", "--mar-policy",
      "mask"]),
    ("scenario 4: straggler spikes, MAR policy = buffer (async banked "
     "updates)",
     ["--trace", "straggler", "--spike-rate", "0.3", "--mar-policy",
      "buffer", "--staleness-discount", "0.6"]),
]


def scenario_argv(flags, device):
    return [*flags, *COMMON, "--device", device]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    reports = []
    for i, (title, flags) in enumerate(SCENARIOS):
        if i:
            print()
        print("=" * 72)
        print(title)
        print("=" * 72)
        reports.append(sim_run.main(scenario_argv(flags, args.device)))
    return reports


if __name__ == "__main__":
    main()
