"""Fault-injection harness for the crash-safety layer.

``FaultInjector`` hooks into the engine's round pipeline at the two places a
real server dies: round boundaries (after the boundary checkpoint is
written; merge events in async mode) and mid-dispatch-block (after the
block's programs ran, before its rounds are recorded — the on-disk state is
strictly older than the lost work).  A triggered fault delivers an
un-catchable ``SIGKILL`` to the process, which the kill-and-resume tests
need; tests that must stay in-process set ``raise_instead`` to get a
``SimulatedCrash`` exception at the same place instead.  ``NULL_FAULTS``
is the injector that never fires.

``corrupt_checkpoint`` damages the newest checkpoint in a manifest
directory in controlled ways (truncation, bit garbage, deleted leaf file,
manifest corruption) so the degrade-to-previous-valid restore path is
testable from both pytest and the ``sim_run --corrupt-ckpt`` CLI.

``python -m repro_torch.sim.faults --compare-reports a.json b.json`` is the
oracle of a resume: it exits nonzero unless two ``--report-out`` JSON
documents are bit-identical (floats round-trip JSON via ``repr``, so
document equality IS bit-equality of every loss, duration, byte count and
the params CRC).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
from dataclasses import dataclass

from repro_torch.ckpt.manifest import ARRAYS_FILE, MANIFEST, CheckpointManager


class SimulatedCrash(RuntimeError):
    """In-process stand-in for SIGKILL (``FaultPlan.raise_instead``)."""


class GracefulShutdown(Exception):
    """Raised by the sim_run SIGTERM/SIGINT handler; the launcher catches
    it, flushes telemetry, writes a final checkpoint, and exits nonzero."""

    def __init__(self, signum: int):
        super().__init__(f"signal {signum}")
        self.signum = signum


@dataclass
class FaultPlan:
    kill_at_round: int | None = None    # die at the first boundary >= this
    kill_mid_block: int | None = None   # die inside the block covering this
    raise_instead: bool = False         # SimulatedCrash instead of SIGKILL


class FaultInjector:
    """Engine-side fault hooks; a default-constructed plan never fires."""

    def __init__(self, plan: FaultPlan | None = None):
        self.plan = plan or FaultPlan()

    def _die(self, where: str) -> None:
        if self.plan.raise_instead:
            raise SimulatedCrash(where)
        sys.stdout.flush()
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)

    def round_boundary(self, r: int) -> None:
        """Called with ``r`` = rounds completed, right after the boundary
        snapshot is retained/written."""
        k = self.plan.kill_at_round
        if k is not None and r >= k:
            self._die(f"round boundary {r}")

    def mid_block(self, r0: int, r1: int) -> None:
        """Called inside a dispatch block spanning rounds [r0, r1), after
        its programs ran but before its rounds are recorded."""
        k = self.plan.kill_mid_block
        if k is not None and r0 <= k < r1:
            self._die(f"mid-block [{r0}, {r1})")


NULL_FAULTS = FaultInjector()

CORRUPTION_MODES = ("truncate", "garbage", "delete", "manifest")


def corrupt_checkpoint(ckpt_dir: str, mode: str = "garbage") -> str:
    """Damage the newest checkpoint under ``ckpt_dir``; returns the path
    touched.  ``truncate`` halves ``arrays.ckpt`` (short-read artifact),
    ``garbage`` flips payload bytes in place (CRC mismatch at equal size),
    ``delete`` removes the leaf file entirely, ``manifest`` mangles
    MANIFEST.json (restore falls back to the directory scan)."""
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}")
    if mode == "manifest":
        path = os.path.join(ckpt_dir, MANIFEST)
        with open(path, "w") as f:
            f.write('{"format": 1, "checkpoints": [truncated')
        return path
    entries = CheckpointManager(ckpt_dir)._manifest_entries()
    if not entries:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, entries[-1]["dir"], ARRAYS_FILE)
    if mode == "delete":
        os.remove(path)
        return path
    with open(path, "rb") as f:
        data = f.read()
    if mode == "truncate":
        data = data[:len(data) // 2]
    else:  # garbage: size-preserving bit damage beyond the msgpack header
        mid = len(data) // 2
        data = data[:mid] + bytes(b ^ 0xFF for b in data[mid:mid + 64]) \
            + data[mid + 64:]
    with open(path, "wb") as f:
        f.write(data)
    return path


def compare_reports(path_a: str, path_b: str) -> list[str]:
    """Differences between two report JSON documents (empty = identical)."""
    with open(path_a) as f:
        a = json.load(f)
    with open(path_b) as f:
        b = json.load(f)
    diffs: list[str] = []
    _diff("", a, b, diffs)
    return diffs


def _diff(prefix: str, a, b, out: list[str], limit: int = 40) -> None:
    if len(out) >= limit:
        return
    if type(a) is not type(b):
        out.append(f"{prefix or '/'}: type {type(a).__name__} != "
                   f"{type(b).__name__}")
    elif isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            if k not in a or k not in b:
                out.append(f"{prefix}/{k}: only in "
                           f"{'second' if k not in a else 'first'}")
            else:
                _diff(f"{prefix}/{k}", a[k], b[k], out, limit)
    elif isinstance(a, list):
        if len(a) != len(b):
            out.append(f"{prefix or '/'}: length {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            _diff(f"{prefix}[{i}]", x, y, out, limit)
    elif a != b and not (a != a and b != b):   # NaN == NaN for our purposes
        out.append(f"{prefix or '/'}: {a!r} != {b!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="fault-injection utilities (corrupt checkpoints, "
                    "compare run reports bit-exactly)")
    ap.add_argument("--corrupt", metavar="CKPT_DIR",
                    help="damage the newest checkpoint in this directory")
    ap.add_argument("--mode", choices=CORRUPTION_MODES, default="garbage")
    ap.add_argument("--compare-reports", nargs=2, metavar=("A", "B"),
                    help="exit 1 unless two --report-out JSONs are "
                         "bit-identical")
    args = ap.parse_args(argv)
    if args.corrupt:
        path = corrupt_checkpoint(args.corrupt, args.mode)
        print(f"corrupted ({args.mode}): {path}")
    if args.compare_reports:
        diffs = compare_reports(*args.compare_reports)
        if diffs:
            for d in diffs:
                print(f"DIFF {d}")
            print(f"reports differ ({len(diffs)} diffs shown)")
            return 1
        print("reports bit-identical")
    return 0


if __name__ == "__main__":
    sys.exit(main())
