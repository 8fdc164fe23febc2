"""The trace reduction on a hand-made timeline: the device's busy time
is the union of its intervals inside the traced calls, host annotations
(the benchmark's and the program's ranges) drawn on the device's
timeline are not device work, and each idle gap takes the name of the
span the host spent most of it in."""
from types import SimpleNamespace

import torch

from bench import timeline

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


class Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_reduce_profile():
    prof = Prof([
        ev("bench.train", 0, 100), ev("bench.init_params", 10, 40),
        ev("bench.evaluate", 70, 90),
        ev("bench.train", 0, 100, CUDA, annotation=True),   # not device work
        ev("gemm", 0, 12, CUDA), ev("gemm", 5, 10, CUDA),   # overlapping
        ev("fedagg_kernel", 40, 70, CUDA),
        ev("Memcpy HtoD", 92, 96, CUDA), ev("gemm", 150, 160, CUDA)])
    p = timeline.reduce_profile(prof, torch)
    assert p["window_s"] == 100e-6
    assert abs(p["busy_s"] - (12 + 30 + 4) * 1e-6) < 1e-12
    assert p["count_by_op"] == {"gemm": 2, "fedagg_kernel": 1,
                                "Memcpy HtoD": 1}
    assert [g[0] for g in p["gaps"]] == ["init_params", "evaluate", "train"]
    assert [round(g[1] * 1e6) for g in p["gaps"]] == [28, 22, 4]


def test_the_programs_ranges_are_not_device_work():
    # the program's spans drawn on the device's timeline, flagged or not
    prof = Prof([
        ev("bench.train", 0, 100),
        ev("port.member_update", 0, 50, CUDA, annotation=True),
        ev("port.teacher_forward", 50, 90, CUDA),
        ev("gemm", 10, 20, CUDA)])
    p = timeline.reduce_profile(prof, torch)
    assert p["count_by_op"] == {"gemm": 1}
    assert abs(p["busy_s"] - 10e-6) < 1e-12
