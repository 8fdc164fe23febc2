"""Collective traffic, bytes accessed and roofline terms of one rank's
program, the torch counterpart of ``repro.launch.hlo_analysis``.

The port compiles no HLO: a rank runs its explicit program eagerly
(``launch.dryrun``).  So the module keeps JAX's name and result shapes and
takes its numbers from the program's own calls:

* ``record_collectives`` wraps the port's collective functions
  (``launch.sharding``'s ``all_reduce`` / ``all_gather`` /
  ``reduce_scatter`` and ``models.tp``'s ``_all_reduce`` /
  ``_all_gather``) and records each call that reaches a group of more
  than one rank as (function, mesh axis, bytes): the tensor's bytes for
  an all-reduce, the gathered result's for an all-gather, the scattered
  result's for a reduce-scatter, as JAX counts the result operand of
  each HLO collective.
  ``collective_bytes`` sums a record by JAX's op names.
* ``BytesAccessed`` counts the eager program's memory traffic: the bytes
  of every tensor input and output of every aten op it dispatches, views
  and metadata queries (``prim.device``) excluded (they move nothing).
  With no fusion each op reads its inputs from and writes its outputs to
  device memory, so this is the counterpart of XLA's "bytes accessed"
  (which counts a fused kernel's inputs and outputs once).

``Roofline`` keeps JAX's fields and properties with the NVIDIA H100 SXM5
80GB's datasheet figures (NVIDIA H100 Tensor Core GPU datasheet): 989
TFLOP/s dense bf16 tensor-core throughput, 3.35 TB/s of HBM3 bandwidth,
and NVLink 4 at 900 GB/s in all, 450 GB/s each direction, one figure for
every collective as JAX's single ICI figure is.  They are datasheet peaks,
not measurements: a roofline term is a lower bound on a step's time.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12          # dense bf16, tensor cores
HBM_BW = 3.35e12             # HBM3
NVLINK_BW = 450e9            # NVLink 4, one direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
# the recorded function -> JAX's collective op name
_OP = {"sharding.all_reduce": "all-reduce", "tp.all_reduce": "all-reduce",
       "sharding.all_gather": "all-gather", "tp.all_gather": "all-gather",
       "sharding.reduce_scatter": "reduce-scatter"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


class record_collectives(list):
    """A list that, from its creation until ``restore`` (or the end of a
    ``with`` block), receives one (function, axis, bytes) entry for each
    call of the port's collective functions in this process that reaches
    a group of more than one rank."""

    def __init__(self):
        super().__init__()
        from repro_torch.launch import sharding
        from repro_torch.launch.mesh import axis_size
        from repro_torch.models import tp
        self._orig = (sharding.all_reduce, sharding.all_gather,
                      sharding.reduce_scatter, tp._all_reduce,
                      tp._all_gather)
        s_reduce, s_gather, s_scatter, t_reduce, t_gather = self._orig

        def all_reduce(mesh, x, axis, op="sum"):
            if axis_size(mesh, axis) > 1:
                self.append(("sharding.all_reduce", axis, _nbytes(x)))
            return s_reduce(mesh, x, axis, op)

        def all_gather(mesh, x, axis, dim):
            n = axis_size(mesh, axis)
            if n > 1:
                self.append(("sharding.all_gather", axis, n * _nbytes(x)))
            return s_gather(mesh, x, axis, dim)

        def reduce_scatter(mesh, x, axis, dim):
            n = axis_size(mesh, axis)
            if n > 1:
                self.append(("sharding.reduce_scatter", axis,
                             _nbytes(x) // n))
            return s_scatter(mesh, x, axis, dim)

        def tp_all_reduce(x, op=None):
            self.append(("tp.all_reduce", tp.tp_ctx()[1], _nbytes(x)))
            return t_reduce(x, op)

        def tp_all_gather(x, dim):
            self.append(("tp.all_gather", tp.tp_ctx()[1],
                         tp.tp_size() * _nbytes(x)))
            return t_gather(x, dim)

        (sharding.all_reduce, sharding.all_gather, sharding.reduce_scatter,
         tp._all_reduce, tp._all_gather) = (all_reduce, all_gather,
                                            reduce_scatter, tp_all_reduce,
                                            tp_all_gather)

    def restore(self):
        from repro_torch.launch import sharding
        from repro_torch.models import tp
        (sharding.all_reduce, sharding.all_gather, sharding.reduce_scatter,
         tp._all_reduce, tp._all_gather) = self._orig

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.restore()


def collective_bytes(calls) -> dict:
    """Per collective kind, the bytes and the count of a record's calls
    (JAX's result shape, keyed by JAX's op names)."""
    out = {k: 0 for k in COLLECTIVES}
    counts = {k: 0 for k in COLLECTIVES}
    for fn, _, b in calls:
        out[_OP[fn]] += b
        counts[_OP[fn]] += 1
    return {"bytes": out, "counts": counts, "total": sum(out.values())}


class BytesAccessed(TorchDispatchMode):
    """While entered, ``total`` sums the bytes of the tensor inputs and
    outputs of every aten op dispatched, ops that return views and
    metadata queries excluded (the module docstring)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace != "prim":
            self.total += (_tensor_bytes(args)
                           + _tensor_bytes((kwargs or {}).values())
                           + _tensor_bytes((out,)))
        return out


def _tensor_bytes(xs) -> int:
    """The bytes of the tensors among ``xs`` and in its lists / tuples."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (list, tuple)):
            n += _tensor_bytes(x)
    return n


@dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops_total: float = 0.0       # 6·N_active·D (analytic)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        hw = self.flops_per_device * self.chips
        return self.model_flops_total / hw if hw else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
        }
