"""Wrapper of the distill kernel (``csrc/distill.cu``).

A CPU tensor goes to the plain version (``ref.py``); a CUDA tensor goes to
the kernel, or the call raises.  ``kd_loss_rows.launches`` counts the
wrapper's launches, one per call: for V > 1024 a call runs two kernels (the
split-vocabulary pass and the merge), split as ``split_plan`` says.

The route is forward only, like the JAX kernel (a bare ``pallas_call`` with
no VJP): asking it for a gradient raises, on either device.  It takes no
``valid_mask``; ``core.distill.kd_loss`` without ``use_kernel`` has both.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.distill import ref

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LABELS = {torch.int32: 4, torch.int64: 8}
SMALL_V = 1024                # V <= SMALL_V: one warp per row, one kernel
TARGET_BLOCKS = 4 * 132       # about four blocks per SM of an H100
GROUP = 8                     # logits per thread and step; chunks align to it


def chunk_for(V: int, splits: int) -> int:
    """The chunk length that cuts V logits into at most ``splits`` chunks:
    ceil(V / splits), rounded up to a multiple of ``GROUP``."""
    chunk = -(-V // splits)
    return -(-chunk // GROUP) * GROUP


def split_plan(N: int, V: int) -> tuple[int, int]:
    """(splits, chunk) of the split-vocabulary kernel for V > SMALL_V: each
    row's V logits are cut into ``splits`` chunks of ``chunk`` (the last one
    shorter, none empty), enough that the N · splits blocks number about
    ``TARGET_BLOCKS``.  (1, V) for V <= SMALL_V, the warp-per-row kernel."""
    if V <= SMALL_V:
        return 1, V
    chunk = chunk_for(V, max(1, min(-(-TARGET_BLOCKS // N), -(-V // GROUP))))
    return -(-V // chunk), chunk


def kd_loss_rows(student, teacher, labels, *, T: float = 2.0,
                 alpha: float = 0.3):
    """(N, V) student and teacher logits (fp32 or bf16), (N,) int labels in
    [0, V) -> (N,) fp32 per-row KD loss."""
    if torch.is_grad_enabled() and (student.requires_grad
                                    or teacher.requires_grad):
        raise RuntimeError(
            "the distill kernel route is forward only (the JAX kernel has no "
            "VJP either); train through core.distill.kd_loss without "
            "use_kernel, which autograd differentiates")
    devices = {student.device, teacher.device, labels.device}
    if devices == {torch.device("cpu")}:
        return ref.kd_loss_rows(student, teacher, labels, T=T, alpha=alpha)
    if len(devices) != 1 or student.device.type != "cuda":
        raise ValueError(f"distill: inputs on {sorted(map(str, devices))}; "
                         "all must be on one CUDA device")
    if student.dtype not in _DTYPES or teacher.dtype != student.dtype:
        raise TypeError(f"distill takes fp32 or bf16 logits of one dtype, "
                        f"got {student.dtype}/{teacher.dtype}")
    if labels.dtype not in _LABELS:
        raise TypeError(f"distill takes int32 or int64 labels, got "
                        f"{labels.dtype}")
    if (student.dim() != 2 or teacher.shape != student.shape
            or labels.shape != student.shape[:1]):
        raise ValueError(f"distill: shapes {tuple(student.shape)}, "
                         f"{tuple(teacher.shape)}, {tuple(labels.shape)} are "
                         "not (N, V), (N, V), (N,)")
    N, V = student.shape
    splits, chunk = split_plan(N, V)
    if not (1 <= N and N * splits < 2 ** 31 and 1 <= V < 2 ** 31):
        raise ValueError(f"distill: N={N}, V={V} out of range")
    if not T > 0:
        raise ValueError(f"distill: temperature T={T} must be positive")
    if not (student.is_contiguous() and teacher.is_contiguous()
            and labels.is_contiguous()):
        raise ValueError("distill: inputs must be contiguous")
    fn = _build.kernel_fn("distill", "kd_rows_launch", _ARGTYPES)
    with torch.cuda.device(student.device):
        out = torch.empty(N, device=student.device, dtype=torch.float32)
        part = (torch.empty(N * splits * 9, device=student.device,
                            dtype=torch.float32) if V > SMALL_V else None)
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(student.data_ptr(), teacher.data_ptr(),
                        labels.data_ptr(), out.data_ptr(),
                        None if part is None else part.data_ptr(), N, V,
                        splits, chunk, T, alpha, (1.0 - alpha) * T ** 2,
                        _DTYPES[student.dtype], _LABELS[labels.dtype],
                        stream), "distill")
    kd_loss_rows.launches += 1
    return out


kd_loss_rows.launches = 0


def kd_loss(student_logits, labels, teacher_logits, *, T: float = 2.0,
            alpha: float = 0.3):
    """Mean KD loss over all rows of (..., V) logits (the JAX wrapper's
    contract: ``sum(rows) / N``)."""
    V = student_logits.shape[-1]
    s = student_logits.reshape(-1, V)
    t = teacher_logits.reshape(-1, V)
    rows = kd_loss_rows(s.contiguous(), t.contiguous(),
                        labels.reshape(-1).contiguous(), T=T, alpha=alpha)
    return rows.sum() / s.shape[0]
