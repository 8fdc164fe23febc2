"""Matrix products and convolutions of the reference, in fp32 or, for the
control, in TF32.

On the card TF32 is the hardware's: ``scope`` sets the ``torch.backends``
flags for the work it covers and puts them back after.  On the CPU,
where there is no such hardware, each operand is rounded to TF32's
10-bit mantissa (round to nearest even) before an fp32 product, which is
what the tensor cores compute: 11-bit products are exact in fp32 and
accumulate in fp32.  The rounding passes gradients straight through, so
the backward's products see rounded forward operands."""
from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    i = x.detach().contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    r = ((i + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32).view(
        torch.float32).view(x.shape)
    return x + (r - x).detach()


class Numerics:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    @contextmanager
    def scope(self):
        """The card's TF32 flags as this precision asks, for the work
        inside."""
        m, c = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = m
            torch.backends.cudnn.allow_tf32 = c

    def _r(self, x):
        return tf32_round(x) if self.tf32 and not x.is_cuda else x

    def mm(self, a, b):
        return self._r(a) @ self._r(b)

    def conv2d(self, x, w, b):
        return F.conv2d(self._r(x), self._r(w), b, padding=1)


FP32 = Numerics()
TF32 = Numerics(tf32=True)
