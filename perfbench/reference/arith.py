"""Where the reference's products run, and the control's lower precision.

`Arith()` runs every matrix product and convolution in float32 with TF32
off (the configurations state float32).  `Arith(tf32=True)` is the control
of `correct`: on the card, the same products with TF32 on (matmul and
cuDNN, forward and backward); on the CPU, which has no TF32, each forward
product's operands rounded to TF32 first (10 explicit mantissa bits, round
to nearest, ties away from zero, as the tensor cores' conversion does;
gradients pass the rounding unchanged).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def set_tf32(on: bool) -> None:
    """matmul's and cuDNN's TF32 on the card (off: full float32 products)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


class Arith:
    def __init__(self, tf32: bool = False):
        self.tf32 = tf32
        set_tf32(tf32)

    def _r(self, x: torch.Tensor) -> torch.Tensor:
        if self.tf32 and not x.is_cuda:
            return x + (round_tf32(x) - x).detach()
        return x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self._r(a), self._r(b))

    def bmm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.bmm(self._r(a), self._r(b))

    def conv2d(self, x, w, b, stride: int = 1) -> torch.Tensor:
        return F.conv2d(self._r(x), self._r(w), b, stride=stride)
