"""Device selection for the port's entry points.

The port runs on the GPU.  An entry point that is given no device takes
`cuda` and fails loudly when there is none: it never moves to the CPU on
its own, so a run that was meant for the card cannot quietly measure the
CPU instead.  The CPU is used only when the caller names it (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> `cuda`; raise if CUDA is asked for (or implied) but absent.

    For CUDA it also pins float32 products to full float32: TF32 keeps
    about three decimal digits, which would break the STFT's parity with
    the reference.  PyTorch's matmul default is already off and is stated
    here; cuDNN's default is on and is turned off."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "avsi_torch runs on an NVIDIA GPU and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    return dev
