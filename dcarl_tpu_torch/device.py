"""Device choice of the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
``device=None`` they take ``cuda`` and raise when there is none, so a
missing GPU never turns into a quiet CPU run.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> ``cuda`` (which must exist); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dcarl_tpu_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain CPU path")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def disable_tf32() -> None:
    """Full-FP32 matrix products and convolutions: the store moments
    and the feature products hold f32 accuracy, which TF32's ten-bit
    mantissa would not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
