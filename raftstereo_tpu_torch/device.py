"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to
``"cuda"``.  Without a GPU it raises instead of running on the CPU: the
CPU runs only where a caller asks for it (the tests do)."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises ``RuntimeError`` when it
    names CUDA and no GPU is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fp32_numerics() -> None:
    """Full fp32 for convolutions and matmuls on the card.  cuDNN runs
    fp32 convolutions in TF32 by default, which keeps about three decimal
    digits; the fp32 path is the one held to the JAX package, so TF32 is
    off, and cuDNN picks deterministic algorithms so a request replays
    bitwise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
