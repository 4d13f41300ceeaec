"""PyTorch + CUDA port of raftstereo_tpu for NVIDIA Hopper (H100).

The JAX package ``raftstereo_tpu`` is the reference this port is held
against; the port imports nothing from it.  It serves and trains the
flagship model in fp32 with all four correlation backends (and the int8
volume in inference); every TPU kernel on those paths is a hand-written
CUDA kernel (``csrc/``), each with a plain PyTorch version beside it.
"""

from .config import RAFTStereoConfig, ServeConfig
from .models import RAFTStereo

__all__ = ["RAFTStereo", "RAFTStereoConfig", "ServeConfig"]
