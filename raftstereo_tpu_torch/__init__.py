"""PyTorch + CUDA port of raftstereo_tpu for NVIDIA Hopper (H100).

The JAX package ``raftstereo_tpu`` is the reference this port is held
against; the port imports nothing from it.  It serves, evaluates and
trains the flagship model in fp32 with all four correlation backends
(and the int8 volume in inference), and serves it in bf16; every TPU
kernel of the JAX package is a hand-written CUDA kernel (``csrc/``), each
with a plain PyTorch version beside it.
"""

from .config import RAFTStereoConfig, ServeConfig
from .models import RAFTStereo

__all__ = ["RAFTStereo", "RAFTStereoConfig", "ServeConfig"]
