"""PyTorch + CUDA port of raftstereo_tpu for NVIDIA Hopper (H100).

The JAX package ``raftstereo_tpu`` is the reference this port is held
against; the port imports nothing from it.  This slice covers test-mode
inference of the flagship model through the serving engine, with the
on-demand correlation lookup and the fused finest-level GRU update as
hand-written CUDA kernels (``csrc/``).
"""

from .config import RAFTStereoConfig, ServeConfig
from .models import RAFTStereo

__all__ = ["RAFTStereo", "RAFTStereoConfig", "ServeConfig"]
