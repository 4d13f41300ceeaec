"""The RAFT-Stereo model in PyTorch."""

from .raft_stereo import RAFTStereo

__all__ = ["RAFTStereo"]
