"""Configuration of the PyTorch port.

``RAFTStereoConfig`` keeps the field names and defaults of the JAX
package's config (``raftstereo_tpu/config.py``) so one set of flags
describes both.  This slice of the port runs one numeric path: the
on-demand correlation lookup and the fused finest-level GRU update, both
as hand-written CUDA kernels, in fp32, with the plain (non-fused)
encoders.  Every field value that selects another path raises
``NotImplementedError`` naming the ROADMAP item that will add it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """Architecture hyper-parameters of the RAFT-Stereo model.  Level 0 is
    the finest GRU resolution (1/2^n_downsample); ``hidden_dims`` runs
    finest to coarsest.

    Defaults match the JAX config except ``corr_implementation``: "auto"
    here, which resolves to the on-demand lookup kernel — the backend the
    JAX package's "auto" takes on its accelerator."""

    corr_implementation: str = "auto"
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    n_gru_layers: int = 3
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    slow_fast_gru: bool = False
    shared_backbone: bool = False
    context_norm: str = "batch"
    compute_dtype: str = "float32"
    corr_dtype: str = "float32"
    corr_precision: str = "highest"
    corr_quant: bool = False
    fused_encoder: Optional[bool] = None
    gru_backend: str = "auto"
    remat: bool = False
    input_mode: str = "passive"
    spatial_shards: int = 1

    def __post_init__(self):
        if isinstance(self.hidden_dims, list):
            object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if not 1 <= self.n_gru_layers <= 3:
            raise ValueError(f"n_gru_layers {self.n_gru_layers} not in 1..3")
        if len(self.hidden_dims) < self.n_gru_layers:
            raise ValueError(f"hidden_dims {self.hidden_dims} shorter than "
                             f"n_gru_layers {self.n_gru_layers}")

    @property
    def factor(self) -> int:
        """Full-resolution upsampling factor of the disparity field."""
        return 2 ** self.n_downsample

    @property
    def cor_planes(self) -> int:
        """Correlation feature channels fed to the motion encoder."""
        return self.corr_levels * (2 * self.corr_radius + 1)


# (field, values this slice runs, ROADMAP item that adds the rest)
_SUPPORTED = (
    ("corr_implementation", ("auto", "pallas_alt"),
     "Queue 2 (the reg/alt/pallas lookups)"),
    ("gru_backend", ("auto", "fused"), "Queue 1 item 3 (the xla GRU step)"),
    ("corr_quant", (False,), "Queue 1 item 7 (precision tiers)"),
    ("compute_dtype", ("float32",), "Queue 1 item 3 (bf16 compute)"),
    ("corr_dtype", ("float32",), "Queue 1 item 7 (bf16 correlation)"),
    ("corr_precision", ("highest",),
     "Queue 2 (TF32 lookup precision policies)"),
    ("shared_backbone", (False,), "Queue 1 item 1 (shared backbone)"),
    ("input_mode", ("passive",), "Queue 1 item 9 (structured light)"),
    ("spatial_shards", (1,), "Queue 1 item 10 (spatial sharding)"),
    ("context_norm", ("batch", "instance"),
     "Queue 1 item 3 (group norm, no norm)"),
    ("slow_fast_gru", (False,), "Queue 1 item 3 (slow_fast schedule)"),
)


def check_supported(config: RAFTStereoConfig) -> None:
    """Raise ``NotImplementedError`` for any field value outside this
    slice's path.  ``fused_encoder`` is ignored: the plain encoder is the
    only one the port has, and it is the JAX package's
    ``fused_encoder=False`` path."""
    for field, ok, item in _SUPPORTED:
        v = getattr(config, field)
        if v not in ok:
            raise NotImplementedError(
                f"{field}={v!r} is not ported yet (supported: {list(ok)}); "
                f"see ROADMAP.md {item}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving parameters of the port's engine and HTTP server.

    Shape policy: images are aligned to ``divis_by`` and rounded up to
    ``bucket_multiple`` (``ops.image.BucketPadder``); ``buckets`` are the
    image shapes warmed at startup; every request runs ``serve_iters`` GRU
    iterations."""

    host: str = "127.0.0.1"
    port: int = 8080  # 0 binds an ephemeral port
    divis_by: int = 32
    bucket_multiple: int = 64
    buckets: Tuple[Tuple[int, int], ...] = ((540, 960),)
    serve_iters: int = 32

    def __post_init__(self):
        object.__setattr__(self, "buckets",
                           tuple(tuple(int(v) for v in b)
                                 for b in self.buckets))
        if self.divis_by < 1 or self.bucket_multiple < 1:
            raise ValueError("divis_by and bucket_multiple must be >= 1")
        if self.serve_iters < 1:
            raise ValueError(f"serve_iters {self.serve_iters} < 1")
