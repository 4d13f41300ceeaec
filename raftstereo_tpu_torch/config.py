"""Configuration of the PyTorch port.

``RAFTStereoConfig`` and ``TrainConfig`` keep the field names and
defaults of the JAX package's configs (``raftstereo_tpu/config.py``) so
one set of flags describes both.  The port runs fp32 with any of the
four correlation backends: ``pallas_alt`` (``auto``; the on-demand lookup,
CUDA kernels forward and backward), ``pallas`` (the precomputed volume
and its lookup, CUDA kernels forward and backward), and ``reg`` and
``alt`` (the JAX package's XLA lookups, plain PyTorch).  ``corr_quant``
builds the int8 volume (a CUDA kernel) and looks it up with ``pallas``,
in inference only; training builds the fp32 volume whatever the flag
says, as the JAX package does.  Inference takes the fused finest-level
GRU update (a CUDA kernel) or the module step, training always the module
step.  The encoders are the plain ones, or with ``fused_encoder=True`` the
fused stem + layer1 and layer2 stages (CUDA kernels, and their
hand-written backward in training).

``compute_dtype="bfloat16"`` (the JAX package's ``--mixed_precision``)
runs inference and training in bf16 with the plain or the fused encoder
stages (their bf16 kernels, and in training their bf16 backward) and any
backend; ``corr_dtype="bfloat16"`` then stores the on-demand lookup's
feature maps in bf16 (``pallas_alt``), or the ``pallas`` volume pyramid
in bf16; ``reg`` and ``alt`` build in fp32 whatever it says, as the JAX
package does.  With ``corr_quant`` the int8 volume comes out in
``corr_dtype`` (the int8 tier: bf16); training builds the unquantized
volume.  ``check_dtypes`` refuses the bf16 combinations outside
those paths.  Every other field value that
selects another path raises ``NotImplementedError`` naming the ROADMAP
item that will add it.
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
    JAX package's "auto" takes on its accelerator.  ``corr_quant`` (the
    int8 volume, test mode only) overrides the backend with "pallas", as
    on the accelerator (``ops.corr.resolve_implementation``)."""

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


# Every correlation backend of the JAX package; "auto" is "pallas_alt".
CORR_IMPLEMENTATIONS = ("auto", "reg", "alt", "pallas", "pallas_alt")

# (field, values this slice runs, ROADMAP item that adds the rest)
_SUPPORTED = (
    ("corr_implementation", CORR_IMPLEMENTATIONS, "Queue 1 item 2"),
    ("gru_backend", ("auto", "fused", "xla"), "Queue 1 item 3"),
    ("corr_quant", (False, True), "Queue 1 item 7"),
    ("compute_dtype", ("float32", "bfloat16"), "Queue 1 item 3"),
    ("corr_dtype", ("float32", "bfloat16"), "Queue 1 item 7"),
    ("corr_precision", ("highest",),
     "Queue 1 item 2 (corr_precision high/default: reduced-precision "
     "volume and lookup products)"),
    ("shared_backbone", (False,), "Queue 1 item 1 (shared backbone)"),
    ("input_mode", ("passive",), "Queue 1 item 9 (structured light)"),
    ("spatial_shards", (1,), "Queue 1 item 10 (spatial sharding)"),
    ("context_norm", ("batch", "instance"),
     "Queue 1 item 3 (group norm, no norm)"),
    ("slow_fast_gru", (False,), "Queue 1 item 3 (slow_fast schedule)"),
)


def check_supported(config: RAFTStereoConfig) -> None:
    """Raise ``NotImplementedError`` for any field value outside the
    port's paths.  ``fused_encoder`` None and False run the plain encoders
    (the JAX package's ``fused_encoder=False`` path, and its ``None`` off
    the TPU); True runs the fused encoder stages."""
    for field, ok, item in _SUPPORTED:
        v = getattr(config, field)
        if v not in ok:
            raise NotImplementedError(
                f"{field}={v!r} is not ported yet (supported: {list(ok)}); "
                f"see ROADMAP.md {item}")
    check_dtypes(config)


def check_dtypes(config: RAFTStereoConfig) -> None:
    """The bf16 paths, in inference and training: bf16 compute with the
    plain or the fused encoders, the on-demand lookup with bf16 or fp32
    feature maps (its backward's bf16 or fp32 form), ``reg``/``alt`` (fp32
    lookups cast to bf16), ``pallas`` with its fp32 or bf16 volume, and in
    inference the int8 tier (``corr_quant``; training builds the
    unquantized volume of the configured backend).  Refused: bf16
    correlation at fp32 compute."""
    if config.corr_dtype == "bfloat16" and config.compute_dtype != "bfloat16":
        raise NotImplementedError(
            "corr_dtype='bfloat16' with compute_dtype='float32' (bf16 "
            "correlation at fp32 compute) is not ported yet; see ROADMAP.md "
            "Queue 1 item 7")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training-loop hyper-parameters, the JAX package's ``TrainConfig``
    (reference recipe: batch 6, 320x720 crops, 16 GRU iterations, AdamW +
    OneCycle, gradient clip 1.0)."""

    name: str = "raft-stereo"
    batch_size: int = 6
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    lr: float = 2e-4
    num_steps: int = 100000
    image_size: Tuple[int, int] = (320, 720)
    train_iters: int = 16
    valid_iters: int = 32
    wdecay: float = 1e-5
    loss_gamma: float = 0.9
    max_flow: float = 700.0
    grad_clip: float = 1.0
    seed: int = 1234
    validation_frequency: int = 10000
    checkpoint_dir: str = "checkpoints"
    restore_ckpt: Optional[str] = None
    keep_checkpoints: int = 5

    # Data augmentation: img_gamma is (GMIN, GMAX) or (GMIN, GMAX,
    # GAIN_MIN, GAIN_MAX).
    img_gamma: Optional[Tuple[float, ...]] = None
    saturation_range: Optional[Tuple[float, float]] = None
    do_flip: Optional[str] = None  # None | "h" | "v"
    spatial_scale: Tuple[float, float] = (0.0, 0.0)
    noyjitter: bool = False
    device_photometric: bool = False

    # Data-parallel shards; None and 1 run on one device.
    data_parallel: Optional[int] = None

    # "abort": raise on a non-finite loss or gradient; "skip": keep the
    # parameters and Adam moments, advance the schedule.
    nan_policy: str = "abort"
    # Restarts from the latest checkpoint without step progress before
    # the loop gives up, and the base of their exponential back-off (s).
    max_restarts: int = 0
    restart_backoff: float = 1.0

    # Data pipeline: per-sample retries, quarantine bound, worker timeout.
    sample_retries: int = 2
    quarantine_limit: int = 64
    loader_timeout_s: float = 300.0

    # Flag a step slower than this multiple of the running median (0 off).
    watchdog_factor: float = 10.0

    def __post_init__(self):
        if self.nan_policy not in ("abort", "skip"):
            raise ValueError(f"nan_policy {self.nan_policy!r} not in "
                             f"('abort', 'skip')")
        for f in ("train_datasets", "image_size", "spatial_scale",
                  "img_gamma", "saturation_range"):
            v = getattr(self, f)
            if isinstance(v, list):
                object.__setattr__(self, f, tuple(v))


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Serving parameters of the port's engine and HTTP server.

    Shape policy: images are aligned to ``divis_by`` and rounded up to
    ``bucket_multiple`` (``ops.image.BucketPadder``); ``buckets`` are the
    image shapes warmed at startup; every request runs ``serve_iters`` GRU
    iterations.

    Accuracy tiers (``ops.quant``): ``tiers`` names the tiers offered on
    ``/predict``'s ``accuracy`` field ("certified" fp32, "fast" bf16,
    "turbo" the int8 volume in bf16).  "fast" and "turbo" are advertised
    only where ``cert_manifest`` (written by ``cli.certify``) certifies
    their EPE delta for this model on this platform
    (``eval.certify.resolve_tiers``); a refused tier is a 400 carrying its
    reason.  Empty: any ``accuracy`` field is a 400."""

    host: str = "127.0.0.1"
    port: int = 8080  # 0 binds an ephemeral port
    divis_by: int = 32
    bucket_multiple: int = 64
    buckets: Tuple[Tuple[int, int], ...] = ((540, 960),)
    serve_iters: int = 32
    tiers: Tuple[str, ...] = ()
    cert_manifest: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "buckets",
                           tuple(tuple(int(v) for v in b)
                                 for b in self.buckets))
        from .ops.quant import TIERS

        object.__setattr__(self, "tiers", tuple(self.tiers))
        bad = [t for t in self.tiers if t not in TIERS]
        if bad:
            raise ValueError(f"unknown accuracy tiers {bad}; choose from "
                             f"{list(TIERS)}")
        if self.divis_by < 1 or self.bucket_multiple < 1:
            raise ValueError("divis_by and bucket_multiple must be >= 1")
        if self.serve_iters < 1:
            raise ValueError(f"serve_iters {self.serve_iters} < 1")
