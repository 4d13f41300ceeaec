"""Shared CLI plumbing: logging, the model flags and weight loading.

One loader takes the three weight files the port meets, so every entry
point can restore from any of them:

* a flattened JAX ``variables`` ``.npz`` (``utils.convert.flatten_variables``
  saved with ``np.savez``), loaded through the weight bridge;
* the port's own ``train.checkpoint.save_weights`` file;
* an upstream RAFT-Stereo ``.pth`` (``module.`` prefixes, split GRU gate
  convs), converted on load.

The two torch formats are told apart by their keys: the port's fused
``convzr`` gate convs against upstream's ``convz``/``convr``.  Every load
is strict.
"""

from __future__ import annotations

import argparse
import logging

import torch

from ..config import CORR_IMPLEMENTATIONS, RAFTStereoConfig
from ..utils.convert import (load_upstream_state_dict, load_weights_npz,
                             upstream_to_state_dict)


def setup_logging(level=logging.INFO) -> None:
    logging.basicConfig(
        level=level, force=True,
        format="%(asctime)s %(levelname)-8s [%(filename)s:%(lineno)d] "
               "%(message)s")


def load_weights_any(path: str, model: torch.nn.Module) -> str:
    """Load ``path`` into ``model`` (strict); returns the format found:
    "npz", "port" or "upstream"."""
    if path.endswith(".npz"):
        load_weights_npz(model, path)
        return "npz"
    sd = load_upstream_state_dict(path)
    if any(".convzr." in k for k in sd):
        model.load_state_dict(sd, strict=True)
        return "port"
    if any(".convz." in k for k in sd):
        model.load_state_dict(
            upstream_to_state_dict(sd, model.config.n_gru_layers),
            strict=True)
        return "upstream"
    raise ValueError(f"{path}: neither the port's weights (convzr) nor an "
                     f"upstream RAFT-Stereo state dict (convz/convr)")


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The JAX package's model flags (``raftstereo_tpu/config.py``
    ``add_model_args``) with the port's defaults; values the port does not
    run raise ``NotImplementedError`` when the model is built."""
    m = RAFTStereoConfig()
    g = p.add_argument_group("model (defaults: the flagship config)")
    g.add_argument("--corr_implementation", default=m.corr_implementation,
                   choices=CORR_IMPLEMENTATIONS,
                   help="correlation backend; 'auto' = the on-demand "
                        "lookup kernel (pallas_alt)")
    g.add_argument("--corr_levels", type=int, default=m.corr_levels)
    g.add_argument("--corr_radius", type=int, default=m.corr_radius)
    g.add_argument("--n_downsample", type=int, default=m.n_downsample)
    g.add_argument("--n_gru_layers", type=int, default=m.n_gru_layers)
    g.add_argument("--hidden_dims", nargs="+", type=int,
                   default=list(m.hidden_dims))
    g.add_argument("--slow_fast_gru", action="store_true")
    g.add_argument("--shared_backbone", action="store_true")
    g.add_argument("--context_norm", default=m.context_norm,
                   choices=["group", "batch", "instance", "none"])
    g.add_argument("--mixed_precision", action="store_true",
                   help="bfloat16 compute for encoders and GRUs")
    g.add_argument("--corr_dtype", choices=["float32", "bfloat16"],
                   default=m.corr_dtype)
    g.add_argument("--corr_precision", default=m.corr_precision,
                   choices=["highest", "high", "default"])
    g.add_argument("--corr_quant", action="store_true",
                   help="int8 correlation volume, looked up by the pallas "
                        "backend (inference)")
    g.add_argument("--gru_backend", choices=["auto", "fused", "xla"],
                   default=m.gru_backend,
                   help="test-mode GRU step: 'auto' = the fused update "
                        "kernel")
    g.add_argument("--fused_encoder", action="store_true",
                   help="the fused stem + layer1 and layer2 encoder stages")
    g.add_argument("--input_mode", choices=["passive", "sl"],
                   default=m.input_mode)


def model_config_from_args(args: argparse.Namespace) -> RAFTStereoConfig:
    return RAFTStereoConfig(
        corr_implementation=args.corr_implementation,
        corr_levels=args.corr_levels, corr_radius=args.corr_radius,
        n_downsample=args.n_downsample, n_gru_layers=args.n_gru_layers,
        hidden_dims=tuple(args.hidden_dims),
        slow_fast_gru=args.slow_fast_gru,
        shared_backbone=args.shared_backbone,
        context_norm=args.context_norm,
        compute_dtype="bfloat16" if args.mixed_precision else "float32",
        corr_dtype=args.corr_dtype, corr_precision=args.corr_precision,
        corr_quant=args.corr_quant, gru_backend=args.gru_backend,
        fused_encoder=True if args.fused_encoder else None,
        input_mode=args.input_mode)
