"""Accuracy-tier certification: measured EPE deltas against fp32.

The port's copy of the JAX package's ``eval/certify.py`` (its tier half).
A tier ("fast": bf16; "turbo": bf16 with the int8 volume) is offered on
``/predict`` only where a certification manifest bounds its accuracy
cost for this model on this platform:

* ``certify_tiers`` runs synthetic pairs with exact ground truth
  (``data.synthetic.ShiftStereoDataset``) through the fp32 reference and
  through each tier's model (the same weights, only the numeric-policy
  fields swapped, ``ops.quant.config_for_mode``) and records each tier's
  mean-EPE delta against its bound;
* ``write_manifest`` / ``load_manifest`` keep that manifest as JSON
  (``cli.certify`` writes it);
* ``resolve_tiers`` is the server's startup gate: a tier is advertised
  only when ``tier_ok`` finds it certified, within bound, for this
  architecture and on this platform; every other case refuses it with a
  recorded reason (a request for it is a 400).

The manifest's ``platform`` is the port's fingerprint: framework
"torch", the device type ("cuda" or "cpu") and, on the card, the
device's name.  Deltas measured on another platform, including every
manifest the JAX package writes, certify nothing here: the kernels that
``/predict`` would run are another program.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.quant import (TIER_MODES, TIERS, config_for_mode,
                         mode_for_accuracy)

logger = logging.getLogger(__name__)

MANIFEST_VERSION = 1

# Default mean-EPE-delta bounds (px) on the synthetic certification set,
# the JAX package's: loose screens that a broken dequant or a mis-keyed
# model fails by pixels, with the measured delta recorded beside them.
DEFAULT_BOUNDS = {"fast": 0.5, "turbo": 1.0}

# Config fields that must match between certification and serving: all
# but the three a tier swaps (compute_dtype, corr_dtype, corr_quant).
ARCH_FIELDS = ("corr_levels", "corr_radius", "n_downsample", "n_gru_layers",
               "hidden_dims", "slow_fast_gru", "shared_backbone",
               "context_norm", "corr_implementation", "corr_precision",
               "fused_encoder", "gru_backend", "input_mode")


def _arch_of(config) -> Dict[str, object]:
    d = dataclasses.asdict(config)
    return {k: (list(v) if isinstance(v, tuple) else v)
            for k, v in d.items() if k in ARCH_FIELDS}


def platform_of(device) -> Dict[str, str]:
    """The platform fingerprint of ``device``: the framework, the device
    type and, for a CUDA device, its name."""
    dev = torch.device(device)
    fp = {"framework": "torch", "device": dev.type}
    if dev.type == "cuda":
        fp["name"] = torch.cuda.get_device_name(dev)
    return fp


def _cert_data(hw: Tuple[int, int], n_pairs: int, seed: int):
    """The certification set, stacked: (lefts, rights, gts, description);
    passive pairs, valid everywhere."""
    from ..data.synthetic import ShiftStereoDataset

    ds = ShiftStereoDataset(n=n_pairs, hw=hw, seed=seed)
    items = [ds[i] for i in range(n_pairs)]
    return (np.stack([it[1] for it in items]),
            np.stack([it[2] for it in items]),
            np.stack([it[3] for it in items]),      # (N, H, W, 1)
            "synthetic ShiftStereoDataset (exact GT)")


def certify_tiers(model, tiers: Sequence[str] = ("fast", "turbo"), *,
                  hw: Tuple[int, int] = (64, 96), n_pairs: int = 4,
                  iters: int = 12, seed: int = 0,
                  bounds: Optional[Dict[str, float]] = None) -> Dict:
    """Measure each tier's EPE delta against the fp32 reference and build
    the certification manifest.  ``model`` (a ``RAFTStereo`` on its
    device) gives the architecture and the weights; every mode runs one
    batched test-mode forward of all pairs on that device, through a
    model that shares ``model``'s parameters.  ``bounds`` overrides
    ``DEFAULT_BOUNDS`` per tier."""
    bad = [t for t in tiers if t not in TIERS or t == "certified"]
    if bad:
        raise ValueError(f"cannot certify tiers {bad}: choose from "
                         f"{[t for t in TIERS if t != 'certified']}")
    bounds = {**DEFAULT_BOUNDS, **(bounds or {})}
    config = model.config
    lefts, rights, gts, data_desc = _cert_data(hw, n_pairs, seed)
    dev = model.device

    def run(mode: str) -> np.ndarray:
        m = model.with_numerics(config_for_mode(config, mode))
        _, up = m(torch.from_numpy(lefts).to(dev),
                  torch.from_numpy(rights).to(dev), iters=iters)
        return up.float().cpu().numpy()

    def epe(pred: np.ndarray) -> float:
        return float(np.abs(pred - gts).mean())

    ref = run("fp32")
    epe_ref = epe(ref)
    entries: Dict[str, Dict] = {}
    for tier in tiers:
        pred = run(TIER_MODES[tier])
        delta = epe(pred) - epe_ref
        bound = float(bounds[tier])
        entries[tier] = {
            "mode": TIER_MODES[tier],
            "epe": round(epe(pred), 6),
            "epe_delta": round(delta, 6),
            "bound": bound,
            "max_abs_disp_diff": round(float(np.abs(pred - ref).max()), 6),
            "certified": bool(delta <= bound),
        }
        logger.info("certify %s: epe %.4f (ref %.4f, delta %+.4f, bound "
                    "%.3f) -> %s", tier, entries[tier]["epe"], epe_ref,
                    delta, bound, "CERTIFIED" if entries[tier]["certified"]
                    else "OVER BOUND")
    return {
        "version": MANIFEST_VERSION,
        "created": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
        "platform": platform_of(dev),
        "model": _arch_of(config),
        "eval": {"hw": list(hw), "n_pairs": n_pairs, "iters": iters,
                 "seed": seed, "epe_ref": round(epe_ref, 6),
                 "data": data_desc},
        "tiers": entries,
    }


def write_manifest(manifest: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


def load_manifest(path: str) -> Dict:
    """Parse and shape-check a manifest; ``ValueError`` on bad JSON, a
    wrong version or a missing tier table."""
    with open(path) as f:
        try:
            manifest = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"certification manifest {path!r} is not "
                             f"valid JSON: {e}") from e
    if (not isinstance(manifest, dict)
            or manifest.get("version") != MANIFEST_VERSION
            or not isinstance(manifest.get("tiers"), dict)):
        raise ValueError(
            f"certification manifest {path!r} has unsupported layout/"
            f"version (want version {MANIFEST_VERSION} with a 'tiers' "
            f"table)")
    return manifest


def tier_ok(manifest: Optional[Dict], tier: str, model_config=None,
            device=None) -> Tuple[bool, str]:
    """Whether ``manifest`` certifies ``tier`` for ``model_config``'s
    architecture and for serving on ``device``.  Returns ``(ok,
    reason)``; the reason is what the server records and returns in a
    400."""
    if tier not in TIER_MODES:
        return False, f"unknown tier {tier!r}"
    if manifest is None:
        return False, "no certification manifest"
    entry = manifest["tiers"].get(tier)
    if entry is None:
        return False, "tier not present in the certification manifest"
    if not entry.get("certified"):
        return False, (f"tier measured over bound (epe_delta "
                       f"{entry.get('epe_delta')} > bound "
                       f"{entry.get('bound')})")
    delta, bound = entry.get("epe_delta"), entry.get("bound")
    if not (isinstance(delta, (int, float)) and isinstance(bound,
                                                           (int, float))
            and delta <= bound):
        return False, (f"manifest inconsistent: epe_delta {delta!r} vs "
                       f"bound {bound!r}")
    have = manifest.get("platform")
    if not (isinstance(have, dict) and have.get("framework") == "torch"):
        return False, (f"manifest measured on platform {have!r}, not by "
                       f"the port: re-certify with python -m "
                       f"raftstereo_tpu_torch.cli.certify")
    if device is not None and have != platform_of(device):
        return False, (f"manifest measured on platform {have!r}, serving "
                       f"on {platform_of(device)!r}: re-certify on this "
                       f"platform")
    if model_config is not None:
        want = _arch_of(model_config)
        have = manifest.get("model", {})
        if have != want:
            diff = sorted(k for k in want if have.get(k) != want[k])
            return False, (f"manifest certifies a different model "
                           f"architecture (mismatched: {diff})")
    return True, "certified"


def resolve_tiers(serve_cfg, model_config=None, device=None
                  ) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The server's startup gate.  Returns ``(advertised, refused)``:
    tier -> precision mode for the tiers ``/predict`` accepts, and tier
    -> reason for the refused ones.  "certified" is the fp32 reference
    itself and needs no manifest."""
    advertised: Dict[str, str] = {}
    refused: Dict[str, str] = {}
    if not serve_cfg.tiers:
        return advertised, refused
    manifest, manifest_err = None, None
    if serve_cfg.cert_manifest:
        try:
            manifest = load_manifest(serve_cfg.cert_manifest)
        except (OSError, ValueError) as e:
            manifest_err = str(e)
    for tier in serve_cfg.tiers:
        if tier == "certified":
            advertised[tier] = mode_for_accuracy(tier)
            continue
        if manifest is None:
            refused[tier] = manifest_err or (
                "no certification manifest (--cert_manifest; python -m "
                "raftstereo_tpu_torch.cli.certify)")
            continue
        ok, reason = tier_ok(manifest, tier, model_config, device)
        if ok:
            advertised[tier] = mode_for_accuracy(tier)
        else:
            refused[tier] = reason
    for tier, reason in refused.items():
        logger.warning("accuracy tier %r NOT advertised: %s", tier, reason)
    return advertised, refused
