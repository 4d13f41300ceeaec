"""Weight bridge: the JAX package's ``variables`` tree -> the port's
``state_dict``.

The JAX package converts upstream PyTorch checkpoints into its
``variables`` by mapping each flax module path to an upstream torch
prefix (``raftstereo_tpu/utils/convert.py`` ``_translate_module`` and
``torch_to_variables``).  The port names its modules after those same
torch prefixes (``fnet.``, ``cnet.``, ``context_zqr_convs.``,
``update_block.``), so the inverse is a direct mapping: translate the
path, transpose HWIO kernels to OIHW, and map norm leaves
scale/bias/mean/var to weight/bias/running_mean/running_var.  One
difference from upstream: the port's GRUs keep the JAX package's fused
``convzr`` (z and r gates as one conv), so that leaf maps one to one.

The same fp32 state dict builds an fp32 or a bf16 model: the port keeps
its parameters in fp32 whatever the compute dtype and casts them at use,
as flax's ``dtype=bfloat16`` modules do (never ``model.bfloat16()``).

``variables`` is a nested dict of numpy arrays (for example from
``jax.device_get``) or a flat ``{"params/fnet/conv1/kernel": array}``
mapping such as an ``.npz`` written by ``flatten_variables``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
         "mean": "running_mean", "var": "running_var"}


def _translate_module(path: Tuple[str, ...]) -> str:
    """Flax module path (without the leaf name) -> torch module prefix."""
    top, rest = path[0], list(path[1:])
    if top == "zqr":
        if len(rest) != 1 or not rest[0].startswith("zqr"):
            raise KeyError(f"unexpected zqr path {path}")
        return f"context_zqr_convs.{rest[0][3:]}"

    def enc_part(parts):
        out = []
        for p in parts:
            if p.startswith("layer") and "_" in p:
                stage, blk = p[len("layer"):].split("_")
                out.append(f"layer{stage}.{blk}")
            elif p.startswith("head"):
                # head08_{hi}_res -> outputs08.{hi}.0, head08_{hi}_conv ->
                # outputs08.{hi}.1, head32_{hi}_conv -> outputs32.{hi}
                lvl = p[4:6]
                hi, kind = p[7:].split("_")
                if lvl == "32":
                    out.append(f"outputs32.{hi}")
                else:
                    out.append(f"outputs{lvl}.{hi}."
                               + ("0" if kind == "res" else "1"))
            elif p == "downsample_conv":
                out.append("downsample.0")
            elif p == "downsample_norm":
                out.append("downsample.1")
            else:
                out.append(p)
        return ".".join(out)

    if top in ("cnet", "fnet"):
        return f"{top}." + enc_part(rest)
    if top == "update":
        m = {"gru0": "gru08", "gru1": "gru16", "gru2": "gru32",
             "mask_conv1": "mask.0", "mask_conv2": "mask.2"}
        return "update_block." + ".".join(m.get(p, p) for p in rest)
    raise KeyError(f"unknown top-level module {top!r} (shared_backbone and "
                   f"structured-light trees are not ported yet)")


def _walk(tree: Mapping, path=()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def _leaves(variables: Mapping):
    """(collection, module path, leaf name, array) for every leaf of a
    nested or ``/``-flattened variables tree."""
    if variables and all(isinstance(k, str) and "/" in k
                         for k in variables):
        items = ((tuple(k.split("/")), v) for k, v in variables.items())
    else:
        items = _walk(variables)
    for path, arr in items:
        coll, *mods, leaf = path
        if coll not in ("params", "batch_stats"):
            raise KeyError(f"unknown collection {coll!r} at {path}")
        yield coll, tuple(mods), leaf, np.asarray(arr)


def variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a JAX ``variables`` tree: one torch
    tensor per JAX leaf.  Raises ``KeyError`` if two leaves map to one
    tensor."""
    sd: Dict[str, torch.Tensor] = {}
    for _, mods, leaf, arr in _leaves(variables):
        key = f"{_translate_module(mods)}.{_LEAF[leaf]}"
        if key in sd:
            raise KeyError(f"two JAX leaves map to {key}")
        if leaf == "kernel":
            if arr.ndim != 4:
                raise ValueError(f"{key}: kernel of rank {arr.ndim}")
            arr = np.transpose(arr, (3, 2, 0, 1))  # HWIO -> OIHW
        sd[key] = torch.tensor(arr, dtype=torch.float32)  # owns a copy
    return sd


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """Nested variables -> ``{"params/fnet/conv1/kernel": array}``, the
    layout ``--weights_npz`` reads (``np.savez(path, **flat)``)."""
    return {"/".join(p): np.asarray(v) for p, v in _walk(variables)}


def load_weights_npz(model: torch.nn.Module, path: str) -> None:
    """Load a flattened JAX ``variables`` ``.npz`` into ``model`` through
    the bridge (strict: every tensor of the model must be filled)."""
    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    model.load_state_dict(variables_to_state_dict(flat), strict=True)
