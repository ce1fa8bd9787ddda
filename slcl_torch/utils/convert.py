"""flax -> torch weight carry-over for the port's modules.

Turns the JAX package's variables, given as nested dicts of numpy arrays
(``params`` and optionally ``batch_stats``), into a ``state_dict`` for a
port module whose submodule names are flax's (``DRUNet``,
``UncertaintyDiscriminator``). The layout rules are those of
``slcl_tpu/utils/torch_convert.py:11-15`` in reverse:

  conv kernel (kH, kW, I, O)   -> weight (O, I, kH, kW)
  BatchNorm params scale/bias  -> weight/bias
  batch_stats mean/var         -> running_mean/running_var

It raises on any flax leaf it leaves unused, any module entry it leaves
unset, and any shape that does not match.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    return np.transpose(arr, (3, 2, 0, 1)) if leaf == "kernel" else arr


def flax_to_state_dict(module: nn.Module, params: Mapping[str, Any],
                       batch_stats: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Map flax ``params``/``batch_stats`` onto ``module.state_dict()``'s
    keys, dtypes and devices. Raises ``KeyError`` on unused or missing
    entries and ``ValueError`` on shape mismatches."""
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unused = []
    for tree, leaves in ((params, _PARAM_LEAF), (batch_stats or {}, _STAT_LEAF)):
        for key, arr in _flatten(tree).items():
            path, _, leaf = key.rpartition(".")
            if leaf not in leaves:
                unused.append(key)
                continue
            tkey = f"{path}.{leaves[leaf]}" if path else leaves[leaf]
            if tkey not in target:
                unused.append(key)
                continue
            val = _torch_layout(leaf, arr)
            ref = target[tkey]
            if tuple(val.shape) != tuple(ref.shape):
                raise ValueError(f"{key} -> {tkey}: shape {tuple(val.shape)} "
                                 f"!= {tuple(ref.shape)}")
            out[tkey] = torch.from_numpy(np.ascontiguousarray(val)).to(
                dtype=ref.dtype, device=ref.device)
    if unused:
        raise KeyError(f"flax entries with no torch counterpart: {unused}")
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"torch entries not set from flax: {missing}")
    return out


def load_flax_weights(module: nn.Module, params: Mapping[str, Any],
                      batch_stats: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """Copy flax variables into ``module`` in place (strict)."""
    module.load_state_dict(flax_to_state_dict(module, params, batch_stats),
                           strict=True)
    return module


def state_dict_to_flax(module: nn.Module) -> Dict[str, Dict[str, Any]]:
    """The inverse map: ``{'params': ..., 'batch_stats': ...}`` nested dicts
    of numpy arrays in flax layout (for comparing trained weights)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    bn_paths = {name for name, m in module.named_modules()
                if hasattr(m, "running_var")}
    for key, t in module.state_dict().items():
        path, _, leaf = key.rpartition(".")
        arr = t.detach().cpu().float().numpy().copy()
        if leaf in ("running_mean", "running_var"):
            tree, fleaf = stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight" and path in bn_paths:
            tree, fleaf = params, "scale"
        elif leaf == "weight":
            tree, fleaf = params, "kernel"
            arr = np.transpose(arr, (2, 3, 1, 0))
        else:
            tree, fleaf = params, leaf
        node = tree
        for part in path.split(".") if path else []:
            node = node.setdefault(part, {})
        node[fleaf] = arr
    return {"params": params, "batch_stats": stats}
