"""flax -> torch weight carry-over for the port's modules.

Turns the JAX package's variables, given as nested dicts of numpy arrays
(``params`` and optionally ``batch_stats``), into a ``state_dict`` for a
port module whose submodule names are flax's (``DRUNet``, ``UNet``,
``ResNetUNet``, ``DeepLabV2``, ``UncertaintyDiscriminator``). The layout
rules are those of ``slcl_tpu/utils/torch_convert.py:11-15`` in reverse:

  conv kernel (kH, kW, I, O)   -> weight (O, I, kH, kW)
  Dense kernel (I, O)          -> Linear weight (O, I)
  ConvTranspose kernel (kH, kW, I, O) -> weight (I, O, kH, kW), flipped
                                  in both spatial axes (flax's
                                  ConvTranspose does not flip its kernel,
                                  torch's ConvTranspose2d does)
  BatchNorm params scale/bias  -> weight/bias (FrozenBatchNorm too)
  batch_stats mean/var         -> running_mean/running_var

It raises on any flax leaf it leaves unused, any module entry it leaves
unset, and any shape that does not match.

It also reads the RAIN component checkpoints: the reference's
Sequential-index ``.pth`` files (:func:`read_rain_component`) and the JAX
package's ``.npz`` trees (:func:`load_tree_npz`, written by
:func:`save_tree_npz`: object arrays of nested dicts).
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def _transposed_paths(module: nn.Module) -> set:
    return {name for name, m in module.named_modules()
            if isinstance(m, nn.ConvTranspose2d)}


def _torch_layout(leaf: str, arr: np.ndarray, transposed: bool) -> np.ndarray:
    if leaf != "kernel":
        return arr
    if arr.ndim == 2:
        return arr.T
    if transposed:
        return np.transpose(arr[::-1, ::-1], (2, 3, 0, 1))
    return np.transpose(arr, (3, 2, 0, 1))


def map_flax(module: nn.Module, params: Mapping[str, Any],
             batch_stats: Optional[Mapping[str, Any]] = None):
    """``(state_dict entries, unused flax keys)``: the flax leaves that
    have a counterpart in ``module`` in torch layout, on its dtypes and
    devices (a shape mismatch raises ``ValueError``), and the keys of those
    that have none."""
    target = module.state_dict()
    transposed = _transposed_paths(module)
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
            val = _torch_layout(leaf, arr, path in transposed)
            ref = target[tkey]
            if tuple(val.shape) != tuple(ref.shape):
                raise ValueError(f"{key} -> {tkey}: shape {tuple(val.shape)} "
                                 f"!= {tuple(ref.shape)}")
            out[tkey] = torch.from_numpy(np.ascontiguousarray(val)).to(
                dtype=ref.dtype, device=ref.device)
    return out, unused


def flax_to_state_dict(module: nn.Module, params: Mapping[str, Any],
                       batch_stats: Optional[Mapping[str, Any]] = None
                       ) -> Dict[str, torch.Tensor]:
    """Map flax ``params``/``batch_stats`` onto ``module.state_dict()``'s
    keys, dtypes and devices. Raises ``KeyError`` on unused or missing
    entries and ``ValueError`` on shape mismatches."""
    target = module.state_dict()
    out, unused = map_flax(module, params, batch_stats)
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
    transposed = _transposed_paths(module)
    for key, t in module.state_dict().items():
        path, _, leaf = key.rpartition(".")
        arr = t.detach().cpu().float().numpy().copy()
        if leaf in ("running_mean", "running_var"):
            tree, fleaf = stats, {"running_mean": "mean", "running_var": "var"}[leaf]
        elif leaf == "weight" and path in bn_paths:
            tree, fleaf = params, "scale"
        elif leaf == "weight":
            tree, fleaf = params, "kernel"
            if arr.ndim == 2:
                arr = np.ascontiguousarray(arr.T)
            elif path in transposed:
                arr = np.ascontiguousarray(np.transpose(arr, (2, 3, 0, 1))[::-1, ::-1])
            else:
                arr = np.transpose(arr, (2, 3, 1, 0))
        else:
            tree, fleaf = params, leaf
        node = tree
        for part in path.split(".") if path else []:
            node = node.setdefault(part, {})
        node[fleaf] = arr
    return {"params": params, "batch_stats": stats}


def save_tree_npz(path, **trees: Any) -> None:
    """Write parameter trees as the JAX package's ``save_tree_npz`` does
    (``slcl_tpu/utils/torch_convert.py``): one object array per tree, read
    back with ``np.load(path, allow_pickle=True)[name].item()``."""
    np.savez(path, **{k: np.array(v, dtype=object) for k, v in trees.items()})


def load_tree_npz(path) -> Dict[str, Any]:
    """The trees of a :func:`save_tree_npz` file (pickled object arrays)."""
    with np.load(path, allow_pickle=True) as z:
        return {k: z[k].item() for k in z.files}


# Sequential index of each conv or Linear in the reference's RAIN nets
# (model/RAIN.py: get_encoder() through relu4_1, get_decoder(), the fc
# Sequentials) -> the port's submodule name
RAIN_SEQUENTIAL = {
    "encoder": {0: "conv0", 2: "conv1_1", 5: "conv1_2", 9: "conv2_1", 12: "conv2_2",
                16: "conv3_1", 19: "conv3_2", 22: "conv3_3", 25: "conv3_4",
                29: "conv4_1"},
    "decoder": {1: "d1", 5: "d2_0", 8: "d2_1", 11: "d2_2", 14: "d3", 18: "d4",
                21: "d5", 25: "d6", 28: "d7"},
    "fc_encoder": {0: "Dense_0", 2: "Dense_1", 4: "Dense_2"},
    "fc_decoder": {0: "Dense_0", 2: "Dense_1", 4: "Dense_2"},
}
_SEQ_KEY = re.compile(r"^(\d+)\.(weight|bias)$")


def read_rain_component(path, name: str, module: nn.Module
                        ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``(state_dict entries of module, file entries it has no place for)``
    from one RAIN component file: a ``.pth``/``.pt`` in the reference's
    Sequential layout (torch layouts already; VGG layers past relu4_1 are
    skipped), else the JAX package's ``.npz`` tree (its ``params``). A shape
    mismatch raises ``ValueError``."""
    if not str(path).endswith((".pth", ".pt")):
        return map_flax(module, load_tree_npz(path)["params"])
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model_state_dict", "state_dict"):
        if isinstance(sd, dict) and wrapper in sd:
            sd = sd[wrapper]
    index = RAIN_SEQUENTIAL[name]
    target = module.state_dict()
    out, unmatched = {}, []
    for key, val in sd.items():
        m = _SEQ_KEY.match(key)
        if not m:
            unmatched.append(key)
            continue
        if int(m.group(1)) not in index:
            continue        # e.g. vgg_normalised's layers past relu4_1
        tkey = f"{index[int(m.group(1))]}.{m.group(2)}"
        ref = target[tkey]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{path}: {key} -> {tkey}: shape {tuple(val.shape)} != "
                             f"{tuple(ref.shape)}")
        out[tkey] = val.detach().to(dtype=ref.dtype, device=ref.device)
    return out, unmatched
