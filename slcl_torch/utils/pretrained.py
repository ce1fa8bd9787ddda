"""ImageNet encoder import for the ResNet-backed segmentors (ResNetUNet,
DeepLabV2): the ``smp`` ``encoder_weights='imagenet'`` equivalent.

Counterpart of ``slcl_tpu/utils/torch_convert.py`` ``convert_resnet_encoder``,
``merge_pretrained`` and ``load_pretrained_encoder``. It reads a local file
and fetches nothing:

- a torchvision-format ResNet state dict (``.pth``/``.pt``, read with
  ``torch.load(weights_only=True)``; a ``model_state_dict`` or
  ``state_dict`` wrapper is unwrapped);
- the JAX package's converted archive (``scripts/convert_torch.py``: an
  ``.npz`` of ``params``/``batch_stats`` trees in flax layout).

torchvision's ``conv1``/``bn1`` and ``layer{L}.{b}.{conv,bn}{1..3}`` keep
their names, ``layer{L}.{b}.downsample.{0,1}`` become ``down_conv``/
``down_bn`` and the blocks ``layer{L}_{b}``. ``fc.*`` and
``num_batches_tracked`` are ignored. Every trunk entry of the model must
come from the file (a missing one raises ``KeyError``) with its shape (else
``ValueError``); file entries with no model counterpart are reported.
"""
from __future__ import annotations

import os
import re
from typing import Dict, List, Tuple

import torch
from torch import nn

from .convert import load_tree_npz, map_flax

# the JAX trainer's (trainer.py:243): its resnet101 alias has no import
ENCODER_BACKBONES = ("resnet50", "resnet50_unet", "deeplabv2")
_TRUNK = re.compile(r"^(conv1|bn1)\.|^layer[1-4]_\d+\.")
_BLOCK = re.compile(r"^layer(\d+)\.(\d+)\.(.+)$")
_DOWN = (("downsample.0.", "down_conv."), ("downsample.1.", "down_bn."))


def port_key(key: str) -> str:
    """The port's name of a torchvision ResNet state-dict key."""
    m = _BLOCK.match(key)
    if not m:
        return key
    layer, block, rest = m.groups()
    for src, dst in _DOWN:
        if rest.startswith(src):
            rest = dst + rest[len(src):]
    return f"layer{layer}_{block}.{rest}"


def _ignored(key: str) -> bool:
    return key.startswith("fc.") or key.endswith("num_batches_tracked")


def read_encoder(path: str, seg: nn.Module) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """``(entries under the port's names, file keys with no model
    counterpart)`` from ``path``."""
    target = seg.state_dict()
    if str(path).endswith(".npz"):
        trees = load_tree_npz(path)
        return map_flax(seg, trees["params"], trees.get("batch_stats"))
    sd = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("model_state_dict", "state_dict"):
        if isinstance(sd, dict) and wrapper in sd:
            sd = sd[wrapper]
    out, unmatched = {}, []
    for key, val in sd.items():
        if _ignored(key):
            continue
        name = port_key(key)
        if name not in target:
            unmatched.append(key)
            continue
        ref = target[name]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"{key} -> {name}: shape {tuple(val.shape)} != "
                             f"{tuple(ref.shape)}")
        out[name] = val.detach().to(dtype=ref.dtype, device=ref.device)
    return out, unmatched


def load_pretrained_encoder(seg: nn.Module, path: str, backbone: str) -> dict:
    """Load the encoder trunk of ``seg`` from ``path`` in place; returns
    ``{'loaded': n, 'unmatched': [...]}`` and prints it. Raises where the
    JAX trainer prints and trains from scratch: a backbone with no encoder
    import, or no file at ``path``."""
    if backbone.lower() not in ENCODER_BACKBONES:
        raise ValueError(f"model.pretrained=true: backbone {backbone!r} has no ImageNet "
                         f"encoder import (one of {ENCODER_BACKBONES})")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            f"model.pretrained=true but model.pretrained_ckpt={path!r} is no file (a "
            "local torchvision ResNet .pth or the JAX package's converted .npz)")
    entries, unmatched = read_encoder(path, seg)
    missing = sorted(k for k in seg.state_dict() if _TRUNK.match(k) and k not in entries)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} encoder entries of the model: "
                       f"{missing[:8]}")
    seg.load_state_dict(entries, strict=False)
    print(f"[pretrained] loaded {len(entries)} tensors from {path}"
          + (f"; unmatched: {unmatched}" if unmatched else ""))
    return {"loaded": len(entries), "unmatched": unmatched}
