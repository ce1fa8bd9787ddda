"""PyTorch/CUDA port of ``slcl_tpu`` for one NVIDIA H100.

Module names follow ``slcl_tpu`` so each module's counterpart is easy to
find. Public functions keep the JAX package's layouts (images, logits and
features NHWC; labels NHW; class centres (C, F)). The contrastive hot loop
(MPCL, cosine pseudo-labels, soft centroids) runs in hand-written CUDA
kernels under ``slcl_torch/csrc``; their plain PyTorch versions serve CPU
tensors.

The package imports no JAX and nothing of ``slcl_tpu``.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. With no CUDA device and no explicit ``device`` it raises —
    the port never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "slcl_torch runs on CUDA by default and found no CUDA device; "
                "pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
