"""PointNet classifier: AdaptEvery's point-cloud discriminator.

Counterpart of ``slcl_tpu/models/pointnet.py`` (reference
model/PointNetCls.py): the transform net ``STN`` (-> (N, k, k)),
``PointNetFeat`` (the global feature), ``PointNetCls`` (logits, trans,
trans_feat) and ``feature_transform_regularizer``. Points are (N, P, D),
as in the JAX package; a pointwise layer is a ``Linear`` on the last axis
and its BatchNorm (flax's, momentum 0.9) takes every point of every cloud
as one value of its channel. Linear kernels are uniform(+-1/sqrt(fan_in)),
flax's ``torch_conv_init``; biases and the STN's last kernel zero.
Submodule names are flax's (``feat.stn._MLP1d_0.Dense_0``,
``BatchNorm_0``, ``Dropout_0``, ...); ``base`` is the width knob (64 is
reference-exact).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import BatchNorm, Dropout, name_dropouts


def _dense(in_f: int, out_f: int, generator=None, zero: bool = False) -> nn.Linear:
    lin = nn.Linear(in_f, out_f)
    with torch.no_grad():
        if zero:
            lin.weight.zero_()
        else:
            bound = 1.0 / math.sqrt(in_f)
            nn.init.uniform_(lin.weight, -bound, bound, generator=generator)
        lin.bias.zero_()
    return lin


class _MLP1d(nn.Module):
    """Pointwise Dense -> BatchNorm -> ReLU over the last axis."""

    def __init__(self, in_f: int, features: int, relu: bool = True, generator=None):
        super().__init__()
        self.Dense_0 = _dense(in_f, features, generator)
        self.BatchNorm_0 = BatchNorm(features)
        self.relu = relu

    def forward(self, x):
        y = self.Dense_0(x)
        y = self.BatchNorm_0(y.reshape(-1, y.shape[-1])).reshape(y.shape)
        return F.relu(y) if self.relu else y


class STN(nn.Module):
    """Spatial / feature transform net: (N, P, k) -> (N, k, k)."""

    def __init__(self, k: int = 3, base: int = 64, generator=None):
        super().__init__()
        b, g = base, generator
        self.k = k
        widths = (b, b * 2, b * 16, b * 8, b * 4)
        prev = k
        for i, w in enumerate(widths):
            self.add_module(f"_MLP1d_{i}", _MLP1d(prev, w, generator=g))
            prev = w
        self.Dense_0 = _dense(prev, k * k, zero=True)

    def forward(self, x):
        y = x
        for i in range(3):
            y = getattr(self, f"_MLP1d_{i}")(y)
        y = y.max(dim=1).values                                   # (N, 16b)
        y = self._MLP1d_4(self._MLP1d_3(y))
        y = self.Dense_0(y)
        iden = torch.eye(self.k, dtype=y.dtype, device=y.device).reshape(1, -1)
        return (y + iden).reshape(-1, self.k, self.k)


class PointNetFeat(nn.Module):
    def __init__(self, global_feat: bool = True, feature_transform: bool = False,
                 base: int = 64, in_dim: int = 3, generator=None):
        super().__init__()
        b, g = base, generator
        self.global_feat = global_feat
        self.feature_transform = feature_transform
        self.stn = STN(k=in_dim, base=b, generator=g)
        self._MLP1d_0 = _MLP1d(in_dim, b, generator=g)
        if feature_transform:
            self.fstn = STN(k=b, base=b, generator=g)
        self._MLP1d_1 = _MLP1d(b, b * 2, generator=g)
        self._MLP1d_2 = _MLP1d(b * 2, b * 16, relu=False, generator=g)

    def forward(self, x):
        trans = self.stn(x)
        x = self._MLP1d_0(torch.bmm(x, trans))
        trans_feat = None
        if self.feature_transform:
            trans_feat = self.fstn(x)
            x = torch.bmm(x, trans_feat)
        point_feat = x
        x = self._MLP1d_2(self._MLP1d_1(x)).max(dim=1).values     # (N, 16b)
        if self.global_feat:
            return x, trans, trans_feat
        rep = x[:, None, :].expand(-1, point_feat.shape[1], -1)
        return torch.cat([point_feat, rep], dim=-1), trans, trans_feat


class PointNetCls(nn.Module):
    """(N, P, D) points -> (logits (N, k), trans, trans_feat)."""

    def __init__(self, k: int = 2, feature_transform: bool = False, base: int = 64,
                 in_dim: int = 3, generator: Optional[torch.Generator] = None):
        super().__init__()
        b, g = base, generator
        self.feat = PointNetFeat(True, feature_transform, b, in_dim, generator=g)
        self._MLP1d_0 = _MLP1d(b * 16, b * 8, generator=g)
        self.Dropout_0 = Dropout(0.3)
        self._MLP1d_1 = _MLP1d(b * 8, b * 4, generator=g)
        self.Dense_0 = _dense(b * 4, k, g)
        name_dropouts(self)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                                Optional[torch.Tensor]]:
        feat, trans, trans_feat = self.feat(x)
        y = self._MLP1d_1(self.Dropout_0(self._MLP1d_0(feat)))
        return self.Dense_0(y), trans, trans_feat


def feature_transform_regularizer(trans: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ||I - A A^T||_F (PointNetCls.py:224-238)."""
    t = trans.float()
    eye = torch.eye(t.shape[1], dtype=t.dtype, device=t.device)
    prod = torch.bmm(t, t.transpose(1, 2))
    return torch.linalg.matrix_norm(eye[None] - prod).mean()
