"""Configurations that the CPU tests (``tests/test_torch_*.py``) and the card's
check (``chip_smoke.py``) share.

- :func:`build_shallow`: the shallow DeepLabV2 and UNet, which the factory
  does not build (it passes ``layers``/``base`` to ResNetUNet only, as
  JAX's does); :func:`shallow_segmentor` has the Trainer build one in place
  of the factory's network (the CPU tests); ``chip_smoke.py`` puts one in a
  built Trainer, whose discriminators its card checks were set on.
- :data:`SPATIAL_CELLS`: the spatial-partitioning cells on the published
  backbones and under ``model.remat``; each side sizes them its own way.
"""
import contextlib

# name -> (method, cfg.model overrides, the kind of shallow_segmentor or "")
SPATIAL_CELLS = {
    "resnet50_slcl": ("slcl", {"backbone": "resnet50"}, ""),
    "resnet50_mccl": ("mccl", {"backbone": "resnet50"}, ""),
    "unet_baseline": ("baseline", {"backbone": "unet"}, "unet"),
    "deeplabv2_advent": ("advent", {"backbone": "deeplabv2", "multilvl": True}, "deeplabv2"),
    "deeplabv2_adaptseg": ("adaptseg", {"backbone": "deeplabv2", "multilvl": True},
                           "deeplabv2"),
    "slcl_remat_full": ("slcl", {"remat": "full"}, ""),
    "slcl_remat_dots": ("slcl", {"remat": "dots"}, ""),
}


def build_shallow(kind: str, model_cfg, generator=None):
    """``deeplabv2``: one block a stage, its widths and dilations whole;
    ``unet``: base 8."""
    from .models import DeepLabV2, UNet
    if kind == "deeplabv2":
        return DeepLabV2(model_cfg.num_classes, layers=(1, 1, 1, 1),
                         multi_level=model_cfg.multilvl, generator=generator)
    if kind == "unet":
        return UNet(model_cfg.num_classes, base=8, generator=generator)
    raise ValueError(f"unknown shallow segmentor {kind!r}")


@contextlib.contextmanager
def shallow_segmentor(kind: str):
    """Within the block the Trainer builds :func:`build_shallow`'s ``kind``
    from its seeded generator in place of the factory's network, then makes
    its optimizers (the DeepLab heads' 10x group), moves it and replicates
    or shards it as it would the factory's. ``kind`` "" changes nothing."""
    if not kind:
        yield
        return
    from .train import trainer as T
    factory = T.build_segmentor
    T.build_segmentor = lambda model_cfg, generator=None: build_shallow(kind, model_cfg,
                                                                         generator)
    try:
        yield
    finally:
        T.build_segmentor = factory
