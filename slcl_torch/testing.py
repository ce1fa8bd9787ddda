"""Configurations that the CPU tests (``tests/test_torch_*.py``) and the card's
check (``chip_smoke.py``) share.

- :func:`build_shallow`: the shallow DeepLabV2 and UNet, which the factory
  does not build (it passes ``layers``/``base`` to ResNetUNet only, as
  JAX's does); :func:`shallow_segmentor` has the Trainer build one in place
  of the factory's network (the CPU tests); ``chip_smoke.py`` puts one in a
  built Trainer, whose discriminators its card checks were set on.
- :data:`SPATIAL_CELLS`: the spatial-partitioning cells on the published
  backbones, under ``model.remat`` and with RAIN's style net; each side
  sizes them its own way. :data:`CELL_RAIN` holds a cell's ``rain.*``
  settings and :func:`configure_cell` applies a cell's settings.
"""
import contextlib

# name -> (method, cfg.model overrides, the kind of shallow_segmentor or "")
SPATIAL_CELLS = {
    # the MCCL preset with RAIN's epsilon ascent, and RAIN-augmented
    # supervised segmentation, on DRUNet
    "mccl_rain": ("mccl", {}, ""),
    "rain_seg": ("rain", {"multilvl": False}, ""),
    # ... and with a sampling row per image (also data-parallel); DRUNet's
    # plain mccl preset
    "mccl_rain_mulstyle": ("mccl", {}, ""),
    "drunet_mccl": ("mccl", {}, ""),
    "resnet50_slcl": ("slcl", {"backbone": "resnet50"}, ""),
    "resnet50_mccl": ("mccl", {"backbone": "resnet50"}, ""),
    "unet_baseline": ("baseline", {"backbone": "unet"}, "unet"),
    "deeplabv2_advent": ("advent", {"backbone": "deeplabv2", "multilvl": True}, "deeplabv2"),
    "deeplabv2_adaptseg": ("adaptseg", {"backbone": "deeplabv2", "multilvl": True},
                           "deeplabv2"),
    "slcl_remat_full": ("slcl", {"remat": "full"}, ""),
    "slcl_remat_dots": ("slcl", {"remat": "dots"}, ""),
    # the UDA baselines on their own networks: DDFSeg (DDFNet, SegDecoder,
    # three PatchGANs), AdaptEvery's ResNetUNetPoint and BCLDeepLab, the
    # last two shallow (one block a stage, base 8)
    "ddfseg": ("ddfseg", {}, ""),
    "adaptevery_small": ("adaptevery", {"layers": (1, 1, 1, 1), "base": 8}, ""),
    "bcl_small": ("bcl", {"layers": (1, 1, 1, 1), "base": 8}, ""),
}


# a cell's cfg.rain overrides
CELL_RAIN = {
    "mccl_rain": {"enabled": True, "update_eps": True, "eps_iters": 2, "eps_clip": 3.0},
    "mccl_rain_mulstyle": {"enabled": True, "update_eps": True, "eps_iters": 2,
                           "eps_clip": 3.0, "mulstyle": True},
    "rain_seg": {"update_eps": True, "eps_iters": 2, "eps_clip": 3.0},
}


def configure_cell(cfg, name: str):
    """``cfg`` with the cell ``name``'s ``model`` (:data:`SPATIAL_CELLS`) and
    ``rain`` (:data:`CELL_RAIN`) settings; returns it."""
    for k, v in SPATIAL_CELLS.get(name, ("", {}, ""))[1].items():
        setattr(cfg.model, k, v)
    for k, v in CELL_RAIN.get(name, {}).items():
        setattr(cfg.rain, k, v)
    return cfg


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
