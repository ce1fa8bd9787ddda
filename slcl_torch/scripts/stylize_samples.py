"""Write a grid of RAIN style-transfer samples (counterpart of
``scripts/stylize_samples.py``): rows of [content | style | stylised], the
contents from the source domain's training set, the styles from the
target's, each panel min-max scaled, as one 8-bit grayscale PNG.

Usage:
  python -m slcl_torch.scripts.stylize_samples rain.vgg_ckpt=A \\
      rain.decoder_ckpt=B rain.fc_encoder_ckpt=C rain.fc_decoder_ckpt=D \\
      [data.dataset=synthetic data.gap=0.5] [out=examples/rain_samples.png] \\
      [n=4] [--device cpu]

All four component files are required: the reference's Sequential
``.pth``/``.pt`` files or the ``rain_<part>.npz`` files that
``method=pretrain_rain`` exports. Runs on CUDA unless ``--device`` names
another device; writes the PNG with ``slcl_torch/data/png.py`` (no cv2).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..data.png import write_png_gray
from ..models.rain import LATENT
from ..train.__main__ import parse_args


def _to_u8(x: np.ndarray) -> np.ndarray:
    """One panel, channel-averaged and min-max scaled to 0..255."""
    x = x.mean(-1) if x.ndim == 3 else x
    lo, hi = float(x.min()), float(x.max())
    return ((x - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)


def main(argv):
    if any(a in ("--help", "-h", "help") for a in argv):
        print(__doc__)
        return None
    cfg, device, extra = parse_args(argv, "rain", extra_keys=("out", "n"))
    opts = dict(a.split("=", 1) for a in extra)
    out_path, n = opts.get("out", "examples/rain_samples.png"), int(opts.get("n", 4))
    cfg.rain.enabled = True
    for key in ("vgg_ckpt", "decoder_ckpt", "fc_encoder_ckpt", "fc_decoder_ckpt"):
        path = getattr(cfg.rain, key)
        if not path or not Path(path).exists():
            raise SystemExit(f"missing rain.{key} checkpoint: {path!r}")
    from .. import resolve_device
    from ..data import prepare_datasets
    from ..train.trainer import build_rain

    dev = resolve_device(device)
    rain = build_rain(cfg, dev).eval()
    ds = prepare_datasets(cfg)
    contents = np.stack([np.asarray(ds["train_s"][i][0]) for i in range(n)])
    styles = np.stack([np.asarray(ds["train_t"][i][0]) for i in range(n)])
    gen = torch.Generator(device=dev).manual_seed(2)
    with torch.no_grad():
        noise = torch.randn(n, LATENT, generator=gen, device=dev)
        img, _ = rain.style_transfer(torch.from_numpy(contents).to(dev),
                                     torch.from_numpy(styles).to(dev), noise=noise)
    stylised = img.float().cpu().numpy()
    grid = np.concatenate([np.concatenate([_to_u8(contents[i]), _to_u8(styles[i]),
                                           _to_u8(stylised[i])], axis=1)
                           for i in range(n)], axis=0)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    write_png_gray(out_path, grid)
    print(f"wrote {out_path}: {n} rows of [content | style | stylized]")
    return grid


if __name__ == "__main__":
    main(sys.argv[1:])
