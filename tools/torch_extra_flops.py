"""Forward FLOPs of the networks of slcl_torch's DDFSeg, AdaptEvery and BCL
steps at full width, one 224x224 image each, counted by
``torch.utils.flop_counter`` on the CPU (multiply-adds counted as two).

Run from the root of a checkout:  python tools/torch_extra_flops.py
Prints one JSON object of TFLOP per image (DDFSeg's generator: one source
and one target image through DDFNet and the three SegDecoder passes).
"""
import json
import sys
from pathlib import Path

import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from slcl_torch.models.common import dropout_pass  # noqa: E402
from slcl_torch.models.ddfseg import DDFSeg  # noqa: E402
from slcl_torch.models.deeplabv2 import BCLDeepLab  # noqa: E402
from slcl_torch.models.discriminators import PatchGAN, UncertaintyDiscriminator  # noqa: E402
from slcl_torch.models.pointnet import PointNetCls  # noqa: E402
from slcl_torch.models.resnet_unet import ResNetUNetPoint  # noqa: E402


def tflop(fn) -> float:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops() / 1e12


def keep_all(path, call, shape, keep, device):
    return torch.ones(shape, dtype=torch.bool, device=device)


def main() -> dict:
    x = torch.zeros(1, 224, 224, 3)
    ddf = DDFSeg(4).train()

    def generator():
        with dropout_pass(keep_all):
            out = ddf.ddfnet(x, x)
        for key in ("content_s", "recon_content_s", "content_t"):
            with dropout_pass(keep_all):
                ddf.segdecoder(out[key])

    with torch.no_grad():
        out = {"ddfseg_generator": tflop(generator),
               "patchgan": tflop(lambda: PatchGAN(1)(torch.zeros(1, 224, 224, 1))),
               "resnet_unet_point": tflop(lambda: ResNetUNetPoint(4).train()(x)),
               "uncertainty_discriminator": tflop(
                   lambda: UncertaintyDiscriminator(4)(torch.zeros(1, 224, 224, 4))),
               "pointnet_300_points": tflop(
                   lambda: PointNetCls(k=1).eval()(torch.zeros(1, 300, 3))),
               "bcl_deeplab": tflop(lambda: BCLDeepLab(4).train()(x))}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    torch.set_num_threads(8)
    main()
