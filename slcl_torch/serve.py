"""Serving: export a trained segmentor to a portable artifact (counterpart
of ``slcl_tpu/serve.py``).

The JAX package exports StableHLO through ``jax.export``; the port exports
the inference function through ``torch.export``, weights included, into
one file that any process with PyTorch, and NO model code, loads with
``torch.export.load``:

    magic ``SLCLT\\x01`` | 4-byte big-endian header length | JSON header |
    the ``torch.export.save`` payload

The header holds JAX's keys (``format``, ``platforms``, ``in_avals`` and
the caller's metadata) plus ``device`` (the device type it was exported
on) and ``dtype`` (the segmentor's compute dtype). The batch dimension is
symbolic (``torch.export.Dim``), so one artifact serves any batch size;
the crop and the channels stay static (resize on the host).

The exported forward keeps the evaluator's autocast region, and
``torch.export`` records that region with its device type. So an artifact
is exported on the device it will serve on, and loading it onto another
device type raises unless it is float32 (then the move is exact).

Produced by ``python -m slcl_torch.scripts.export``; round trip in
``tests/test_torch_serve.py``; on the card in ``chip_smoke.py``'s ``serve``
phase.
"""
from __future__ import annotations

import io
import json
import struct
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from . import DeviceLike, resolve_device
from .train.steps import autocast

_MAGIC = b"SLCLT\x01"
_JAX_MAGIC = b"SLCLX\x01"
FORMAT = "slclt-v1"


class InferFn(nn.Module):
    """Serving forward: (N, crop, crop, C) float32 -> (N, crop, crop) int32
    labels, with (N, crop, crop, classes) float32 softmax probabilities when
    ``with_probs``. The segmentor runs under the evaluator's autocast
    (``dtype``); ``pred_index`` 0 takes the main head, 1 the aux head; the
    argmax is over float32 logits, as ``Evaluator`` takes it."""

    def __init__(self, model: nn.Module, *, pred_index: int = 0,
                 with_probs: bool = False, dtype: str = "float32"):
        super().__init__()
        self.model = model
        self.pred_index = pred_index
        self.with_probs = with_probs
        self.dtype = dtype

    def forward(self, x: torch.Tensor):
        with autocast(self.dtype, x.device):
            out = self.model(x)
        logits = (out.pred if self.pred_index == 0 else out.aux).float()
        labels = torch.argmax(logits, dim=-1).to(torch.int32)
        if self.with_probs:
            return labels, torch.softmax(logits, dim=-1)
        return labels


def make_infer_fn(model: nn.Module, *, pred_index: int = 0, with_probs: bool = False,
                  dtype: str = "float32") -> InferFn:
    """The serving forward of ``model`` (see :class:`InferFn`), in eval
    mode: this puts ``model`` in eval mode."""
    return InferFn(model, pred_index=pred_index, with_probs=with_probs, dtype=dtype).eval()


def export_segmentor(model: nn.Module, *, crop: int, in_channels: int = 3,
                     pred_index: int = 0, with_probs: bool = False,
                     dtype: str = "float32") -> torch.export.ExportedProgram:
    """``torch.export`` of :func:`make_infer_fn` on the device ``model``
    lies on, traced at batch 2 with the batch dimension symbolic (``b``,
    any size from 1). The model's train / eval mode is restored afterwards."""
    was_training = model.training
    infer = make_infer_fn(model, pred_index=pred_index, with_probs=with_probs, dtype=dtype)
    x = torch.zeros(2, crop, crop, in_channels, device=next(model.parameters()).device)
    try:
        with torch.no_grad():
            return torch.export.export(infer, (x,),
                                       dynamic_shapes={"x": {0: torch.export.Dim("b", min=1)}})
    finally:
        model.train(was_training)


def _in_avals(exported: torch.export.ExportedProgram):
    user = set(exported.graph_signature.user_inputs)
    out = []
    for node in exported.graph.nodes:
        if node.op == "placeholder" and node.name in user:
            val = node.meta["val"]
            dt = str(val.dtype).replace("torch.", "")
            dims = (str(d) if isinstance(d, int) else "b" for d in val.shape)
            out.append(f"{dt}[{','.join(dims)}]")
    return out


def save_artifact(path, exported: torch.export.ExportedProgram,
                  meta: Optional[Dict[str, Any]] = None, *, dtype: str = "float32") -> None:
    """Write ``exported`` and its header as one file (module docstring).
    ``dtype`` is the compute dtype it was exported with."""
    meta = dict(meta or {})
    meta.setdefault("format", FORMAT)
    device = next((t.device for t in exported.state_dict.values()), torch.device("cpu"))
    meta["device"] = device.type
    meta["platforms"] = [device.type]
    meta["dtype"] = dtype
    meta["in_avals"] = _in_avals(exported)
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    header = json.dumps(meta).encode()
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(p, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">I", len(header)))
        f.write(header)
        f.write(buf.getvalue())


def read_artifact(path) -> Tuple[Dict[str, Any], bytes]:
    """(header, ``torch.export`` payload) of an artifact file. A file of
    another kind raises ``ValueError`` naming its magic; a JAX ``slclx``
    artifact says which package reads it."""
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
        if magic == _JAX_MAGIC:
            raise ValueError(f"{path}: a JAX slclx artifact (magic {magic!r}); "
                             "slcl_tpu.serve.load_artifact reads it, under JAX")
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an slcl_torch artifact (magic {magic!r})")
        (hlen,) = struct.unpack(">I", f.read(4))
        meta = json.loads(f.read(hlen).decode())
        return meta, f.read()


def load_artifact(path, device: DeviceLike = None) -> Tuple[Callable, Dict[str, Any]]:
    """Load an artifact -> (callable, header). Needs only PyTorch, none of
    the model code. The callable takes an (N, crop, crop, C) float32
    tensor on ``device`` (CUDA unless named) and runs without autograd.
    Loading onto another device type than the export's raises unless the
    artifact is float32, whose move is exact."""
    meta, payload = read_artifact(path)
    target = resolve_device(device)
    if target.type != meta["device"] and meta.get("dtype", "float32") != "float32":
        raise ValueError(
            f"{path}: exported on {meta['device']} under {meta['dtype']} autocast, "
            f"which torch.export records with its device type; it cannot serve on "
            f"{target.type}: export it on {target.type}")
    exported = torch.export.load(io.BytesIO(payload))
    from torch.export.passes import move_to_device_pass
    exported = move_to_device_pass(exported, target)
    module = exported.module()

    def fn(x: torch.Tensor):
        with torch.no_grad():
            return module(x)

    return fn, meta


def _main(argv) -> int:
    """``python -m slcl_torch.serve model.slclt <img_or_dir> [out_dir] [bs=N]
    [--device cpu]``

    Deployment-side batch server: load the artifact, read the 8-bit
    grayscale PNGs of a directory (or one file), resize each to the crop
    (cv2's INTER_LINEAR on uint8), z-score it, run the batches (the last
    one ragged) and write ``<stem>_pred.png`` = label x 60. Uses only this
    module and the port's PNG and resize code; a JPEG raises (no decoder)."""
    from .data.imgproc import resize_linear
    from .data.png import read_png_gray, write_png_gray

    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 2:
        print(_main.__doc__)
        return 2
    bs = int(next((a.split("=")[1] for a in argv if a.startswith("bs=")), "16"))
    argv = [a for a in argv if not a.startswith("bs=")]
    art, src = argv[0], Path(argv[1])
    out = Path(argv[2]) if len(argv) > 2 else Path("preds")
    out.mkdir(parents=True, exist_ok=True)

    fn, meta = load_artifact(art, device)
    dev = resolve_device(device)
    crop = int(meta.get("crop", 224))
    paths = (sorted(src.glob("*.png")) + sorted(src.glob("*.jpg"))
             if src.is_dir() else [src])
    if not paths:
        print(f"no images under {src}")
        return 1
    jpegs = [p for p in paths if p.suffix.lower() in (".jpg", ".jpeg")]
    if jpegs:
        raise ValueError(f"{jpegs[0]}: JPEG input is not supported (the port has no "
                         "JPEG decoder); convert it to PNG")

    def prep(p):
        g = resize_linear(read_png_gray(p), (crop, crop)).astype(np.float32)
        g = (g - g.mean()) / (g.std() + 1e-6)  # z-score, the eval convention
        return np.stack([g, g, g], axis=-1)

    n_done = 0
    for i in range(0, len(paths), bs):
        chunk = paths[i:i + bs]
        batch = torch.from_numpy(np.stack([prep(p) for p in chunk])).to(dev)
        res = fn(batch)
        if isinstance(res, (tuple, list)):  # with_probs artifact: (labels, probs)
            res = res[0]
        for p, lab in zip(chunk, res.cpu().numpy()):
            write_png_gray(out / f"{p.stem}_pred.png", (lab * 60).astype(np.uint8))
        n_done += len(chunk)
    print(f"served {n_done} images -> {out} "
          f"({meta.get('method', '?')}/{meta.get('backbone', '?')})")
    return 0


if __name__ == "__main__":
    import sys
    raise SystemExit(_main(sys.argv[1:]))
