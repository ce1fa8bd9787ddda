#!/usr/bin/env python
"""How far the port's protocol is from the JAX package's, on the CPU: the
figures behind ``tests/test_torch_protocol_parity.py`` and ROADMAP queue 3
item 1.

    JAX_PLATFORMS=cpu python tools/protocol_parity.py

Runs the test's protocol (AdvEnt, both ``gen_class_centers`` scripts,
``slcl`` and ``mccl``, 2 epochs a stage, both Trainers in float64) three
times: ``same_start``, each stage from the same weights, as the test runs
it; ``own_start``, each fine-tune from its own package's warm start and
centre file; and ``f32_init``, as ``own_start`` but with the port's
float64 initial weights, which JAX receives rounded to float32 (1e-8
apart). Prints one JSON line with, per run and stage, the largest relative
difference of a step metric (its step and name), the first step and
metric past the test's tolerance (rel 1e-4, abs 1e-5), each epoch's val
Dice, the best epochs and the test Dice of both packages, the centre
files' and the warm starts' largest differences; and for the ``mccl``
stage of the two runs from their own starts, at its first step: the
DRUNet pre-activations (conv outputs) on
the first target batch whose sign differs between the port (on its warm
start) and JAX (on its own), and, for the channel of the smallest of
them, the derivative of ``sum(pred * g)`` (``g`` seeded) with respect to
that channel's bias from each package's autograd and from the port's
one-sided finite differences.
"""
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_protocol_parity as T  # noqa: E402
from slcl_torch.models import DRUNet as TDRUNet  # noqa: E402
from slcl_torch.models.common import running_stats_frozen  # noqa: E402
from slcl_tpu.models.drunet import DRUNet  # noqa: E402

SIZES = dict(filters=8, n_block=2, bottleneck_depth=2)


def _rel(g: float, w: float) -> float:
    return abs(g - w) / max(abs(w), 1e-12)


def stage_report(want, got) -> dict:
    rows = [(_rel(g[k], w[k]), i, k) for i, (g, w) in enumerate(zip(got.steps, want.steps))
            for k in w]
    first = next(((i, k) for r, i, k in sorted(rows, key=lambda t: (t[1], -t[0]))
                  if not T._close(got.steps[i][k], want.steps[i][k])), None)
    worst = max(rows)
    out = {"max_rel": worst[0], "at_step": worst[1], "metric": worst[2],
           "first_past_tolerance": first,
           "val_dice": [[r.get("val_dice") for r in x.summary["history"]] for x in (got, want)],
           "best_epoch": [got.summary["best_epoch"], want.summary["best_epoch"]],
           "test_dice": [x.summary["test"]["dc"][::2] for x in (got, want)]}
    if want.warm is not None:
        out["warm_max_abs_diff"] = max(
            float(np.abs(np.asarray(a) - np.asarray(b)).max())
            for a, b in zip(jax.tree.leaves(got.warm), jax.tree.leaves(want.warm)))
    return out


def kink(want, got) -> dict:
    """The first ``mccl`` step's sign disagreements and one-sided
    derivatives (see the module docstring)."""
    torch.set_default_dtype(torch.float64)
    b = got.batches[0]
    x = np.concatenate([b["img_t"], b["img_t_aug"]]).astype(np.float64)
    seg = TDRUNet(phead=True, **SIZES).to(memory_format=torch.channels_last)
    seg.load_state_dict(got.warm_state)
    seg.train()
    acts = {}
    for name, m in seg.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(lambda mod, i, o, name=name: acts.__setitem__(name, o))
    g = np.random.default_rng(1).normal(size=(x.shape[0], x.shape[1], x.shape[2], 4))
    with running_stats_frozen(seg):
        out = seg(torch.from_numpy(x))
        (out.pred * torch.from_numpy(g)).sum().backward()
    with jax.enable_x64():
        model = DRUNet(n_class=4, multilvl=False, phead=True, dtype=jnp.float64, **SIZES)
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), want.warm)
        _, st = model.apply(v, jnp.asarray(x), True, mutable=["batch_stats", "intermediates"],
                            capture_intermediates=True)
        inter = st["intermediates"]

        def jloss(params):
            o, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]},
                               jnp.asarray(x), True, mutable=["batch_stats"])
            return jnp.sum(o.pred * jnp.asarray(g))
        jgrad = jax.grad(jloss)(v["params"])
    flips = []
    for name, o in acts.items():
        node = inter
        for part in name.split("."):
            node = node[part]
        jz = np.asarray(node["__call__"][0])
        tz = o.detach().permute(0, 2, 3, 1).numpy()
        for idx in zip(*np.nonzero((tz > 0) != (jz > 0))):
            flips.append((abs(float(tz[idx])), name, tuple(int(i) for i in idx),
                          float(tz[idx]), float(jz[idx])))
    res = {"sign_disagreements": len(flips)}
    if not flips:
        return res
    _, name, idx, tz, jz = min(flips)
    ch = idx[-1]
    conv = seg.get_submodule(name)
    node = jgrad
    for part in name.split("."):
        node = node[part]

    def loss(shift: float) -> float:
        with torch.no_grad(), running_stats_frozen(seg):
            conv.bias[ch] += shift
            val = float((seg(torch.from_numpy(x)).pred * torch.from_numpy(g)).sum())
            conv.bias[ch] -= shift
            return val
    h = 1e-5
    f0 = loss(0.0)
    res.update(layer=name, pixel=list(idx), port_z=tz, jax_z=jz,
               port_grad=float(conv.bias.grad[ch]), jax_grad=float(node["bias"][ch]),
               fd_right=(loss(h) - f0) / h, fd_left=(f0 - loss(-h)) / h, fd_step=h)
    return res


def main() -> None:
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode, same, exact in (("same_start", True, True), ("own_start", False, True),
                                  ("f32_init", False, False)):
            runs, centres = T.run_protocol(Path(tmp) / mode, same_start=same,
                                           round_init=exact)
            rec = {name: stage_report(*runs[name]) for name in runs}
            rec["centres_max_abs_diff"] = {k: float(np.abs(w - g).max())
                                           for k, (w, g) in centres.items()}
            if not same:
                rec["mccl"]["kink"] = kink(*runs["mccl"])
            report[mode] = rec
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
