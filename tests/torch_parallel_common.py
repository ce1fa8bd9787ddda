"""Rank entries of the data-parallel tests. The spawned ranks import this
module, so it imports torch and slcl_torch only (a rank that imported a
test file would import JAX)."""
import copy
import zlib

import numpy as np
import torch

from slcl_torch.config import Config, apply_recipe
from slcl_torch.parallel import dryrun as D
from slcl_torch.parallel import mesh as dp
from slcl_torch.testing import SPATIAL_CELLS, configure_cell, shallow_segmentor
from slcl_torch.train.trainer import _SPATIAL_KEYS

H = 16
B = 8


def small_cfg(method: str) -> Config:
    """JAX's test_parallel.py sizes: DRUNet filters 8, two blocks, f32,
    16x16, a global batch of 8; mccl with two partitions, soft weights and
    CNR (and RAIN's ascent for ``mccl_rain``); BCL's slim DeepLab."""
    cfg = Config()
    cfg.method = "mccl" if method == "mccl_rain" else method
    cfg.model.filters, cfg.model.n_block, cfg.model.bottleneck_depth = 8, 2, 2
    cfg.model.dtype = "float32"
    cfg.data.dataset = "synthetic"
    cfg.data.crop, cfg.data.bs, cfg.data.eval_bs = H, B, B
    cfg.data.num_workers = 1
    cfg.optim.epochs = 1
    if method in ("mccl", "mccl_rain"):
        cfg.contrastive.part = 2
        cfg.contrastive.wtd_ave = True
        cfg.contrastive.CNR = True
    if method == "mccl_rain":
        cfg.rain.enabled = True
        cfg.rain.update_eps = True
        cfg.rain.eps_clip = 3.0
    if method == "bcl":
        cfg.model.layers = (1, 1, 1, 1)
        cfg.model.base = 8
    return cfg


def batches(method: str, n: int, seed: int = 1234, h: int = H, bs: int = B):
    """``n`` global batches of ``bs`` ``h`` x ``h`` images (numpy arrays)
    for ``method``'s step."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"img_s": rng.normal(size=(bs, h, h, 3)).astype(np.float32),
             "lab_s": rng.integers(0, 4, size=(bs, h, h)).astype(np.int32),
             "img_t": rng.normal(size=(bs, h, h, 3)).astype(np.float32)}
        if method in ("mccl", "mccl_rain"):
            b["img_t_aug"] = rng.normal(size=(bs, h, h, 3)).astype(np.float32)
        if method == "bcl":
            plabel = rng.integers(0, 4, size=(bs, h, h)).astype(np.int32)
            plabel[:, ::3] = 255
            b["plabel_t"] = plabel
        if method == "adaptevery":
            b["vert_s"] = rng.normal(size=(bs, 300, 3)).astype(np.float32)
        out.append(b)
    return out


def sched(method: str, eps_on: float = 1.0):
    return {"lr": 1e-3, "lr_dis": 1e-4, "warm": 1.0, "fresh": 1.0,
            "eps_on": eps_on if method == "mccl_rain" else 0.0}


def build_trainer(cfg, work: str, dtype=torch.float32):
    """The Trainer of ``cfg`` under the active mesh, built with ``dtype`` as
    torch's default (its networks and centres in ``dtype``)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        trainer = D.make_trainer(copy.deepcopy(cfg), work)
    finally:
        torch.set_default_dtype(before)
    s = trainer.state
    if s.centroids is not None:
        s.centroids = s.centroids.to(dtype)
    if s.sampling is not None:
        s.sampling = s.sampling.to(dtype)
    return trainer


def dropout_mask(path: str, call: int, shape, keep: float) -> np.ndarray:
    """The tests' dropout mask of one (module path, call within a pass), at
    the global shape: ``tests/torch_extra_common.py::mask``'s, which JAX's
    interceptor there draws."""
    rng = np.random.default_rng([zlib.crc32(path.encode()), call])
    return rng.random(tuple(shape)) < keep


def mask_draw(path, call, shape, keep, device):
    """A ``dropout_pass`` draw giving :func:`dropout_mask`."""
    return torch.from_numpy(dropout_mask(path, call, shape, keep)).to(device)


def use_draws(trainer, draws: dict) -> None:
    """Rebuild ``trainer``'s step with the global batch's rMC assignment
    (``draws["assign"]``) and RAIN noise (``draws["noise"]``) of each step
    given, indexed by the state's step; with ``draws["dropout"]`` true, the
    dropout masks of :func:`dropout_mask` (the same every step, as JAX's
    traced ones)."""
    from slcl_torch.train.steps import build_step
    s = trainer.state

    def given(key, shape):
        a = draws[key][s.step]
        assert tuple(a.shape) == tuple(shape), (key, a.shape, shape)
        return torch.from_numpy(a)

    trainer.step_fn = build_step(
        trainer.cfg, centroids_loaded=trainer.centroids_loaded,
        draw_assign=(lambda m, P, dev: given("assign", (m,)).to(dev))
        if "assign" in draws else None,
        draw_noise=(lambda shape, dev: given("noise", shape).to(dev))
        if "noise" in draws else None,
        draw_dropout=(lambda step, path, call, shape, keep, dev:
                      mask_draw(path, call, shape, keep, dev))
        if draws.get("dropout") else None)


def opt_arrays(trainer) -> dict:
    """Every optimizer's whole state (gathered when sharded) as numpy arrays
    keyed ``opt/param index/entry``."""
    from slcl_torch.train.trainer import _OPTS
    out = {}
    for name in _OPTS:
        opt = getattr(trainer.state, name)
        if opt is None:
            continue
        for i, st in dp.full_state_dict(opt)["state"].items():
            for k, v in st.items():
                if torch.is_tensor(v):
                    out[f"{name}/{i}/{k}"] = v.detach().cpu().double().numpy().copy()
    return out


def plabel_round(trainer, batch_list) -> tuple:
    """BCL's pseudo-label round (``Trainer.bcl_update_plabels``, whole images
    on every rank) and ``batch_list`` with the round's labels of the first
    ``data.bs`` target images (by name) as every batch's ``plabel_t``; and
    the round's record."""
    kept = trainer.bcl_update_plabels(trainer.cfg.run.bcl_prop)
    names = sorted(trainer.bcl_plabels)[:trainer.cfg.data.bs]
    labels = np.stack([trainer.bcl_plabels[n] for n in names]).astype(np.int32)
    return ([{**b, "plabel_t": labels} for b in batch_list],
            {"kept": kept, "labels": labels})


def steps_entry(mesh, cfg, batch_list, scheds, work: str, dtype=torch.float32,
                weights: str = "", restore: str = "", save: str = "",
                draws: dict = None, shallow: str = "", opt: bool = False,
                round_first: bool = False) -> dict:
    """The Trainer of ``cfg`` (its nets loaded from the ``weights`` file of
    whole state dicts, or its full state from the ``restore`` checkpoint),
    one step on this rank's rows of each global batch, and after each the
    metrics and the whole state (``steps``); with ``save`` the tag of a
    checkpoint written after the last step (``ckpt``, its path). ``dtype``
    is torch's default throughout; ``draws`` (:func:`use_draws`) replaces
    the step's own random draws; ``shallow`` (:func:`shallow_segmentor`)
    the segmentor; ``opt`` adds the optimizers' state after each step
    (``opt``, :func:`opt_arrays`); ``round_first`` runs BCL's pseudo-label
    round before the steps and takes its labels (``round``,
    :func:`plabel_round`)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        with dp.use(mesh):
            with shallow_segmentor(shallow):
                trainer = build_trainer(cfg, work, dtype)
            s = trainer.state
            if weights:
                for name, sd in torch.load(weights, weights_only=True).items():
                    dp.load_full_state_dict(getattr(s, name), sd)
            if restore:
                trainer.restore_checkpoint(restore)
            if draws:
                use_draws(trainer, draws)
            rnd = None
            if round_first:
                batch_list, rnd = plabel_round(trainer, batch_list)
            out = []
            for b, sc in zip(batch_list, scheds):
                # this rank's rows, and under spatial partitioning its band of
                # the image rows (the Trainer's _spatial_rows)
                local = {k: dp.spatial_rows(dp.local_rows(torch.from_numpy(v)), k)
                         if k.split("_")[0] in _SPATIAL_KEYS
                         else dp.local_rows(torch.from_numpy(v)) for k, v in b.items()}
                local = {k: v.to(dtype) if v.is_floating_point() else v
                         for k, v in local.items()}
                m = trainer.step_fn(s, local, sc)
                out.append({"metrics": {k: float(v) for k, v in m.items()},
                            "state": D.state_arrays(trainer),
                            "sharded": sum(1 for p in s.seg.parameters()
                                           if dp.is_dtensor(p))})
                if opt:
                    out[-1]["opt"] = opt_arrays(trainer)
            path = trainer.save_checkpoint(save) if save else ""
            return {"steps": out, "ckpt": str(path), "round": rnd}
    finally:
        torch.set_default_dtype(before)


def methods_entry(mesh, specs, work: str) -> dict:
    """:func:`steps_entry` of each ``(name, cfg, batches, scheds, dtype,
    draws, shallow, options)`` in turn (``draws``, ``shallow`` and
    ``options``, a dict of :func:`steps_entry`'s ``opt`` and
    ``round_first``, may be left out)."""
    return {spec[0]: steps_entry(mesh, *spec[1:4], f"{work}/{spec[0]}", spec[4],
                                 draws=spec[5] if len(spec) > 5 else None,
                                 shallow=spec[6] if len(spec) > 6 else "",
                                 **(spec[7] if len(spec) > 7 else {}))
            for spec in specs}


def fsdp_pair_entry(mesh, cfg, batch_list, scheds, work: str) -> dict:
    """The same steps replicated (``mesh.fsdp=false``) and with FSDP."""
    plain = copy.deepcopy(cfg)
    plain.mesh.fsdp = False
    sharded = copy.deepcopy(cfg)
    sharded.mesh.fsdp = True
    return {"replicated": steps_entry(mesh, plain, batch_list, scheds, work + "/r"),
            "fsdp": steps_entry(mesh, sharded, batch_list, scheds, work + "/f")}


def train_entry(mesh, cfg, work: str) -> dict:
    """``Trainer.train()`` (one epoch, validation, checkpoints, test) in
    float64; the history and the final state. Under a mesh each rank works
    in a directory of its own, as ranks on hosts without a shared
    filesystem would."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    if mesh is not None:
        work = f"{work}/rank{torch.distributed.get_rank()}"
    try:
        with dp.use(mesh):
            trainer = D.make_trainer(copy.deepcopy(cfg), work)
            if trainer.state.centroids is not None:
                trainer.state.centroids = trainer.state.centroids.double()
            summary = trainer.train()
            return {"history": summary["history"], "state": D.state_arrays(trainer),
                    "writer": trainer.writer, "out_dir": str(trainer.out_dir)}
    finally:
        torch.set_default_dtype(before)


def from_writer_entry(mesh, work: str) -> dict:
    """``mesh.from_writer`` on every rank: a value that only rank 0 makes,
    and a read that fails on rank 0 (any other rank would divide by zero,
    had it run the function)."""
    rank = torch.distributed.get_rank()
    out = {"value": dp.from_writer(lambda: {"rank": rank, "t": torch.arange(3) + rank})}
    try:
        dp.from_writer(lambda: torch.load(f"{work}/missing.pt") if rank == 0 else 1 / 0)
        out["error"] = None
    except Exception as e:  # the test checks the type
        out["error"] = type(e).__name__
    return out


def raises_entry(mesh, work: str) -> dict:
    """The Trainer's refusals under a mesh of two data ranks, one
    ``rain.mulstyle`` step, and ``pretrain_rain`` staying unsharded
    (spatial partitioning's refusals: :func:`spatial_checks_entry`)."""
    out = {}

    def attempt(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:  # the test checks the type and message
            out[key] = (type(e).__name__, str(e))

    with dp.use(mesh):
        odd = small_cfg("mpscl")
        odd.data.bs = 3
        attempt("bs", lambda: D.make_trainer(odd, work))
        attempt("model_axis", lambda: dp.make_mesh(3, backend="gloo", device="cpu"))
        # rain.mulstyle trains: a sampling row per image of the global batch
        mul = small_cfg("mccl_rain")
        mul.rain.mulstyle = True
        trainer = D.make_trainer(mul, work + "/mulstyle")
        b = batches("mccl", 1)[0]
        m = trainer.step_fn(trainer.state, {k: dp.local_rows(torch.from_numpy(v))
                                            for k, v in b.items()}, sched("mccl_rain"))
        out["mulstyle"] = {"metrics": {k: float(v) for k, v in m.items()},
                           "sampling_rows": int(trainer.state.sampling.shape[0])}
        out.update(pretrain_entry(mesh, work))
    return out


def pretrain_entry(mesh, work: str) -> dict:
    """One ``pretrain_rain`` step on the whole batch of two, through the
    Trainer (which leaves it unsharded under a mesh, as JAX does)."""
    with dp.use(mesh):
        pre = small_cfg("pretrain_rain")
        pre.data.bs = 2
        trainer = D.make_trainer(pre, work)
        b = batches("mpscl", 1)[0]
        with dp.use(trainer.mesh):
            m = trainer.step_fn(trainer.state, {k: torch.from_numpy(b[k][:2])
                                                for k in ("img_s", "img_t")}, {"lr": 1e-4})
        return {"pretrain_mesh": trainer.mesh,
                "pretrain_metrics": {k: float(v) for k, v in m.items()},
                "pretrain_state": D.state_arrays(trainer)}


def spatial_cfg(method: str, fsdp: bool = False) -> Config:
    """:func:`small_cfg` of ``method`` with its image rows split over two
    model ranks (``slcl``: ``mpscl`` with multilvl and CNR, the main path's
    recipe at small size)."""
    cfg = small_cfg("mpscl" if method == "slcl" else method)
    if method == "slcl":
        cfg.method = "slcl"
        cfg.model.multilvl = True
        cfg.contrastive.CNR = True
        cfg.contrastive.CNR_w = 4e-5
    cfg.mesh.model_axis = 2
    cfg.mesh.spatial = True
    cfg.mesh.fsdp = fsdp
    cfg.mesh.fsdp_min_size = 1024
    return cfg


# the sizes of the spatial runs (slcl_torch.testing.SPATIAL_CELLS): name ->
# (crop, global batch). ResNetUNet one block a stage at base 8
# (SMALL_NETS), at 32 rows (its layer-4 map is one row, all on the first
# model rank) and four images. At two images its second step cannot tell
# rounding from a fault (tools/spatial_noise_floor.py): the one process on
# the same images in reverse order already parts from it past the
# tolerances (1.17 of them, the bands 43), and inputs one float32 ulp apart
# part by 21,369 of them (4.2 at four images; the bands 0.0017); its
# layer-4 BatchNorm then normalises two values a channel. UNet at base 8
# and DeepLabV2 one block a stage (its widths whole) at 16 (its stages 8, 5
# and 3 rows); DeepLabV2 at two images, for the tests' time
SMALL_NETS = {"layers": (1, 1, 1, 1), "base": 8}
SPATIAL_SIZES = {"resnet50_slcl": (32, 4), "resnet50_mccl": (32, 4),
                 "unet_baseline": (H, B), "deeplabv2_advent": (H, 2),
                 "deeplabv2_adaptseg": (H, 2), "slcl_remat_full": (H, B),
                 "slcl_remat_dots": (H, B)}
# the RAIN cells (tests/test_torch_parallel_spatial_rain.py)
RAIN_SIZES = {"mccl_rain": (H, B), "rain_seg": (H, B)}


def spatial_run(name: str, fsdp: bool = False, bs: int = 0):
    """(cfg, two global batches, the shallow segmentor) of the spatial run
    ``name`` of ``SPATIAL_CELLS`` at :data:`SPATIAL_SIZES` (``mccl``: the
    preset, at :func:`small_cfg`'s sizes); ``bs`` overrides the batch."""
    method, model, shallow = SPATIAL_CELLS[name]
    sizes = {**SPATIAL_SIZES, **RAIN_SIZES}[name]
    crop, bs = sizes[0], bs or sizes[1]
    cfg = spatial_cfg(method, fsdp)
    if method == "mccl":
        cfg = apply_recipe(cfg)
    configure_cell(cfg, name)
    for k, v in (SMALL_NETS if model.get("backbone") == "resnet50" else {}).items():
        setattr(cfg.model, k, v)
    cfg.data.crop, cfg.data.bs, cfg.data.eval_bs = crop, bs, bs
    return cfg, batches("mpscl" if method == "slcl" else method, 2, h=crop, bs=bs), shallow


def spatial_ops_entry(mesh, cases) -> list:
    """Each row-sharded operator of ``cases`` on this rank's band of the
    global input (``parallel/spatial.py``'s layout), in float64: its output
    band, the input band's gradient and the parameters' (partial)
    gradients for the global cotangent ``g``, and a BatchNorm's running
    statistics."""
    from slcl_torch.models.common import BatchNorm
    from slcl_torch.parallel import spatial as sp
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = []
        with dp.use(mesh):
            for case in cases:
                out.append(_spatial_op(mesh, case, sp, BatchNorm))
        return out
    finally:
        torch.set_default_dtype(before)


def _spatial_op(mesh, case, sp, BatchNorm) -> dict:
    calls = [0]
    all_reduce = torch.distributed.all_reduce

    def counted(*args, **kwargs):
        calls[0] += 1
        return all_reduce(*args, **kwargs)
    torch.distributed.all_reduce = counted
    try:
        res = _spatial_op_run(mesh, case, sp, BatchNorm)
    finally:
        torch.distributed.all_reduce = all_reduce
    # the halo exchanges of the forward and the backward
    res["exchanges"] = calls[0]
    return res


def _spatial_op_run(mesh, case, sp, BatchNorm) -> dict:
    kind = case["kind"]
    if kind == "resize_labels":
        # NHW integer labels: no gradient
        lab = torch.from_numpy(case["labels"])
        rows, r, m = lab.shape[1], mesh.model_rank, mesh.model_size
        b = sp.bounds(rows, m)
        y = sp.resize_labels(lab[:, b[r]:b[r + 1]].contiguous(), case["size"], rows)
        return {"y": y.numpy(), "dx": None, "dparams": {}}
    x = torch.from_numpy(case["x"])
    rows, r, m = x.shape[2], mesh.model_rank, mesh.model_size
    b = sp.bounds(rows, m)
    xl = x[:, :, b[r]:b[r + 1]].clone().requires_grad_(True)
    module = None
    if kind == "mean_std":
        # RAIN's AdaIN moments: replicated on the model ranks, each of which
        # backpropagates its share (as a step does)
        from slcl_torch.models.rain import calc_mean_std
        y = torch.cat(calc_mean_std(xl.permute(0, 2, 3, 1)), dim=-1)
        (y * torch.from_numpy(case["g"])).sum().div(m).backward()
        return {"y": y.detach().numpy(), "dx": xl.grad.numpy(), "dparams": {}}
    if kind == "conv":
        w = torch.from_numpy(case["w"])
        module = sp.Conv2d(w.shape[1], w.shape[0], w.shape[2], stride=case["stride"],
                           padding=case["padding"], dilation=case["dilation"],
                           bias="b" in case,
                           padding_mode=case.get("padding_mode", "zeros"))
        module.load_state_dict({"weight": w, **({"bias": torch.from_numpy(case["b"])}
                                                if "b" in case else {})})
        y = module(xl, rows)
    elif kind == "max_pool":
        y = sp.max_pool(xl, rows)
    elif kind == "max_pool3":
        y = sp.max_pool3(xl, rows, case["ceil"])
    elif kind == "conv_transpose":
        w = torch.from_numpy(case["w"])
        module = sp.ConvTranspose2d(w.shape[0], w.shape[1], w.shape[2],
                                    stride=case.get("stride", 2),
                                    padding=case.get("padding", 0),
                                    output_padding=case.get("output_padding", 0))
        module.load_state_dict({"weight": w, "bias": torch.from_numpy(case["b"])})
        y = module(xl, rows)
    elif kind == "instance_norm":
        module = sp.InstanceNorm(x.shape[1], eps=case["eps"], affine="w" in case)
        if "w" in case:
            module.load_state_dict({"weight": torch.from_numpy(case["w"]),
                                    "bias": torch.from_numpy(case["b"])})
        y = module(xl)
    elif kind in ("attention", "patchgan"):
        module = extra_module(case)
        if kind == "attention":
            from slcl_torch.models.common import dropout_pass
            with dropout_pass(mask_draw):
                y = module(xl, rows)
        else:
            # (out, aux) NHWC -> one NCHW tensor
            y = torch.cat(module(xl.permute(0, 2, 3, 1)), dim=-1).permute(0, 3, 1, 2)
    elif kind == "nearest":
        y = sp.upsample_nearest(xl, rows)
    elif kind == "bilinear":
        y = sp.upsample_bilinear(xl, case["size"], rows)
    else:
        from slcl_torch.models.common import FrozenBatchNorm
        module = (FrozenBatchNorm if case.get("frozen") else BatchNorm)(x.shape[1])
        y = module(xl)
    g = torch.from_numpy(case["g"])
    bo = sp.bounds(g.shape[2], m)
    (y * g[:, :, bo[r]:bo[r + 1]]).sum().backward()
    res = {"y": y.detach().numpy(), "dx": xl.grad.numpy(), "dparams": {}}
    if module is not None:
        res["dparams"] = {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
                          for n, p in module.named_parameters()}
        res["buffers"] = {n: t.numpy().copy() for n, t in module.named_buffers()}
    return res


def extra_module(case) -> torch.nn.Module:
    """The module of an ``attention`` or ``patchgan`` operator case, from
    its seed, in train mode: DDFSeg's ``_Attention`` at ``case["ch"]``
    channels, dropout 0.25, its ``gamma`` at 0.5 (so that the attention
    reaches the output; a float64 module takes its products in float64), or
    a ``PatchGAN`` with its aux head."""
    from slcl_torch.models.common import name_dropouts
    from slcl_torch.models.ddfseg import _Attention
    from slcl_torch.models.discriminators import PatchGAN
    g = torch.Generator().manual_seed(case["seed"])
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)      # drawn alike in any process
    try:
        if case["kind"] == "attention":
            module = _Attention(case["ch"], dropout=0.25, generator=g)
            with torch.no_grad():
                module.gamma.fill_(0.5)
            name_dropouts(module)
        else:
            module = PatchGAN(case["x"].shape[1], ndf=case["ch"], aux=True, generator=g)
    finally:
        torch.set_default_dtype(before)
    return module.double().train()


def first_rows_entry(mesh) -> dict:
    """``mesh.first_rows`` of a tensor holding this rank's (data rank, model
    rank): data rank 0's, of this rank's model rank, on every rank."""
    t = torch.tensor([[float(mesh.data_rank), float(mesh.model_rank)]])
    with dp.use(mesh):
        return {"rank": (mesh.data_rank, mesh.model_rank),
                "first": dp.first_rows(t).numpy()}


def spatial_rain_entry(mesh, runs, work: str, expected: dict = None) -> dict:
    """:func:`compare_entry` of ``runs`` and :func:`first_rows_entry` in one
    set of ranks."""
    return {"runs": compare_entry(mesh, runs, work, expected),
            "first_rows": first_rows_entry(mesh)}


def spatial_checks_entry(mesh, work: str) -> dict:
    """Under a spatial mesh: this rank's rMC pixels of a global draw; the
    Trainer's refusal of DeepLabV2 under a contrastive method (as without a
    mesh), of an image height the model ranks do not divide, and of a mesh
    that does not match ``mesh.spatial``; and one ``mpscl`` step that runs."""
    out = {}
    with dp.use(mesh):
        shape = (B, H, H)
        draw = torch.arange(B * H * H, dtype=torch.int32)
        out["pixels"] = dp.local_pixels(draw, dp.global_image_shape(
            (B // mesh.data_size, H // mesh.model_size, H))).numpy()
        out["shape"] = dp.global_image_shape((B // mesh.data_size, H // mesh.model_size, H))

        def attempt(key, fn):
            try:
                fn()
                out[key] = None
            except Exception as e:  # the test checks the type and message
                out[key] = (type(e).__name__, str(e))

        cfg = spatial_cfg("slcl")
        cfg.model.backbone = "deeplabv2"
        attempt("deeplabv2_slcl", lambda: D.make_trainer(cfg, work))
        plain = spatial_cfg("mpscl")
        plain.mesh.spatial = False
        attempt("mismatch", lambda: D.make_trainer(plain, work))
        trainer = D.make_trainer(spatial_cfg("mpscl"), work)
        odd = {k: np.zeros((B // mesh.data_size, H + 1, H) + (3,) * (k == "img_s"),
                           np.float32 if k == "img_s" else np.int32)
               for k in ("img_s", "lab_s")}
        attempt("odd_rows", lambda: trainer._spatial_rows(odd))
        b = batches("mpscl", 1)[0]
        with dp.use(trainer.mesh):
            local = {k: dp.spatial_rows(dp.local_rows(torch.from_numpy(v)), k)
                     for k, v in b.items()}
            m = trainer.step_fn(trainer.state, local, sched("mpscl"))
        out["step"] = {k: float(v) for k, v in m.items()}
        out["local_rows"] = local["img_s"].shape[1]
    return out


def state_errors(got: dict, want: dict, rtol: float, atol: float,
                 atol_of: dict = None) -> list:
    """The entries of two ``state_arrays`` that differ beyond tolerance (as
    :func:`assert_state_close` holds them; ``atol_of``: another atol for the
    entries it names), each with its largest difference; empty when they
    agree."""
    if set(got) != set(want):
        return [f"entries differ: {sorted(set(got) ^ set(want))[:4]}"]
    atol_of = atol_of or {}
    return [f"{k}: max |diff| {float(np.abs(got[k] - w).max()):.3g}"
            for k, w in want.items()
            if got[k].shape != w.shape
            or not np.allclose(got[k], w, rtol=rtol, atol=atol_of.get(k, atol))]


# RAIN's sampling against JAX's: one process on the same weights and noise
# already differs by up to 3.8e-6 (``method=rain`` at 16 rows, no mesh):
# both packages take the AdaIN statistics that feed fc_encoder in float32,
# summed in another order (tests/test_torch_step_rain.py's atol, 1e-5)
JAX_ATOL = {"sampling": 1e-5}


def compare_entry(mesh, specs, work: str, expected: dict = None) -> dict:
    """:func:`methods_entry` of ``specs`` under ``mesh``, then the same in
    this process alone (no mesh; a spec named ``<name>_fsdp``, FSDP's form of
    the spec ``<name>``, shares that one's), compared here at the
    data-parallel tolerances (the state rtol 1e-4 / atol 1e-6): per spec and
    step the metrics of both and the state's differences
    (:func:`state_errors`); for a spec that ``expected`` names, also those
    from the steps on its file (``[(metrics, state_arrays)]`` a step: JAX's
    spatial step in the port's layout). The large states of the deep
    backbones then stay in the ranks. A spec run with ``opt`` also has its
    optimizers' states compared (``opt_errors``), and one with
    ``round_first`` its pseudo-label round (``round_equal``: the same labels
    and kept share as one process's)."""
    got = methods_entry(mesh, specs, f"{work}/mesh")
    want = methods_entry(None, [s for s in specs if not s[0].endswith("_fsdp")],
                         f"{work}/one")
    out = {}
    for name in got:
        ref = torch.load(expected[name], weights_only=False) if name in (expected or {}) \
            else None
        out[name] = []
        for i, (g, w) in enumerate(zip(got[name]["steps"],
                                       want[name.removesuffix("_fsdp")]["steps"])):
            rec = {"metrics": g["metrics"], "want_metrics": w["metrics"],
                   "errors": state_errors(g["state"], w["state"], 1e-4, 1e-6),
                   "sharded": g["sharded"]}
            if "opt" in w:
                rec["opt_errors"] = state_errors(g["opt"], w["opt"], 1e-4, 1e-6)
            rounds = got[name]["round"], want[name.removesuffix("_fsdp")]["round"]
            if rounds[1] is not None:
                rec["round_equal"] = (rounds[0]["kept"] == rounds[1]["kept"] and
                                      np.array_equal(rounds[0]["labels"], rounds[1]["labels"]))
            if ref is not None:
                rec["jax_metrics"] = ref[i][0]
                rec["jax_errors"] = state_errors(g["state"], ref[i][1], 1e-4, 1e-6,
                                                 JAX_ATOL)
            out[name].append(rec)
    return out


def spatial_1x2_entry(mesh, specs, runs, work: str) -> dict:
    """:func:`methods_entry` of ``specs`` and :func:`compare_entry` of
    ``runs`` in one set of ranks."""
    return {"methods": methods_entry(mesh, specs, f"{work}/methods"),
            "runs": compare_entry(mesh, runs, f"{work}/runs")}


def spatial_2x2_entry(mesh, specs, work: str, runs=(), expected: dict = None) -> dict:
    """:func:`methods_entry` of ``specs``, :func:`compare_entry` of ``runs``
    and :func:`spatial_checks_entry` in one set of ranks."""
    return {"methods": methods_entry(mesh, specs, f"{work}/methods"),
            "runs": compare_entry(mesh, runs, f"{work}/runs", expected),
            "checks": spatial_checks_entry(mesh, f"{work}/checks")}


def assert_state_close(got: dict, want: dict, rtol: float, atol: float, what: str,
                       disc_atol: float = None) -> None:
    """Every entry of two ``state_arrays`` within tolerance (``disc_atol``
    for the discriminators' entries when given)."""
    assert set(got) == set(want), what
    for k, w in want.items():
        a = disc_atol if disc_atol is not None and k.startswith("d_") else atol
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=a, err_msg=f"{what} {k}")


def assert_metrics_close(got: dict, want: dict, rel: float, what: str, abs_: float = 1e-6):
    assert set(got) == set(want), what
    for k, w in want.items():
        assert abs(got[k] - w) <= max(rel * abs(w), abs_), f"{what} {k}: {got[k]} vs {w}"


def ops_entry(mesh, arrays: dict) -> dict:
    """Each reduction of the port's step on this rank's rows of the global
    arrays, in float64 (the losses keep float32 where they cast): its value
    and the gradient of the value over the data ranks with respect to this
    rank's rows, as a step backpropagates its share (its local rows of the
    one-process gradient)."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return _ops(mesh, arrays)
    finally:
        torch.set_default_dtype(before)


def _ops(mesh, arrays: dict) -> dict:
    from slcl_torch.models.common import BatchNorm
    from slcl_torch.ops import centroids as cen
    from slcl_torch.ops import losses as L
    from slcl_torch.ops.cuda.soft_centroids import soft_centroids_plain

    with dp.use(mesh):
        local = {k: dp.local_rows(torch.from_numpy(v)) for k, v in arrays.items()}
    logits, labels, feats = local["logits"], local["labels"], local["feats"]
    probs = torch.softmax(logits, dim=-1)
    flat_f = feats.reshape(-1, feats.shape[-1])
    flat_p = probs.reshape(-1, probs.shape[-1]).detach()
    assign = local["assign"].reshape(-1)
    centers = torch.nn.functional.normalize(torch.from_numpy(arrays["centers"]), dim=1)
    sel = local["sel"].reshape(-1)

    def soft(P, weighted, std):
        def fn(x):
            out = soft_centroids_plain(x.reshape(-1, x.shape[-1]), flat_p, assign,
                                       partition=P, threshold=0.4, weighted=weighted,
                                       with_std=std)
            return out[0].sum() + out[1] + (out[2].sum() if std else 0.0)
        return fn

    bn = BatchNorm(feats.shape[-1]).double()
    fns = {
        "cross_entropy": lambda x: L.cross_entropy_loss(x, labels),
        "jaccard": lambda x: L.jaccard_loss(x, labels),
        "dice": lambda x: L.dice_loss(x, labels),
        "ce_ignore": lambda x: L.cross_entropy_ignore(x, local["plabel"]),
        "entropy": lambda x: L.loss_entropy(torch.softmax(x, -1)),
        "entropy_sum": lambda x: L.loss_entropy(torch.softmax(x, -1), mode="sum"),
        "class_prior": lambda x: L.loss_class_prior(torch.softmax(x, -1),
                                                    [0.5, 0.2, 0.2, 0.1], 0.9),
        "bce": lambda x: L.bce_with_logits(x, 1.0),
        "seg_pseudo": lambda x: L.seg_pseudo_loss(torch.softmax(x, -1), 0.3, 4),
        "soft_ce": lambda x: L.softmax_cross_entropy_soft(x, probs.detach()),
        "mse": lambda x: L.mse_loss(x, torch.zeros_like(x)),
        "mpcl": lambda f: L.mpcl_loss_calc(f, labels, torch.from_numpy(arrays["centers"])),
        "mpcl_sel": lambda f: L.mpcl_loss_calc(f, labels, torch.from_numpy(arrays["centers"]),
                                               pixel_sel_loc=sel),
        "mpcl_pseudo": lambda f: L.mpcl_pseudo_loss(f, centers),
        "source_centroids": lambda f: cen.source_centroids(f, labels).sum(),
        "soft_p1": soft(1, True, False),
        "soft_p2": soft(2, True, False),
        "soft_p2_std": soft(2, True, True),
        "hard_p1_std": soft(1, False, True),
        "chamfer": lambda v: L.chamfer_loss(v, local["verts"]),
        "batchnorm": lambda f: (bn(f.permute(0, 3, 1, 2)) ** 3).mean(),
    }
    inputs = {"mpcl": feats, "mpcl_sel": feats, "mpcl_pseudo": feats,
              "source_centroids": feats, "soft_p1": feats, "soft_p2": feats,
              "soft_p2_std": feats, "hard_p1_std": feats, "chamfer": local["points"],
              "mse": feats, "batchnorm": feats}
    out = {}
    with dp.use(mesh):
        for name, fn in fns.items():
            x = inputs.get(name, logits).clone().requires_grad_(True)
            v = fn(x)
            if name == "batchnorm":
                v = dp.gmean(v.reshape(1))
            (g,) = torch.autograd.grad(v / dp.data_size(), x)
            out[name] = (float(v.detach()), g.numpy())
        with torch.no_grad():
            out["ema_centres"] = (cen.update_class_center_iter(
                feats, labels, torch.from_numpy(arrays["centers"]), bootstrap=False).numpy(),
                None)
        out["bn_running"] = (np.concatenate([bn.running_mean.numpy(),
                                             bn.running_var.numpy()]), None)
    return out
