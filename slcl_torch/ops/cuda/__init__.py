"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper module holds a kernel's launch, its ``torch.autograd.Function``
where it needs a gradient, and its plain PyTorch version. A wrapper given
CPU tensors runs the plain version; given CUDA tensors it launches the
kernel or raises — it never falls back.

Every kernel has a :class:`Kernel` record with a plain integer launch
count, raised by one where its wrapper launches it and nowhere else, so a
run can show that the main path went through the kernels.

Each kernel comes in two families. The templated one is compiled for the
published shapes: C = 4 classes, P <= 2 rMC partitions, feature width F in
{8, 16, 32, 64}. The general one takes C, P and F at run time, any value
whose shared memory fits one block (:func:`general_smem`,
:data:`SMEM_LIMIT`). :func:`route` chooses between them by shape alone;
a shape beyond the limit raises ``ValueError`` (:func:`check_shape`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, Optional, Tuple

import torch


class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and how
    many times its wrapper has launched it."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


KERNELS: Dict[str, Kernel] = {}


def register(name: str, source: str, replaces: str) -> Kernel:
    k = Kernel(name, source, replaces)
    KERNELS[name] = k
    return k


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def check(t: Optional[torch.Tensor], name: str, dtypes: Iterable[torch.dtype],
          shape: Optional[tuple] = None, device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte-aligned CUDA tensor of
    one of ``dtypes`` (and of ``shape`` / on ``device`` when given)."""
    if t is None:
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    dtypes = tuple(dtypes)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# the feature widths the templated kernels are compiled for
TEMPLATED_F = (8, 16, 32, 64)
# dynamic shared memory a general kernel may take a block, bytes: an H100
# block's 227 KB (cudaDevAttrMaxSharedMemoryPerBlockOptin) less 1 KB for a
# kernel's static shared memory; the C entry points check the device's own
SMEM_LIMIT = 227 * 1024 - 1024
SMEM_FORMULAS = ("rows (MPCL, fused target, pseudo-labels): 4*(C*F + 256*(C|1)); "
                 "centroid forward: a ring of S (3, else 2) stages of R rows, barriers "
                 "ceil128(16*S + 8*R) + two weight tables 2*3*nt*8*(R+8)*2 "
                 "+ S*R*(F*itemsize + 4*C + 4*(P>1)), nt = ceil8(P*C+1)/8 + std*ceil8(C)/8, "
                 "at least the totals 4*(F//16+1)*16*nt*8 (gen_fwd_plan, bf16 and f32), "
                 "else the grouped form: 4*G*(P*C*F + P*C + 1 + std*C*F), "
                 "G = max(1, 256 // F); "
                 "centroid final pass: 4*(2*F + P); "
                 "centroid backward: a ring of 2 stages of R rows, coefficients "
                 "4*(P*C*F + P*C + std*2*C*F) + barriers 32 + row tables R*(C+2)*4 "
                 "+ dprobs partials R*(C|1)*ceil4(min(F/V, 32))*4 "
                 "+ 2*R*(F*itemsize (std or dprobs) + 4*C + 4*(P>1)) (gen_bwd_plan), "
                 "else the direct form: 4*(P*C*F + P*C + std*2*C*F)")
# the general centroid backward's plan (csrc/centroids_gen_plan.cuh): a
# ring's budget when it fits (two blocks an SM), the tile bytes it aims at,
# the classes whose coefficients a lane may keep in registers (std-free,
# std)
GEN_BWD_BUDGET = 110 * 1024
GEN_TILE_BYTES = 20 * 1024
GEN_REG_CLASSES = 6
GEN_REG_CLASSES_STD = 5
# the general centroid forward's plan (the same header): the m- and n-tiles
# whose totals a warp holds (fewer m-tiles in the bf16 ring form), the ring form's blocks an SM and its budget
# (two blocks an SM), its most stages, the tile bytes it aims at
GEN_FWD_MT = 4
GEN_FWD_MT_WIDE = 2     # the bf16 ring form's (two blocks an SM)
GEN_FWD_NT = 4
GEN_FWD_BLOCKS = 2
GEN_FWD_BUDGET = 110 * 1024
GEN_FWD_NARROW_BLOCKS = 3      # the narrow form's (one n-tile)
GEN_FWD_NARROW_BUDGET = 72 * 1024
GEN_FWD_MAX_STAGES = 3
GEN_FWD_TILE_BYTES = 20 * 1024


def route(C: int, P: int, F: int, dtype: torch.dtype = torch.float32) -> str:
    """``"templated"`` when C = 4, P <= 2 and F is in :data:`TEMPLATED_F`
    (bf16 or f32 features), else ``"general"``: by shape alone, never on a
    failure."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"features of dtype {dtype}: the kernels take bf16 or f32")
    return "templated" if C == 4 and 1 <= P <= 2 and F in TEMPLATED_F else "general"


def gen_bwd_plan(C: int, P: int, F: int, with_std: bool = False, itemsize: int = 2,
                 dprobs: bool = True) -> Dict[str, int]:
    """The general centroid backward's launch plan at (C, P, F, std), feature
    bytes ``itemsize`` and with or without dprobs: ``csrc/centroids_gen_plan.cuh``'s
    ``gen_bwd_plan``, which ``tests/test_torch_general_shapes.py`` compiles
    and holds this to. ``form`` is ``"ring"`` or ``"direct"``; ``V`` the
    features a thread-chunk owns, ``nch`` the chunks a row, ``tpr`` / ``rpw``
    / ``npw`` / ``rw`` lanes a row / rows a warp-pass / passes a warp a tile
    / rows a warp a tile, ``regs`` whether a lane keeps its chunk's
    coefficients in registers, ``rows`` / ``stages`` a ring tile's rows and
    the ring's stages, each array's bytes in a stage, the tables' offsets
    and ``smem``, the dynamic shared memory of a block."""
    V = 8 if F % 8 == 0 else (4 if F % 4 == 0 else 1)
    nch = F // V
    tpr = min(nch, 32)
    rpw = 32 // tpr
    cs = C | 1
    feats = bool(with_std or dprobs)
    plan = dict(form="ring", V=V, nch=nch, tpr=tpr, rpw=rpw, cs=cs,
                regs=int(nch <= 32 and V == 8 and (C <= GEN_REG_CLASSES_STD if with_std
                                                   else P == 1 and C <= GEN_REG_CLASSES)),
                feats=int(feats), bulk=0)
    coef = 4 * (P * C * F + P * C + (2 * C * F if with_std else 0))
    row_bytes = (F * itemsize if feats else 0) + 4 * C + (4 if P > 1 else 0)
    npw0 = 8
    while npw0 > 1 and 8 * rpw * npw0 * row_bytes > GEN_TILE_BYTES:
        npw0 //= 2
    for budget in (GEN_BWD_BUDGET, SMEM_LIMIT):
        npw = npw0
        while npw >= 1:
            R = 8 * rpw * npw
            fb, pb, ib = (R * F * itemsize if feats else 0), R * C * 4, (R * 4 if P > 1 else 0)
            stage = fb + pb + ib
            pt = R * cs * (-(-tpr // 4) * 4) * 4 if dprobs else 0
            S = 2   # the C++ plan's max_stages
            bar_at = -(-coef // 16) * 16
            w_at = bar_at + 16 * S
            pt_at = w_at + R * C * 4 + R * 4 + R * 4
            ring_at = -(-(pt_at + pt) // 128) * 128
            smem = ring_at + S * stage
            if smem <= budget:
                plan.update(npw=npw, rw=rpw * npw, rows=R, stages=S, feat_bytes=fb,
                            prob_bytes=pb, id_bytes=ib, stage_bytes=stage, bar_at=bar_at,
                            w_at=w_at, part_at=w_at + R * C * 4,
                            g_at=w_at + R * C * 4 + R * 4, pt_at=pt_at, ring_at=ring_at,
                            smem=smem)
                return plan
            npw //= 2
    plan.update(form="direct", regs=0, bulk=0, npw=0, rw=0, rows=256, stages=0, feat_bytes=0,
                prob_bytes=0, id_bytes=0, stage_bytes=0, bar_at=0, w_at=0, part_at=0,
                g_at=0, pt_at=0, ring_at=0, smem=min(coef, 0x7fffffff))
    return plan


def gen_fwd_plan(C: int, P: int, F: int, with_std: bool = False,
                 itemsize: int = 2) -> Dict[str, int]:
    """The general centroid forward's launch plan at (C, P, F, std) and
    feature bytes ``itemsize``: ``csrc/centroids_gen_plan.cuh``'s
    ``gen_fwd_plan``, which ``tests/test_torch_general_shapes.py`` compiles
    and holds this to. ``form`` is ``"ring"`` (the tensor-core product on a
    bulk-copy ring), ``"narrow"`` (the same with one n-tile, three blocks
    an SM) or ``"grouped"``; ``mt`` the m-tiles (16 features each,
    the row of ones at F included), ``ns`` / ``nt_s`` the sum columns and
    their n-tiles, ``nt`` all n-tiles; ``wm`` / ``wn`` / ``wk`` the warps
    along m, n and k, ``mw`` / ``nw`` the tiles a warp owns, ``kpw`` its
    k-steps a tile, ``rows`` / ``stages`` a ring tile's rows and the
    ring's stages, each array's bytes in a stage, a weight table's column
    stride and bytes, the totals' bytes, the offsets and ``smem``, the
    dynamic shared memory of a block."""
    mt = F // 16 + 1
    ns = -(-(P * C + 1) // 8) * 8
    nt = ns // 8 + (-(-C // 8) if with_std else 0)
    plan = dict(form="ring", mt=mt, ns=ns, nt_s=ns // 8, nt=nt)
    narrow = nt == 1
    mt_cap = GEN_FWD_MT_WIDE if itemsize == 2 and not narrow else GEN_FWD_MT
    split = None
    prod = 1
    while prod <= 8 and split is None:
        wm = prod
        while wm >= 1:
            wn = prod // wm
            if -(-mt // wm) <= mt_cap and -(-nt // wn) <= GEN_FWD_NT:
                split = (wm, wn)
                break
            wm //= 2
        prod *= 2
    if split is not None:
        wm, wn = split
        wk = 8 // (wm * wn)
        plan.update(wm=wm, wn=wn, wk=wk, mw=-(-mt // wm), nw=-(-nt // wn))
        row_bytes = F * itemsize + 4 * C + (4 if P > 1 else 0)
        kpw0 = 4
        while kpw0 > 1 and 16 * wk * kpw0 * row_bytes > GEN_FWD_TILE_BYTES:
            kpw0 //= 2
        for budget in ((GEN_FWD_NARROW_BUDGET if narrow else GEN_FWD_BUDGET), GEN_FWD_BUDGET,
                       SMEM_LIMIT):
            kpw = kpw0
            while kpw >= 1:
                R = 16 * wk * kpw
                fb, pb, ib = R * F * itemsize, R * C * 4, (R * 4 if P > 1 else 0)
                stage = fb + pb + ib
                table = 3 * nt * 8 * (R + 8) * 2
                red = 4 * mt * 16 * nt * 8
                for S in range(GEN_FWD_MAX_STAGES, 1, -1):
                    part_at = 16 * S
                    b_at = -(-(part_at + 8 * R) // 128) * 128
                    ring_at = -(-(b_at + 2 * table) // 128) * 128
                    smem = max(ring_at + S * stage, b_at + red)
                    if smem <= budget:
                        plan.update(form="narrow" if narrow else "ring", kpw=kpw, rows=R,
                                    stages=S, feat_bytes=fb, prob_bytes=pb, id_bytes=ib, stage_bytes=stage, b_stride=R + 8,
                                    b_bytes=table, red_bytes=red, bar_at=0, part_at=part_at,
                                    b_at=b_at,
                                    ring_at=ring_at, smem=smem)
                        return plan
                kpw //= 2
    groups = 1 if F >= 256 else 256 // F
    grouped = 4 * groups * (P * C * F + P * C + 1 + (C * F if with_std else 0))
    return dict.fromkeys(GEN_FWD_KEYS, 0) | dict(form="grouped", rows=groups,
                                                 smem=min(grouped, 0x7fffffff))


# the fields of gen_fwd_plan, in the C++ struct's order
GEN_FWD_KEYS = ("form", "mt", "ns", "nt_s", "nt", "wm", "wn", "wk", "mw", "nw", "kpw", "rows",
                "stages", "feat_bytes", "prob_bytes", "id_bytes", "stage_bytes", "b_stride",
                "b_bytes", "red_bytes", "bar_at", "part_at", "b_at", "ring_at", "smem")


def general_smem(C: int, P: int, F: int, with_std: bool = False) -> Dict[str, int]:
    """Dynamic shared memory (bytes) of each general kernel at (C, P, F):
    the formulas of ``csrc/general.cuh`` and ``csrc/centroids_gen.cuh``; the
    centroid forward's is its plan's (:func:`gen_fwd_plan`), the larger of
    bf16's and f32's, the backward's its plan's (:func:`gen_bwd_plan`,
    bf16 features with dprobs). Each plan takes a form whose shared memory
    is the first design's (the forward's grouped form, the backward's
    direct one) where no ring fits, so it fits wherever that did."""
    s = int(bool(with_std))
    return {"rows": 4 * (C * F + 256 * (C | 1)),
            "centroid_fwd": max(gen_fwd_plan(C, P, F, with_std, es)["smem"] for es in (2, 4)),
            "centroid_final": 4 * (2 * F + P),
            "centroid_bwd": gen_bwd_plan(C, P, F, with_std)["smem"]}


def shape_limit(C: int, P: int = 1, F: int = 0, with_std: bool = False) -> str:
    """The general kernels' limit, for a message about (C, P, F)."""
    return (f"C={C}, P={P}, F={F}{' with stddevs' if with_std else ''}: the templated "
            f"kernels take C = 4, P <= 2, F in {TEMPLATED_F}; the general kernels any "
            f"C, P, F >= 1 whose shared memory fits {SMEM_LIMIT} bytes a block "
            f"({SMEM_FORMULAS})")


def check_shape(C: int, F: int, P: int = 1, with_std: bool = False,
                kernels: Iterable[str] = ("rows", "centroid_fwd", "centroid_final",
                                          "centroid_bwd")) -> None:
    """Raise ``ValueError`` naming C, P, F and the limit unless the general
    kernels in ``kernels`` (keys of :func:`general_smem`) fit a block."""
    if min(C, P, F) < 1:
        raise ValueError(f"C={C}, P={P}, F={F}: every one must be >= 1")
    need = general_smem(C, P, F, with_std)
    over = {k: need[k] for k in kernels if need[k] > SMEM_LIMIT}
    if over:
        raise ValueError(f"{shape_limit(C, P, F, with_std)}; this shape needs {over}")


def choose(route_arg: Optional[str], C: int, P: int, F: int, dtype: torch.dtype,
           kernels: Iterable[str], with_std: bool = False) -> Tuple[str, dict]:
    """The family of one wrapper call: ``route_arg`` when given (chip_smoke
    forces one), else :func:`route`'s by shape; a general shape beyond the
    limit of the ``kernels`` it runs raises here, before any launch. Returns
    the family and the shape that error messages name."""
    r = route_arg or route(C, P, F, dtype)
    if r == "general":
        check_shape(C, F, P, with_std, kernels)
    return r, dict(C=C, P=P, F=F, with_std=with_std)


def raise_on_error(rc: int, what: str, shape: Optional[dict] = None) -> None:
    """Raise if a C entry point returned non-zero (-1: a shape beyond the
    kernels' limit, named with ``shape`` = dict(C=, P=, F=, with_std=);
    otherwise the ``cudaError_t`` of ``cudaGetLastError``)."""
    if rc == 0:
        return
    if rc == -1:
        raise ValueError(f"{what}: {shape_limit(**(shape or {}))}")
    raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")


VP, I32, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
IP = ctypes.POINTER(ctypes.c_int)


def occupancy(fn, *args) -> Tuple[int, int]:
    """(blocks per SM, shared memory bytes per block) of one kernel from a
    library's ``<name>_occupancy(*args, int*, int*)`` query."""
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    raise_on_error(fn(*args, ctypes.byref(blocks), ctypes.byref(smem)), fn.__name__)
    return blocks.value, smem.value
