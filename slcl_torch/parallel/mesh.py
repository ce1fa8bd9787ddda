"""Data parallelism over processes with the JAX package's global-batch
semantics (counterpart of ``slcl_tpu/parallel/mesh.py``).

JAX runs one program over a ``Mesh(('data', 'model'))`` and GSPMD reduces
every batch-global quantity over the global batch. Here each process (a
``torchrun`` rank) holds ``data.bs / W_data`` rows of each global batch and
the port reduces those quantities itself, so that a step equals the
one-process step on the global batch:

- every loss, metric and batch statistic is the global batch's value on
  every rank: its local sums go through :func:`all_sum`, a differentiable
  all-reduce over the data group (BatchNorm's moments, the losses' means
  and ratios, the partial sums of the centroid and MPCL kernels between
  their streaming and final passes);
- each rank backpropagates its share, the global loss over ``W_data``, and
  :func:`reduce_grads` sums the gradients over the ranks. The backward of
  :func:`all_sum` sums the shares' cotangents, so the ranks' gradients add
  up to the global batch's;
- random draws (MCCL's rMC partition, dropout masks) are made at the global
  shape and each rank keeps its rows (:func:`local_rows`).

Spatial partitioning (``mesh.spatial``, a mesh made with ``spatial=True``
and more than one model rank): each model rank of a data rank holds a band
of ``H / model_size`` contiguous rows of each image of its data rank's
rows. The ranks that hold distinct pixels, the *pixel group*, are then
every process (data x model), and the reductions above run over it: every
pixel of the global batch is counted once. Per-sample sums go over the
model ranks first (:func:`sample_sum`); the convolutions, pools and
resizes of the networks read their neighbours' rows through the halo
exchange of :mod:`.spatial`; each rank backpropagates its share, the
global loss over the pixel group's size, and :func:`reduce_grads` sums the
gradients over every process.

With one rank in the pixel group every reduction is the identity (none is
launched) and the step keeps the one-process arithmetic. A step under a
mesh runs inside :func:`use`.

The JAX functions map as:

  make_mesh             :func:`make_mesh`: the process group and a 2-D
                        ``DeviceMesh(('data', 'model'))``, data = W / model_axis
  replicate_state       :func:`replicate`: a broadcast from rank 0
  shard_batch, make_multihost_batch
                        :func:`local_rows`; the Loader of each rank decodes
                        its rows alone (``data/loader.py``)
  data_parallel_step    :func:`reduce_grads` in ``train/steps.py::net_update``
  fsdp_shard_state      :func:`fsdp_shard`: ``fully_shard`` per module, the
                        parameters sharded over 'model' and replicated over
                        'data' (HSDP on the 2-D mesh)
  spatial_shard_batch   :func:`spatial_rows` on the Loader's rows (the
                        Trainer's ``img_*``, ``lab_*``, ``plabel_*``); GSPMD's
                        halo exchange through the conv stages is
                        :mod:`.spatial`
"""
from __future__ import annotations

import contextlib
import itertools
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn


@dataclass
class Mesh:
    """The process grid: rank = data_rank * model_size + model_rank. With
    ``spatial`` the image rows are split over the model ranks: the model
    ranks of a data rank form ``model_group`` and every process the
    ``pixel_group``."""
    data_size: int
    model_size: int
    data_rank: int
    data_group: Any
    device_mesh: Any
    model_rank: int = 0
    spatial: bool = False
    model_group: Any = None
    pixel_group: Any = None

    @property
    def world(self) -> int:
        return self.data_size * self.model_size

    @property
    def pixel_size(self) -> int:
        """The ranks that hold distinct pixels of the global batch."""
        return self.world if self.spatial else self.data_size

    @property
    def reduce_group(self) -> Any:
        """The group of the pixel reductions."""
        return self.pixel_group if self.spatial else self.data_group


_ACTIVE: List[Optional[Mesh]] = []


def launched() -> bool:
    """Whether ``torchrun`` (or another launcher setting ``WORLD_SIZE``)
    started more than one process."""
    return int(os.environ.get("WORLD_SIZE", "1")) > 1


def make_mesh(model_axis: int = 1, backend: Optional[str] = None,
              device: Optional[torch.device] = None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              spatial: bool = False) -> Mesh:
    """The process group (unless one exists) and the ``(data, model)`` mesh
    over it. ``backend`` defaults to nccl on a CUDA ``device`` and gloo on
    the CPU; ``init_method``/``rank``/``world_size`` default to torchrun's
    environment. ``world_size % model_axis`` must be 0. ``spatial`` with
    more than one model rank splits the image rows over the model ranks."""
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if not dist.is_initialized():
        kw = {}
        if init_method is not None:
            kw = dict(init_method=init_method, rank=rank, world_size=world_size)
        dist.init_process_group(backend, **kw)
    world = dist.get_world_size()
    model_axis = max(int(model_axis), 1)
    if world % model_axis:
        raise ValueError(f"{world} processes are not divisible by mesh.model_axis="
                         f"{model_axis}")
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(device.type, (world // model_axis, model_axis),
                          mesh_dim_names=("data", "model"))
    r = dist.get_rank()
    # the steps' own group over the data ranks, apart from the mesh's: FSDP
    # runs its gradient reductions on the mesh's groups from hooks (and on
    # a card from its own streams), which the steps' all-reduces must not
    # interleave with
    groups = [dist.new_group(list(range(m, world, model_axis)))
              for m in range(model_axis)]
    mesh = Mesh(data_size=world // model_axis, model_size=model_axis,
                data_rank=r // model_axis, data_group=groups[r % model_axis],
                device_mesh=dm, model_rank=r % model_axis)
    if spatial and model_axis > 1:
        # every rank makes every group, in one order
        models = [dist.new_group(list(range(d * model_axis, (d + 1) * model_axis)))
                  for d in range(world // model_axis)]
        mesh.model_group = models[mesh.data_rank]
        mesh.pixel_group = dist.new_group(list(range(world)))
        mesh.spatial = True
    return mesh


def release(synced: bool = False) -> None:
    """Destroy the process group (the end of a run or of a test's rank).
    ``synced``: after a barrier, so that no rank tears down its connections
    while a peer is still inside a collective with it (a gloo peer then
    aborts); a rank that failed passes False, and its peers' collectives
    fail at once instead of waiting for it."""
    if dist.is_initialized():
        if synced and dist.get_world_size() > 1:
            dist.barrier()
        dist.destroy_process_group()


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Within the block the steps' reductions run over ``mesh`` (None: a
    one-process block)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def current() -> Optional[Mesh]:
    return _ACTIVE[-1] if _ACTIVE else None


def data_parallel() -> bool:
    """The active mesh splits the global batch's pixels over more than one
    rank (more than one data rank, or spatial partitioning): the losses and
    statistics then reduce over the pixel group."""
    m = current()
    return m is not None and m.pixel_size > 1


def data_size() -> int:
    """The data ranks of the active mesh (1 without one)."""
    m = current()
    return 1 if m is None else m.data_size


def pixel_size() -> int:
    """The ranks of the active mesh that hold distinct pixels (1 without
    one): a rank's share of a global loss is the loss over this."""
    m = current()
    return 1 if m is None else m.pixel_size


def spatial() -> Optional[Mesh]:
    """The active mesh when it splits image rows over its model ranks."""
    m = current()
    return m if m is not None and m.spatial else None


class _AllSum(torch.autograd.Function):
    """Sum over a group; the backward sums the cotangents over it."""

    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        t = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return None, grad


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the pixel group, differentiable (its backward
    sums the cotangents); ``t`` itself with one rank in it."""
    m = current()
    if m is None or m.pixel_size == 1:
        return t
    return _AllSum.apply(m.reduce_group, t)


def sample_sum(t: torch.Tensor) -> torch.Tensor:
    """Per-sample partial sums (a rank's row band of each image) summed
    over the model ranks under spatial partitioning, differentiable: every
    model rank then holds the samples' whole sums; ``t`` itself otherwise."""
    m = spatial()
    if m is None:
        return t
    return _AllSum.apply(m.model_group, t)


def sum_over(mesh: Optional[Mesh], t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over ``mesh``'s pixel group (none: ``t``)."""
    if mesh is not None and mesh.pixel_size > 1:
        dist.all_reduce(t, group=mesh.reduce_group)
    return t


def kernel_mesh() -> Optional[Mesh]:
    """The mesh a kernel's wrapper reduces over: the active one when it
    splits the pixels, else None. Its autograd Function keeps it for the
    backward, which sums the cotangents with :func:`sum_over`."""
    return current() if data_parallel() else None


def kernel_forward(mesh: Optional[Mesh]) -> dict:
    """The parallel argument of a kernel's forward wrapper: none without a
    mesh, else ``reduce``, the sum of the partials over its pixel group
    between the two launches."""
    if mesh is None:
        return {}
    return {"reduce": lambda t: sum_over(mesh, t)}


def kernel_grad(mesh: Optional[Mesh], grad: torch.Tensor) -> torch.Tensor:
    """A global loss's cotangent as its kernel's backward needs it: the sum
    of every rank's in the pixel group (their shares of the loss)."""
    grad = grad.float().reshape(1).contiguous()
    return grad if mesh is None else sum_over(mesh, grad.clone())


def gmean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the global batch: ``x.mean()`` with one rank
    in the pixel group, else the all-summed sum over the all-summed element
    count (ranks may hold different numbers of rows, as RAIN's stylised
    ones or a discriminator's uneven row bands)."""
    if not data_parallel():
        return x.mean()
    num, den = global_sums(x.sum(), float(x.numel()))
    return num / den


def global_sums(*values) -> tuple:
    """Scalars (tensors or numbers) summed over the pixel group in one
    differentiable all-reduce, in float32; unchanged with one data rank."""
    if not data_parallel():
        return values
    ref = next(v for v in values if torch.is_tensor(v))
    flat = torch.stack([v.float().reshape(()) if torch.is_tensor(v)
                        else torch.tensor(float(v), device=ref.device) for v in values])
    return tuple(all_sum(flat).unbind())


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This data rank's rows (dim 0) of a global-batch tensor."""
    m = current()
    if m is None or m.data_size == 1:
        return x
    b = x.shape[0] // m.data_size
    return x.narrow(0, m.data_rank * b, b)


def spatial_rows(x, key: str = "", mesh: Optional[Mesh] = None):
    """This model rank's band of the image rows (dim 1) of a batch tensor or
    array ``(B, H, ...)`` under spatial partitioning of ``mesh`` (default:
    the active one; ``x`` itself without a row split). ``H`` must divide
    over the model ranks: where JAX keeps such a key whole on every model
    rank, the port raises ``ValueError``."""
    m = mesh if mesh is not None else spatial()
    if m is None or not m.spatial:
        return x
    h = x.shape[1]
    if h % m.model_size:
        raise ValueError(f"mesh.spatial: {key or 'a batch tensor'} has H={h} rows, not "
                         f"divisible by {m.model_size} model ranks")
    band = h // m.model_size
    return x[:, m.model_rank * band:(m.model_rank + 1) * band]


def local_pixels(flat: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """This rank's entries of ``flat``, one per pixel of the global batch in
    ``shape`` = (B, H, W) order: its data rank's rows, and under spatial
    partitioning its band of each image's rows, flattened as its own
    tensors are."""
    if spatial() is None:
        return local_rows(flat)
    return spatial_rows(local_rows(flat.reshape(tuple(shape)))).reshape(-1)


def global_shape(shape: Sequence[int]) -> tuple:
    """The global batch's shape of a local ``shape`` (rows on dim 0)."""
    return (shape[0] * data_size(), *shape[1:])


def global_image_shape(shape: Sequence[int]) -> tuple:
    """The global batch's (B, H, W) of a rank's (B, H, W): its data rank's
    rows times the data ranks, and under spatial partitioning its band of
    rows times the model ranks."""
    m = spatial()
    h = shape[1] * (m.model_size if m is not None else 1)
    return (shape[0] * data_size(), h, *shape[2:])


def first_rows(t: torch.Tensor) -> torch.Tensor:
    """Data rank 0's ``t`` on every data rank (without gradient): the global
    batch's first rows where a step reads them (RAIN's style pair). The
    broadcast runs over this rank's data group, the ranks of its model rank,
    so under spatial partitioning each model rank receives data rank 0's
    band of its own rows."""
    m = current()
    if m is None or m.data_size == 1:
        return t
    t = t.detach().contiguous().clone()
    dist.broadcast(t, src=dist.get_global_rank(m.data_group, 0), group=m.data_group)
    return t


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of ``t`` (this data rank's rows on dim 0) on
    every data rank, without gradient (:func:`local_rows`' inverse): each
    rank's rows in its slot of zeros, summed over the data group, which is
    exact."""
    m = current()
    if m is None or m.data_size == 1:
        return t
    out = t.new_zeros((t.shape[0] * m.data_size, *t.shape[1:]))
    out.narrow(0, m.data_rank * t.shape[0], t.shape[0]).copy_(t.detach())
    dist.all_reduce(out, group=m.data_group)
    return out


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def reduce_grads(params: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of ``params`` over the pixel group (the JAX step's
    psum). Replicated gradients take one all-reduce of a flat buffer per
    dtype over every process, divided by the model ranks when those are
    replicas holding the same rows (not under spatial partitioning, where
    each holds a partial sum); FSDP's sharded ones arrive as the mean over
    every process and are scaled to the sum over the pixel group."""
    m = current()
    if m is None or m.pixel_size == 1:
        # one data rank without a row split: the model ranks hold the same
        # rows, so their replicated gradients are equal and the sum is the
        # identity
        return
    plain: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        g = p.grad
        if g is None:
            continue
        if is_dtensor(g):
            g.mul_(m.pixel_size)
            continue
        plain.setdefault(g.dtype, []).append(g)
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
    for grads in plain.values():
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        if m.model_size > 1 and not m.spatial:
            flat.div_(m.model_size)
        for g, f in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(f)


def replicate(*objs) -> None:
    """Broadcast from rank 0 every parameter and buffer of the modules and
    every tensor among ``objs`` (the JAX ``replicate_state``), in place."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for obj in objs:
        if obj is None:
            continue
        tensors = (itertools.chain(obj.parameters(), obj.buffers())
                   if isinstance(obj, nn.Module) else [obj])
        for t in tensors:
            dist.broadcast(t.data, src=0)


def broadcast_value(value):
    """Rank 0's picklable ``value`` on every rank (a decision every rank
    must share: the validation score, the early stop)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def from_writer(fn):
    """``fn()`` run on rank 0 alone, its result on every rank (a file only
    rank 0's host may hold: a checkpoint it wrote). An exception on rank 0
    is raised on every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return fn()
    box = [None]
    if dist.get_rank() == 0:
        try:
            box[0] = (True, fn())
        except Exception as e:  # re-raised on every rank below
            box[0] = (False, e)
    dist.broadcast_object_list(box, src=0)
    ok, value = box[0]
    if not ok:
        raise value
    return value


def is_writer() -> bool:
    """Rank 0, or a run without a process group: the one that writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------
def fsdp_shard(net: nn.Module, opts: Sequence[torch.optim.Optimizer],
               mesh: Mesh, min_size: int = 2 ** 16) -> int:
    """``fully_shard`` each module of ``net`` that holds parameters, has no
    submodule holding any, and whose largest parameter has ``min_size``
    elements or more, over ``mesh`` (HSDP: sharded on dim 0 over 'model',
    replicated over 'data'). JAX's ``fsdp_shard_state`` decides per leaf
    (``size >= min_size`` and some axis divisible by the model ranks); a
    module here is the unit, its parameters sharded on dim 0 (padded when
    uneven), and the small ones stay replicated. The optimizers' groups are
    pointed at the sharded parameters (they must hold no state yet).
    Returns the number of sharded modules; none at one model rank."""
    if mesh.model_size == 1:
        return 0
    from torch.distributed.fsdp import fully_shard
    with torch.no_grad():       # FSDP shards contiguous (not channels_last) weights
        for p in net.parameters():
            p.data = p.data.contiguous()
    names = {id(p): n for n, p in net.named_parameters()}
    n = 0
    for mod in list(net.modules()):
        own = list(mod.parameters(recurse=False))
        if not own or any(True for c in mod.children() for _ in c.parameters()):
            continue
        if max(p.numel() for p in own) >= min_size:
            fully_shard(mod, mesh=mesh.device_mesh)
            n += 1
    params = dict(net.named_parameters())
    for opt in opts:
        if opt is None:
            continue
        for group in opt.param_groups:
            group["params"] = [params[names[id(p)]] if id(p) in names else p
                               for p in group["params"]]
    return n


def _full(v):
    if is_dtensor(v):
        return v.full_tensor()
    if isinstance(v, dict):
        return {k: _full(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_full(x) for x in v]
    return v


def full_state_dict(obj) -> dict:
    """``obj.state_dict()`` (a module or an optimizer) with every sharded
    tensor gathered whole: the one-process layout. Every rank must call it."""
    return _full(obj.state_dict())


def _like(ref, v):
    """``v`` (a whole tensor) laid out as ``ref``: sharded as ``ref`` when it
    is a DTensor of the same global shape."""
    from torch.distributed.tensor import distribute_tensor
    if is_dtensor(ref) and torch.is_tensor(v) and tuple(v.shape) == tuple(ref.shape):
        return distribute_tensor(v.to(ref.device, ref.dtype), ref.device_mesh,
                                 ref.placements)
    return v


def load_full_state_dict(obj, sd: dict) -> None:
    """Load a whole (one-process) state dict into a module or optimizer
    whose tensors may be sharded. Every rank must call it."""
    if isinstance(obj, nn.Module):
        cur = obj.state_dict()
        obj.load_state_dict({k: _like(cur.get(k), v) for k, v in sd.items()})
        return
    params = [p for g in obj.param_groups for p in g["params"]]
    state = {i: {k: _like(params[int(i)], v) for k, v in s.items()}
             for i, s in sd["state"].items()}
    obj.load_state_dict({**sd, "state": state})
