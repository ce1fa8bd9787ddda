"""Helpers shared by the parity tests of DDFSeg, AdaptEvery and BCL in the
port (``test_torch_ddfseg.py``, ``test_torch_adaptevery.py``,
``test_torch_bcl.py``, ``test_torch_extra_trainer.py``): numpy-drawn flax
variables, one dropout mask per (module path, call within a pass) for both
sides, and tree comparisons.

Dropout: a mask is a function of the module's flax path and the number of
calls of that path since the current ``apply`` began, which is what the
JAX package's dropout key depends on. The JAX side takes the masks through
a ``flax.linen.intercept_methods`` interceptor (the count restarts at each
root module call), the port through ``build_step(..., draw_dropout=)`` or
``dropout_pass``. Under ``jax.jit`` the masks are drawn at trace time, so
every step of one JAX step function drops alike; the port's hook ignores
the step number to match.
"""
import contextlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import linen as nn


def mask(path: str, call: int, shape, keep: float) -> np.ndarray:
    """The test's dropout mask of one (path, call)."""
    rng = np.random.default_rng([zlib.crc32(path.encode()), call])
    return rng.random(tuple(shape)) < keep


@contextlib.contextmanager
def jax_masks():
    """Every train-mode ``nn.Dropout`` of the JAX models inside the block
    drops by :func:`mask`."""
    counts = {}

    def icpt(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if ctx.method_name == "__call__" and mod.scope is not None and not mod.path:
            counts.clear()
        if (isinstance(mod, nn.Dropout) and ctx.method_name == "__call__"
                and not mod.deterministic and mod.rate > 0.0):
            x = args[0]
            path = "/".join(mod.path)
            call = counts.get(path, 0)
            counts[path] = call + 1
            keep = 1.0 - mod.rate
            m = jnp.asarray(mask(path, call, x.shape, keep))
            return jnp.where(m, x / keep, jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(icpt):
        yield


def port_masks(step, path, call, shape, keep, device):
    """``draw_dropout`` for the port's steps: :func:`mask`, any step."""
    return torch.from_numpy(mask(path, call, shape, keep)).to(device)


def port_pass_draw(path, call, shape, keep, device):
    """A ``dropout_pass`` draw giving :func:`mask`."""
    return port_masks(0, path, call, shape, keep, device)


def draw_variables(init, seed):
    """Variables at the shapes ``init()`` gives under ``jax.eval_shape``
    (flax's op-by-op ``init`` takes tens of seconds on the CPU), from a numpy
    seed: kernels N(0, 1)/sqrt(fan_in), norm scales 1 + 0.1 N(0, 1), biases
    and means 0.1 N(0, 1), variances |N(0, 1)| + 0.5, the attention's gamma
    0.5 + 0.1 N(0, 1) (not 0, so the attention reaches the output)."""
    shapes = jax.eval_shape(init)
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        n = rng.normal(size=s.shape).astype(np.float32)
        if name == "kernel":
            return n / np.float32(np.sqrt(np.prod(s.shape[:-1])))
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "var":
            return np.abs(n) + 0.5
        if name == "gamma":
            return 0.5 + 0.1 * n
        return 0.1 * n
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def grads_as_flax(module, grads=None):
    """The gradients of ``module``'s parameters (``grads`` by parameter name,
    else each ``.grad``; none counts as zero) in flax's layout: the
    parameters swapped for their gradients, read by ``state_dict_to_flax``,
    then put back."""
    from slcl_torch.utils.convert import state_dict_to_flax
    named = dict(module.named_parameters())
    grads = grads or {k: p.grad for k, p in named.items()}
    saved = {k: p.detach().clone() for k, p in named.items()}
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(grads[k] if grads[k] is not None else torch.zeros_like(p))
    out = state_dict_to_flax(module)["params"]
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(saved[k])
    return out


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float64), tree)


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), tree)


def assert_tree_close(got, want, rtol, atol, what):
    """|got - want| <= atol + rtol |want| at every leaf of ``want``; ``got``
    has the same leaves."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    for path, w in flat:
        node = got
        for p in path:
            node = node[p.key]
        node, w = np.asarray(node, np.float64), np.asarray(w, np.float64)
        assert node.shape == w.shape, (what, jax.tree_util.keystr(path))
        bad = np.abs(node - w) > atol + rtol * np.abs(w)
        assert not bad.any(), (f"{what} {jax.tree_util.keystr(path)}: {int(bad.sum())} of "
                               f"{bad.size} off, max |err| {np.abs(node - w).max():.3g}")
    assert len(jax.tree.leaves(got)) == len(flat), what


def assert_grads_close(got, want, what):
    """Gradients, as tests/test_torch_rain_model.py holds them: each tensor
    at rtol 1e-4 with an atol of 1e-5 times its largest entry, and its
    error's norm within 1e-4 of its norm. A tensor whose gradient is zero in
    exact arithmetic (a conv bias before a norm: rounding noise on both
    sides, under 1e-9 of the tree's largest gradient entry in float64) is
    held under that bound on both sides."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    floor = 1e-9 * max(np.abs(np.asarray(w)).max() for _, w in flat)
    for path, w in flat:
        node = got
        for p in path:
            node = node[p.key]
        node, w = np.asarray(node, np.float64), np.asarray(w, np.float64)
        where = f"{what} {jax.tree_util.keystr(path)}"
        if np.abs(w).max() < floor:
            assert np.abs(node).max() < floor, where
            continue
        np.testing.assert_allclose(node, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=where)
        assert np.linalg.norm(node - w) <= 1e-4 * np.linalg.norm(w), where
    assert len(jax.tree.leaves(got)) == len(flat), what
