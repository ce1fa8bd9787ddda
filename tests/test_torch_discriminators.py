"""The discriminators no model factory calls (``OutputDiscriminator``,
``BoundaryDiscriminator``, ``MLPDiscriminator``; reference GAN.py:8-87,
148-210) against flax's from converted weights, in f32: the forward and the
gradient with respect to the input, rtol 1e-4 and atol 1e-5 (outputs) or
1e-4 of the largest gradient (the same convs and matmuls summed in another
order; the 224x224 conv stack's outputs sum ~4000 products each). The
resize to 224 is held growing (56) and at its size: shrinking, both
antialias, and the filters' weights at the image edges differ by ~4e-4 of
the largest gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.models import BoundaryDiscriminator as TBoundary
from slcl_torch.models import MLPDiscriminator as TMLP
from slcl_torch.models import OutputDiscriminator as TOutput
from slcl_torch.utils.convert import load_flax_weights
from slcl_tpu.models import BoundaryDiscriminator, MLPDiscriminator, OutputDiscriminator

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _check(flax_model, port, x, rtol=1e-4, atol=1e-5):
    v = flax_model.init(jax.random.PRNGKey(3), jnp.asarray(x))
    port = load_flax_weights(port, _np_tree(v["params"]))

    def f(z):
        return flax_model.apply(v, z).sum() * 1e-2
    want, gwant = jax.value_and_grad(f)(jnp.asarray(x))
    out_j = flax_model.apply(v, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = port(xt)
    (g,) = torch.autograd.grad(out.sum() * 1e-2, xt)
    assert tuple(out.shape) == out_j.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=rtol, atol=atol)
    gwant = np.asarray(gwant)
    np.testing.assert_allclose(g.numpy(), gwant, rtol=rtol,
                               atol=1e-4 * float(np.abs(gwant).max()))


@pytest.mark.parametrize("softmax", [False, True])
@pytest.mark.parametrize("side", [56, 224])
def test_output_discriminator_matches_flax(rng, softmax, side):
    x = rng.normal(size=(2, side, side, 4)).astype(np.float32)
    _check(OutputDiscriminator(softmax=softmax, dtype=jnp.float32),
           TOutput(4, softmax=softmax), x)


@pytest.mark.parametrize("channels", [1, 3])
def test_boundary_discriminator_matches_flax(rng, channels):
    x = rng.normal(size=(2, 64, 64, channels)).astype(np.float32)
    _check(BoundaryDiscriminator(dtype=jnp.float32), TBoundary(channels), x)


def test_mlp_discriminator_matches_flax(rng):
    x = rng.normal(size=(3, 8, 8, 4)).astype(np.float32)
    _check(MLPDiscriminator(dtype=jnp.float32), TMLP(8 * 8 * 4), x)
