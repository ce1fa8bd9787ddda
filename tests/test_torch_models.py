"""Port parity for the models: flax weights carried into the port's DRUNet
and UncertaintyDiscriminator by ``slcl_torch.utils.convert``, then the same
input through both.

Tolerances: DRUNet eval forward rtol 1e-3 / atol 1e-4, atol 2e-3 for aux
(those of test_reference_model_parity.py:114-124); BatchNorm running
statistics after one train-mode forward rtol 1e-4 / atol 1e-5 (f32 means and
variances of the same activations, reduced in another order). The
projection head (``phead``, MCCL's preset) is held in train mode, alone and
with the aux head, at the same tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.models import DRUNet as TDRUNet
from slcl_torch.models import UncertaintyDiscriminator as TDisc
from slcl_torch.utils.convert import flax_to_state_dict, load_flax_weights, state_dict_to_flax
from slcl_tpu.models import DRUNet, UncertaintyDiscriminator

torch.set_num_threads(1)

SMALL = dict(filters=8, n_block=2, bottleneck_depth=2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _perturb(tree, rng):
    """Noise on flax's trivial inits (BN scale 1, zero biases), so the
    parity covers every tensor."""
    return jax.tree.map(
        lambda a: a + rng.normal(size=a.shape).astype(np.float32) * 0.1, tree)


def _flax_drunet(multilvl, rng, phead=False):
    model = DRUNet(multilvl=multilvl, phead=phead, dtype=jnp.float32, **SMALL)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), False)
    params = _perturb(_np_tree(v["params"]), rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.abs(a + rng.normal(size=a.shape).astype(np.float32)) + 0.5
                      if p[-1].key == "var"
                      else a + rng.normal(size=a.shape).astype(np.float32) * 0.1),
        _np_tree(v["batch_stats"]))
    return model, params, stats


def _port_drunet(multilvl, params, stats, phead=False):
    m = TDRUNet(multilvl=multilvl, phead=phead, **SMALL).to(memory_format=torch.channels_last)
    return load_flax_weights(m, params, stats)


@pytest.mark.parametrize("multilvl", [False, True])
def test_drunet_eval_forward_matches_flax(multilvl, rng):
    model, params, stats = _flax_drunet(multilvl, rng)
    port = _port_drunet(multilvl, params, stats).eval()
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x), False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.pred.numpy(), np.asarray(want.pred), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.dcdr_ft.numpy(), np.asarray(want.dcdr_ft),
                               rtol=1e-3, atol=1e-4)
    if multilvl:
        np.testing.assert_allclose(got.aux.numpy(), np.asarray(want.aux),
                                   rtol=1e-3, atol=2e-3)
    else:
        assert got.aux is None and want.aux is None


def _check_train_forward(multilvl, phead, rng):
    model, params, stats = _flax_drunet(multilvl, rng, phead)
    port = _port_drunet(multilvl, params, stats, phead).train()
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    want, upd = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            True, mutable=["batch_stats"])
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.pred.detach().numpy(), np.asarray(want.pred),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.dcdr_ft.detach().numpy(), np.asarray(want.dcdr_ft),
                               rtol=1e-3, atol=1e-4)
    if multilvl:
        np.testing.assert_allclose(got.aux.detach().numpy(), np.asarray(want.aux),
                                   rtol=1e-3, atol=2e-3)
    got_stats = state_dict_to_flax(port)["batch_stats"]
    want_flat = jax.tree_util.tree_flatten_with_path(_np_tree(upd["batch_stats"]))[0]
    for path, w in want_flat:
        node = got_stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, w, rtol=1e-4, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_drunet_train_forward_running_stats_match_flax(rng):
    """flax updates the running variance with the biased batch variance."""
    _check_train_forward(True, False, rng)


@pytest.mark.parametrize("multilvl", [False, True])
def test_drunet_phead_train_forward_matches_flax(multilvl, rng):
    """dcdr_ft = phead2(relu(phead1(decoder_ft))): the weights carried by
    name (phead1/phead2), the features, and the running statistics."""
    _check_train_forward(multilvl, True, rng)


def test_discriminator_forward_matches_flax(rng):
    disc = UncertaintyDiscriminator(dtype=jnp.float32)
    v = disc.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 4)))
    port = load_flax_weights(TDisc(), _np_tree(v["params"]))
    x = rng.normal(size=(2, 32, 32, 4)).astype(np.float32)
    want = disc.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("multilvl,phead,count", [(False, False, 13_483_844),
                                                  (True, False, 13_484_104),
                                                  (False, True, 13_488_036)])
def test_drunet_full_width_parameter_count(multilvl, phead, count):
    m = TDRUNet(filters=32, n_block=4, bottleneck_depth=4, multilvl=multilvl, phead=phead)
    assert sum(p.numel() for p in m.parameters()) == count


def test_convert_raises_on_unused_missing_and_mismatched(rng):
    _, params, stats = _flax_drunet(False, rng)
    port = TDRUNet(multilvl=False, **SMALL)
    extra = dict(params, ghost={"kernel": np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(KeyError, match="ghost"):
        flax_to_state_dict(port, extra, stats)
    with pytest.raises(KeyError, match="running_mean"):
        flax_to_state_dict(port, params, None)
    bad = dict(params, classifier={"kernel": np.zeros((1, 1, 8, 5), np.float32),
                                   "bias": np.zeros((5,), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        flax_to_state_dict(port, bad, stats)


def test_state_dict_to_flax_round_trips(rng):
    _, params, stats = _flax_drunet(True, rng)
    port = _port_drunet(True, params, stats)
    back = state_dict_to_flax(port)
    for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_flatten_with_path(params)[0],
            jax.tree_util.tree_flatten_with_path(back["params"])[0]):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        np.testing.assert_array_equal(a, b)
