"""RAIN's style net on the port against ``slcl_tpu/models/rain.py``: the same
random flax weights moved to torch, the same inputs, on the CPU in float32.

Held: ``calc_mean_std``, ``adain_with_noise``, the encoder's four taps (at
H = 64, and at an odd H = 33 for the floor of the 2x2 max-pool), the
decoder, the fc nets, ``losses`` (values and the gradients of the
pretraining sum) and ``style_transfer`` (a fresh sampling and a given one,
with the gradient reaching the sampling); the parameter count against
``jax.eval_shape``; a reference-layout Sequential ``.pth`` read by both
packages; and the port's exported ``.npz`` read back by the JAX package.

flax hands ``losses`` and ``style_transfer`` the same noise under the same
``rngs``, so the noise is recovered as ``(sampling - mean) / std`` from the
JAX ``fc_encoder`` and passed to the port. Tolerances: outputs rtol 1e-4 /
atol 1e-5 in float32. Gradients are held in float64 on both sides
(``jax.enable_x64``, the port's module in double), as
``tests/test_torch_backbones.py`` holds the ResNets: the pretraining sum's
gradient runs back through the decoder and a second VGG pass, and in
float32 the port's CPU convolutions leave it 9e-4 of its largest entry
from the float64 value (JAX's 2e-4). The JAX side still takes its
statistics in float32 (``calc_mean_std`` casts), which leaves the float64
gradients 1.5e-6 apart in relative norm and 2e-6 of a tensor's largest
entry (up to 185) elementwise; each gradient tensor is held to rtol 1e-4
with an atol of 1e-5 times its largest entry, and to a relative norm error
of 1e-4.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.models import rain as T
from slcl_torch.utils.convert import (RAIN_SEQUENTIAL, load_flax_weights,
                                      read_rain_component, state_dict_to_flax)
from slcl_tpu.models import rain as J
from slcl_tpu.utils import torch_convert as tc

torch.set_num_threads(1)

H = 64
PARTS = ("encoder", "decoder", "fc_encoder", "fc_decoder")
N_PARAMS = {"encoder": 3_505_740, "decoder": 3_505_219, "fc_encoder": 3_148_800,
            "fc_decoder": 2_624_512}
WEIGHTS = (1.0, 1.0, 1.0, 5.0)          # content, style, latent, recon (RAINConfig)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(got, want, what, rtol=1e-4, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def _close_grad(got, want, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * scale, err_msg=what)
    assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), what


def _nets(seed=0):
    model = J.RAIN()
    x = jnp.zeros((1, H, H, 3), jnp.float32)
    params = model.init({"params": jax.random.PRNGKey(seed),
                         "noise": jax.random.PRNGKey(seed + 1)}, x, x)["params"]
    port = load_flax_weights(T.RAIN().to(memory_format=torch.channels_last), _np(params))
    return model, params, port


@pytest.fixture(scope="module")
def nets():
    return _nets()


def _images(n, size=H, seed=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, size=(n, size, size, 3)).astype(np.float32)


def _jax_noise(model, params, content, style, key):
    """The noise flax draws inside ``losses``/``style_transfer`` under
    ``rngs={'noise': key}``, from style_transfer's sampling."""
    _, samp = model.apply({"params": params}, content, style, None,
                          method="style_transfer", rngs={"noise": key})
    stats = J.calc_feat_mean_std(model.apply({"params": params}, style, method="encode"))
    inter = model.apply({"params": params}, stats, method=lambda m, s: m.fc_encoder(s))
    return torch.from_numpy(np.array((samp - inter[:, :512]) / inter[:, 512:]))


@pytest.mark.parametrize("shape", [(2, 8, 8, 16), (1, 5, 7, 512)])
def test_calc_mean_std_and_adain(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, size=shape).astype(np.float32)
    stats = rng.normal(size=(shape[0], 2 * shape[-1])).astype(np.float32)
    jm, js = J.calc_mean_std(jnp.asarray(x))
    tm, ts = T.calc_mean_std(torch.from_numpy(x))
    _close(tm, jm, "mean")
    _close(ts, js, "std")
    _close(T.calc_feat_mean_std(torch.from_numpy(x)), J.calc_feat_mean_std(jnp.asarray(x)),
           "feat stats")
    _close(T.adain_with_noise(torch.from_numpy(x), torch.from_numpy(stats)),
           J.adain_with_noise(jnp.asarray(x), jnp.asarray(stats)), "adain")
    # one style row broadcast over the content batch (mulstyle2)
    _close(T.adain_with_noise(torch.from_numpy(x), torch.from_numpy(stats[:1])),
           J.adain_with_noise(jnp.asarray(x), jnp.asarray(stats[:1])), "adain broadcast")


def test_parameter_count_matches_eval_shape(nets):
    model, _, port = nets
    x = jax.ShapeDtypeStruct((1, H, H, 3), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: model.init(
        {"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)}, a, b), x, x)
    for part in PARTS:
        want = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(shapes["params"][part]))
        got = sum(p.numel() for p in getattr(port, part).parameters())
        assert got == want == N_PARAMS[part], part
    assert sum(p.numel() for p in port.parameters()) == 12_784_271


@pytest.mark.parametrize("size", [H, 33])
def test_encoder_taps(nets, size):
    model, params, port = nets
    x = _images(2, size)
    want = model.apply({"params": params}, jnp.asarray(x), method="encode_with_intermediate")
    got = port.encode_with_intermediate(torch.from_numpy(x))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"relu{i + 1}_1")


def test_decoder_and_fc_nets(nets):
    model, params, port = nets
    rng = np.random.default_rng(1)
    feat = np.abs(rng.normal(size=(2, 8, 8, 512))).astype(np.float32)
    want = model.apply({"params": params}, jnp.asarray(feat),
                       method=lambda m, f: m.decoder(f))
    got = T.nhwc(port.decoder(T.nchw(torch.from_numpy(feat))))
    _close(got, want, "decoder")
    for part, width in (("fc_encoder", 1024), ("fc_decoder", 512)):
        z = rng.normal(size=(3, width)).astype(np.float32)
        want = model.apply({"params": params}, jnp.asarray(z),
                           method=lambda m, v, p=part: getattr(m, p)(v))
        _close(getattr(port, part)(torch.from_numpy(z)), want, part)


def _jax64(model, params):
    return (model.clone(dtype=jnp.float64),
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params))


@pytest.mark.parametrize("n_content,n_style", [(1, 1), (2, 1), (2, 2)])
def test_losses_and_their_gradients(nets, n_content, n_style):
    model, params, port = nets
    c, s = _images(n_content, seed=4), _images(n_style, seed=5)
    key = jax.random.PRNGKey(11)
    noise = _jax_noise(model, params, jnp.asarray(c), jnp.asarray(s), key)
    want = model.apply({"params": params}, jnp.asarray(c), jnp.asarray(s),
                       method="losses", rngs={"noise": key})
    with torch.no_grad():
        got = port.losses(torch.from_numpy(c), torch.from_numpy(s), noise)
    for name, g, w in zip(("loss_c", "loss_s", "loss_l", "loss_r"), got, want):
        _close(g, w, name)
    if (n_content, n_style) != (2, 1):
        return      # the gradients once: a content batch against one style

    with jax.enable_x64():
        m64, p64 = _jax64(model, params)
        c64, s64 = jnp.asarray(c, jnp.float64), jnp.asarray(s, jnp.float64)
        noise64 = _jax_noise(m64, p64, c64, s64, key)

        def total(p):
            ls = m64.apply({"params": p}, c64, s64, method="losses", rngs={"noise": key})
            return sum(w * l for w, l in zip(WEIGHTS, ls))

        jg = _np(jax.jit(jax.grad(total))(p64))
    port64 = copy.deepcopy(port).double()
    got = port64.losses(torch.from_numpy(c).double(), torch.from_numpy(s).double(), noise64)
    sum(w * l for w, l in zip(WEIGHTS, got)).backward()
    for key_, p in port64.named_parameters():
        part, layer, leaf = key_.split(".")
        if part == "encoder":
            continue        # frozen: the pretraining zeroes its gradient
        w = jg[part][layer]["kernel" if leaf == "weight" else "bias"]
        g = p.grad.numpy()
        if g.ndim == 4:
            g = np.transpose(g, (2, 3, 1, 0))
        elif g.ndim == 2:
            g = g.T
        _close_grad(g, w, f"grad {key_}")


@pytest.mark.parametrize("n_content,n_style", [(1, 1), (2, 1)])
def test_style_transfer_fresh_and_given_sampling(nets, n_content, n_style):
    model, params, port = nets
    c, s = _images(n_content, seed=6), _images(n_style, seed=7)
    key = jax.random.PRNGKey(5)
    noise = _jax_noise(model, params, jnp.asarray(c), jnp.asarray(s), key)
    want_img, want_samp = model.apply({"params": params}, jnp.asarray(c), jnp.asarray(s),
                                      None, method="style_transfer", rngs={"noise": key})
    with torch.no_grad():
        got_img, got_samp = port.style_transfer(torch.from_numpy(c), torch.from_numpy(s),
                                                noise=noise)
    _close(got_samp, want_samp, "sampling")
    _close(got_img, want_img, "stylised")
    # a given sampling (the epsilon ascent's): the image, and the gradient
    # of sum(image^2) that reaches the sampling (in float64, see above)
    samp = np.asarray(want_samp) + 0.1
    with torch.no_grad():
        got_img, _ = port.style_transfer(torch.from_numpy(c), torch.from_numpy(s),
                                         torch.from_numpy(samp))
    want_img, _ = model.apply({"params": params}, jnp.asarray(c), jnp.asarray(s),
                              jnp.asarray(samp), method="style_transfer",
                              rngs={"noise": key})
    _close(got_img, want_img, "stylised, given sampling")
    with jax.enable_x64():
        m64, p64 = _jax64(model, params)
        c64, s64 = jnp.asarray(c, jnp.float64), jnp.asarray(s, jnp.float64)

        def f(sm):
            img, _ = m64.apply({"params": p64}, c64, s64, sm, method="style_transfer",
                               rngs={"noise": key})
            return jnp.sum(img ** 2)

        jgrad = np.asarray(jax.grad(f)(jnp.asarray(samp, jnp.float64)))
    leaf = torch.from_numpy(samp).double().requires_grad_(True)
    img, _ = copy.deepcopy(port).double().style_transfer(
        torch.from_numpy(c).double(), torch.from_numpy(s).double(), leaf)
    (img ** 2).sum().backward()
    _close_grad(leaf.grad, jgrad, "d/d sampling")


def _sequential_files(tmp_path):
    """Reference-layout ``.pth`` files of random weights: Sequential indices,
    torch layouts, the VGG with a layer past relu4_1 that both skip."""
    rng = np.random.default_rng(9)
    port = T.RAIN()
    paths = {}
    for part in PARTS:
        sd = {}
        module = getattr(port, part)
        for idx, name in RAIN_SEQUENTIAL[part].items():
            for leaf in ("weight", "bias"):
                shape = getattr(getattr(module, name), leaf).shape
                sd[f"{idx}.{leaf}"] = torch.from_numpy(
                    rng.normal(0, 0.05, size=tuple(shape)).astype(np.float32))
        if part == "encoder":
            sd["31.weight"] = torch.zeros(512, 512, 3, 3)
            sd["31.bias"] = torch.zeros(512)
        paths[part] = tmp_path / f"{part}.pth"
        torch.save(sd, paths[part])
    return paths


def test_reference_pth_loads_alike_in_both_packages(tmp_path, nets):
    model, params, _ = nets
    paths = _sequential_files(tmp_path)
    converters = {"encoder": tc.convert_vgg_rain_encoder,
                  "decoder": tc.convert_rain_decoder,
                  "fc_encoder": tc.convert_rain_fc, "fc_decoder": tc.convert_rain_fc}
    port = T.RAIN()
    for part in PARTS:
        merged, report = tc.merge_pretrained(params[part],
                                             converters[part](tc.load_state_dict(
                                                 str(paths[part]))))
        assert not any(r.startswith("!") for r in report), report
        module = getattr(port, part)
        entries, unmatched = read_rain_component(paths[part], part, module)
        assert not unmatched and len(entries) == len(report) == len(module.state_dict())
        module.load_state_dict(entries, strict=True)
        got = state_dict_to_flax(module)["params"]
        for layer, leaves in merged.items():
            for leaf, w in leaves.items():
                np.testing.assert_array_equal(got[layer][leaf], w, err_msg=f"{part} {layer}")


def test_exported_npz_reads_back_in_jax(tmp_path, nets):
    """The trainer's export (``rain_<part>.npz``) through ``load_tree_npz``
    and ``merge_pretrained``: every leaf matched and equal."""
    from slcl_torch.utils.convert import save_tree_npz
    _, params, port = nets
    exported = state_dict_to_flax(port)["params"]
    for part in PARTS:
        path = tmp_path / f"rain_{part}.npz"
        save_tree_npz(path, params=exported[part])
        merged, report = tc.merge_pretrained(params[part], tc.load_tree_npz(str(path))["params"])
        assert report and not any(r.startswith("!") for r in report), report
        for a, b in zip(jax.tree.leaves(merged), jax.tree.leaves(_np(params[part]))):
            np.testing.assert_array_equal(a, b)
        # ... and the port reads its own file back
        entries, unmatched = read_rain_component(path, part, getattr(T.RAIN(), part))
        assert not unmatched and len(entries) == len(report)
