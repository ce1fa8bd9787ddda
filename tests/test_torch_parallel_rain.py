"""RAIN's ``rain.mulstyle`` under data parallelism and ``model.remat=dots``
with the epsilon ascent, on the CPU in float64, after
``tests/test_torch_parallel.py`` and ``tests/test_torch_remat.py``.

- ``mulstyle`` (a sampling row per image of the global batch: each data
  rank stylises its images with its rows of the replicated sampling, a
  fresh one taking its rows of the global noise draw and gathered whole)
  at two data ranks, two steps (a fresh sampling, then the carried one),
  with ``rain.eps_clip`` set below the ascent's step norm so that the clip
  binds: the clip must take the norm of the whole (8, 512) step, not of a
  rank's rows. Held against JAX's step sharded over two devices
  (``make_mesh(2)``, ``shard_batch``) from the port's initial weights, on
  JAX's rMC draw and noise, and against one process: every metric (rel
  1e-5), the whole state (rtol 1e-4 / atol 1e-6), the new sampling among
  it (against JAX at atol 1e-5, ``torch_parallel_common.JAX_ATOL``).
- ``model.remat=dots`` with MCCL + RAIN (the ascent backpropagates the
  checkpointed forward, then the update backpropagates it again: the
  ascent's recompute reads the saved outputs without using them up), two
  steps in one process against remat off (metrics and state within 1e-6,
  ``test_torch_remat.py``'s tolerance) and against JAX's step with
  ``model.remat=dots`` (the tolerances above).
"""
import copy

import numpy as np
import pytest
import torch
import torch_parallel_common as C
from test_torch_parallel_spatial_rain import jax_rain_steps, rain_scheds

from slcl_torch.parallel.dryrun import spawn
from slcl_torch.testing import configure_cell

torch.set_num_threads(1)
MOD = "torch_parallel_common"
F64 = torch.float64
# below the ascent's step norm at these sizes (0.0095 and 0.0085 unclipped)
CLIP = 0.004


def _jax_expected(cfg, batches, tmp, name, n_dev):
    """JAX's steps of ``cfg`` on ``n_dev`` devices (data-parallel) on file,
    and their draws."""
    trainer = C.build_trainer(cfg, str(tmp / f"init_{name}"), F64)
    out, draws = jax_rain_steps(trainer, batches, rain_scheds(), n_dev)
    torch.save(out, tmp / f"jax_{name}.pt")
    return str(tmp / f"jax_{name}.pt"), draws


@pytest.fixture(scope="module")
def mulstyle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mulstyle")
    cfg = configure_cell(C.small_cfg("mccl_rain"), "mccl_rain_mulstyle")
    cfg.rain.eps_clip = CLIP
    batches = C.batches("mccl", 2)
    path, draws = _jax_expected(cfg, batches, tmp, "mulstyle", 2)
    spec = ("mulstyle", cfg, batches, rain_scheds(), F64, draws)
    return spawn(2, "compare_entry", ([spec], str(tmp / "ranks"), {"mulstyle": path}),
                 module=MOD)


@pytest.mark.parametrize("step", [0, 1])
def test_mulstyle_two_data_ranks_match_one_process_and_jax(mulstyle, step):
    for r, got in enumerate(mulstyle):
        rec = got["mulstyle"][step]
        # the clip bound the whole step's norm
        assert rec["metrics"]["eps_step_norm"] == pytest.approx(CLIP, rel=1e-5)
        assert rec["jax_metrics"]["eps_step_norm"] == pytest.approx(CLIP, rel=1e-5)
        C.assert_metrics_close(rec["metrics"], rec["want_metrics"], 1e-5, f"rank {r}")
        assert not rec["errors"], f"rank {r}: {rec['errors'][:8]}"
        C.assert_metrics_close(rec["metrics"], rec["jax_metrics"], 1e-5, f"rank {r} jax")
        assert not rec["jax_errors"], f"rank {r} jax: {rec['jax_errors'][:8]}"


@pytest.fixture(scope="module")
def dots(tmp_path_factory):
    """MCCL + RAIN with remat off and ``dots`` on JAX's draws, and JAX's
    ``dots`` step."""
    tmp = tmp_path_factory.mktemp("dots")
    cfg, batches, _ = C.spatial_run("mccl_rain")
    cfg.mesh.model_axis, cfg.mesh.spatial = 1, False
    cfg.model.remat = "dots"
    path, draws = _jax_expected(cfg, batches, tmp, "dots", 1)
    off = copy.deepcopy(cfg)
    off.model.remat = ""
    runs = {name: C.steps_entry(None, c, batches, rain_scheds(), str(tmp / name), F64,
                                draws=draws)["steps"]
            for name, c in (("off", off), ("dots", cfg))}
    return runs, torch.load(path, weights_only=False)


@pytest.mark.parametrize("step", [0, 1])
def test_dots_with_the_ascent_equals_remat_off_and_jax(dots, step):
    runs, jax_out = dots
    got, off = runs["dots"][step], runs["off"][step]
    assert got["metrics"]["eps_step_norm"] > 0.0       # the ascent ran
    C.assert_metrics_close(got["metrics"], off["metrics"], 0.0, "dots vs off")
    C.assert_state_close(got["state"], off["state"], 0.0, 1e-6, "dots vs off")
    want_m, want = jax_out[step]
    C.assert_metrics_close(got["metrics"], want_m, 1e-5, "dots vs jax")
    errors = C.state_errors(got["state"], want, 1e-4, 1e-6, C.JAX_ATOL)
    assert not errors, errors[:8]
    assert not np.array_equal(runs["dots"][1]["state"]["sampling"],
                              runs["dots"][0]["state"]["sampling"])
