"""MCCL + RAIN on the port against ``slcl_tpu/train/steps.py``'s
``make_mccl_step`` with ``rain.enabled``: two epsilon iterations of one
batch (a fresh sampling, then the carried one), from the same weights
(drawn with numpy at flax's shapes, moved to torch), batch and ``sched``,
with JAX's own rMC draw (``draw_assign``) and noise (``draw_noise``,
recovered as ``(sampling - mean) / std`` from its ``fc_encoder``) handed to
the port. ``tests/torch_rain_common.py`` holds the runs; this file takes the
default and ``style_alpha``, ``test_torch_step_mccl_rain_mulstyle.py``
``mulstyle`` and ``mulstyle2``, ``test_torch_step_mccl_rain_concat.py``
``concat_forward`` and ``mulstyle2`` with a binding clip (each file about
a minute of JAX tracing and compiling on the CPU).

Runs on the ``mccl`` preset (phead, P = 2, soft weights, clda, CNR, intra),
the ascent on: the default (``rain.eps_clip=0``, the reference's unbounded
ascent, ``optim.lr_eps=1``), ``mulstyle``, ``mulstyle2``, and
``concat_forward`` and ``mulstyle2`` with ``eps_clip=3`` at ``lr_eps=300``
so that the clip binds (the unclipped step is 14-23 long there, 0.05-0.08
at ``lr_eps=1``). Compared after each iteration: every metric name and
value (the stylised branch's diagnostics and the ascent's
``eps_step_norm`` / ``sampling_norm`` / ``seg_style_val`` among them), the
sampling, the segmentor parameters, the BatchNorm statistics and the source
centres.

``style_alpha=0.5`` runs with the ascent off (``sched["eps_on"] = 0``) and
is held on its metrics alone: the blend, the stylised branch's losses and
diagnostics, and the second iteration's forward after the update. There the
JAX package's gradients are not those of its own loss: for the parameters
(the seg losses alone, ``warm = 0``, ``consist_w = 0``) one entry of
``decoder1_2``'s kernel takes 0.02073 from JAX's autograd, 0.02218 from the
port's, and 0.02193 +- 0.0003 from central differences of JAX's own
``seg_s + seg_style`` in float64 (step 1e-3); the port's autograd matches
its own central differences there too (0.1747 against 0.1702-0.1728 on
``encoder1``). At ``style_alpha = 1`` the two agree to float32 rounding.

The reference is the JAX step in float64 (``jax.enable_x64``; its losses,
AdaIN statistics and centroids stay in float32, and the port's modules run
in double with the same float32 islands), the precedent of
``tests/test_torch_step_backbones.py``: the ascent's gradient runs back
through the segmentor and the style net's decoder, where the CPU's float32
convolutions (oneDNN) are 1e-3 off in relative terms, and the second
iteration stylises with the ascended sampling. As there, the float32 JAX
step's own largest distance from the float64 one in each tensor and metric
is added to its tolerance. Tolerances otherwise as
``tests/test_torch_step_mccl.py``: metrics rtol 1e-4 / atol 1e-5,
parameters rtol 1e-4 / atol 1e-6, running statistics, centres and the
sampling rtol 1e-4 / atol 1e-5.
"""
import pytest
import torch

from torch_rain_common import check_metrics, check_state, mccl_rain_iterations

torch.set_num_threads(1)

RUNS = ("default", "style_alpha")


@pytest.fixture(scope="module")
def runs():
    return {run: mccl_rain_iterations(run) for run in RUNS}


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", RUNS)
def test_metrics_match(runs, run, i):
    check_metrics(runs[run], run, i)


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", ["default"])
def test_sampling_parameters_running_stats_and_centres_match(runs, run, i):
    check_state(runs[run], run, i)
