"""MCCL + RAIN on the port against the JAX package's ``make_mccl_step``:
``contrastive.concat_forward`` (one forward over the stylised, source and
both target batches) and ``mulstyle2`` with a binding ``eps_clip``,
two epsilon iterations each. Set-up, comparisons and tolerances as
``tests/test_torch_step_mccl_rain.py``.
"""
import pytest
import torch

from torch_rain_common import check_metrics, check_state, mccl_rain_iterations

torch.set_num_threads(1)

RUNS = ("concat_forward", "mulstyle2_clip")


@pytest.fixture(scope="module")
def runs():
    return {run: mccl_rain_iterations(run) for run in RUNS}


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", RUNS)
def test_metrics_match(runs, run, i):
    check_metrics(runs[run], run, i)


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("run", RUNS)
def test_sampling_parameters_running_stats_and_centres_match(runs, run, i):
    check_state(runs[run], run, i)
