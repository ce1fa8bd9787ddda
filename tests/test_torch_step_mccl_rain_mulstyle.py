"""MCCL + RAIN on the port against the JAX package's ``make_mccl_step``:
``mulstyle`` (each content image in its own image's style: a sampling row
each) and ``mulstyle2`` (the whole content batch in one image's style),
two epsilon iterations each. Set-up, comparisons and tolerances as
``tests/test_torch_step_mccl_rain.py``.
"""
import pytest
import torch

from torch_rain_common import check_metrics, check_state, mccl_rain_iterations

torch.set_num_threads(1)

RUNS = ("mulstyle", "mulstyle2")


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
