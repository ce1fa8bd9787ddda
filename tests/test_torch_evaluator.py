"""Port parity: ``slcl_torch.eval.evaluator`` against
``slcl_tpu.eval.evaluator`` on the CPU in f32.

The weights come from one short port training run (three Adam baseline
epochs at a small size with no domain gap, so the predictions are not
constant), carried to flax with
``slcl_torch.utils.convert``. Both evaluators see the same synthetic
``valid_t`` batches. Tolerances: ``evaluate_arrays`` on shared predictions
is equal; the two forwards (XLA and PyTorch convolutions summed in other
orders) may flip an argmax near a tie, so at most 0.1% of pixels may
differ and each class's Dice mean may move by 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.config import apply_recipe as t_apply_recipe
from slcl_torch.data import Loader
from slcl_torch.eval.evaluator import evaluate_arrays as t_evaluate_arrays
from slcl_torch.train.trainer import Trainer as TTrainer
from slcl_torch.utils.convert import state_dict_to_flax
from slcl_tpu.config import Config, apply_recipe
from slcl_tpu.eval.evaluator import Evaluator, evaluate_arrays
from slcl_tpu.models import build_segmentor

torch.set_num_threads(1)

SMALL = dict(crop=32, bs=2, eval_bs=4, num_workers=1, gap=0.0)
SIZES = dict(filters=8, n_block=2, bottleneck_depth=2, multilvl=True, dtype="float32")


def _cfg(cls, recipe):
    cfg = cls()
    cfg.method = "baseline"
    cfg = recipe(cfg)
    cfg.data.dataset = "synthetic"
    for k, v in SMALL.items():
        setattr(cfg.data, k, v)
    for k, v in SIZES.items():
        setattr(cfg.model, k, v)
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cfg = _cfg(TConfig, t_apply_recipe)
    cfg.run.out_dir = str(tmp_path_factory.mktemp("runs"))
    cfg.optim.optimizer, cfg.optim.lr = "adam", 1e-2
    trainer = TTrainer(cfg, device="cpu")
    for epoch in range(3):
        trainer.train_epoch(epoch)
    jcfg = _cfg(Config, apply_recipe)
    model = build_segmentor(jcfg.model)
    flax = state_dict_to_flax(trainer.state.seg)
    variables = {"params": flax["params"], "batch_stats": flax["batch_stats"]}
    jev = Evaluator(model, eval_bs=4, klc=True, num_classes=4)

    def loader():
        return Loader(trainer.datasets["valid_t"], 4, shuffle=False, drop_last=False,
                      num_threads=1)
    return trainer, jev, variables, loader


def test_predictions_agree(setup):
    trainer, jev, variables, loader = setup
    got, gts = trainer.evaluator.predict(loader())
    want, jgts = jev.predict(variables, loader())
    np.testing.assert_array_equal(gts, jgts)
    assert got.shape == want.shape
    assert len(np.unique(got)) > 1
    assert float((got != want).mean()) <= 1e-3


def test_evaluate_arrays_equal_on_shared_predictions(setup):
    trainer, _, _, loader = setup
    preds, gts = trainer.evaluator.predict(loader())
    for klc in (True, False):
        assert (t_evaluate_arrays(preds, gts, klc=klc)
                == evaluate_arrays(preds, gts, klc=klc))


@pytest.mark.parametrize("fast", [False, True])
def test_evaluator_dice_matches_jax(setup, fast):
    trainer, jev, variables, loader = setup
    if fast:
        got = trainer.evaluator.evaluate_fast(loader())
        want = jev.evaluate_fast(variables, loader())
    else:
        got = trainer.evaluator.evaluate_single_dataset(loader(), ifhd=False, ifasd=False)
        want = jev.evaluate_single_dataset(variables, loader(), ifhd=False, ifasd=False)
    assert max(want["dc"][0::2]) > 0.05
    np.testing.assert_allclose(got["dc"][0::2], want["dc"][0::2], rtol=0, atol=1e-3)


def test_trainer_eval_reads_the_split(setup):
    """``Trainer.eval`` on valid_t equals the evaluator on the same loader."""
    trainer, _, _, loader = setup
    got = trainer.eval("valid_t", ifhd=False, ifasd=False)
    want = trainer.evaluator.evaluate_single_dataset(loader(), ifhd=False, ifasd=False)
    assert got == want
    assert jnp.isfinite(jnp.asarray(got["dc"])).all()
