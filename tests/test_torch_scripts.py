"""The port's deployment entry points: ``python -m slcl_torch.scripts.export``
(with its ``smoke=1`` reload check) and ``python -m
slcl_torch.scripts.predict`` against the JAX package's ``scripts/predict.py``
on the same weights (a JAX trainer's, carried across by
``utils/convert.py``), on the synthetic set and on the MS-CMRSeg fixture
tree.

Tolerances: masks equal pixel for pixel and the printed tables equal as
strings (float32 forwards on both sides; argmax labels); the Dice, HD95
and ASSD values within 1e-4 of JAX's; the port's table equals
``Trainer.eval("test_t")`` on the same weights exactly.
"""
import importlib.util
import json
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from slcl_torch.config import Config as TConfig
from slcl_torch.data import png
from slcl_torch.scripts import export, predict
from slcl_torch.train.trainer import Trainer
from slcl_torch.utils.convert import load_flax_weights
from slcl_tpu.config import Config as JConfig
from slcl_tpu.eval.evaluator import evaluate_arrays as j_evaluate_arrays
from slcl_tpu.train.trainer import Trainer as JTrainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["method=baseline", "data.crop=32", "data.bs=2", "data.eval_bs=4",
        "model.filters=8", "model.n_block=2", "model.bottleneck_depth=2",
        "model.dtype=float32", "data.num_workers=1"]
DATA = {"synthetic": ["data.dataset=synthetic"],
        "mscmrseg": ["data.dataset=mscmrseg",
                     f"data.data_dir={ROOT / 'tests' / 'fixtures' / 'mini_mscmrseg'}"]}


def test_export_cli_smoke_on_cpu(tmp_path, capsys):
    """Fresh init and a restored checkpoint; the artifact serves the
    trainer's evaluator model."""
    out = export.main([*TINY, *DATA["synthetic"], f"out={tmp_path / 'a.slclt'}", "smoke=1",
                       "--device", "cpu"])
    assert "smoke ok" in capsys.readouterr().out and Path(out).is_file()
    t = Trainer(TConfig.from_cli([*TINY, *DATA["synthetic"], "model.multilvl=true",
                                  f"run.out_dir={tmp_path}"]), device="cpu")
    ckpt = t.save_checkpoint("x")
    out = export.main([*TINY, *DATA["synthetic"], "model.multilvl=true",
                       f"run.restore_from={ckpt}", f"out={tmp_path / 'b.slclt'}", "smoke=1",
                       "--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"restored '{ckpt}'" in printed and "smoke ok" in printed
    from slcl_torch import serve
    fn, meta = serve.load_artifact(out, "cpu")
    assert meta["method"] == "baseline" and meta["crop"] == 32 and meta["num_classes"] == 4
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32))
    with t.evaluator.eval_mode():
        want = torch.argmax(t.state.seg(x).pred.float(), dim=-1)
    assert torch.equal(fn(x).long(), want)


def _jax_predict():
    spec = importlib.util.spec_from_file_location("jax_predict", ROOT / "scripts" / "predict.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("data", ["synthetic", "mscmrseg"])
def test_predict_matches_jax_predict(tmp_path, capsys, data):
    over = [*TINY, *DATA[data]]
    jt = JTrainer(JConfig.from_cli([*over, f"run.out_dir={tmp_path / 'jax'}"]))
    jt.save_checkpoint("jx")
    t = Trainer(TConfig.from_cli([*over, f"run.out_dir={tmp_path / 'port'}"]), device="cpu")
    load_flax_weights(t.state.seg, jax.tree.map(np.asarray, jt.state.seg.params),
                      jax.tree.map(np.asarray, jt.state.seg.batch_stats))
    ckpt = t.save_checkpoint("px")
    capsys.readouterr()

    jpreds = _jax_predict().main([*over, f"run.out_dir={tmp_path / 'jax'}",
                                  "run.restore_from=jx", f"out_dir={tmp_path / 'j'}"])
    jout = capsys.readouterr().out
    preds, results = predict.main([*over, f"run.restore_from={ckpt}",
                                   f"out_dir={tmp_path / 't'}", "--device", "cpu"])
    tout = capsys.readouterr().out
    np.testing.assert_array_equal(preds, np.asarray(jpreds))
    names = sorted(p.name for p in (tmp_path / "j").glob("*_pred.png"))
    assert names and names == sorted(p.name for p in (tmp_path / "t").glob("*_pred.png"))
    for n in names:
        np.testing.assert_array_equal(png.read_png_gray(tmp_path / "t" / n),
                                      cv2.imread(str(tmp_path / "j" / n), cv2.IMREAD_GRAYSCALE))
    table = [ln for ln in tout.splitlines() if ln.startswith("|")]
    assert len(table) == 6 and table == [ln for ln in jout.splitlines() if ln.startswith("|")]
    assert json.loads(tout.strip().splitlines()[-1])["test"] == results
    gts = np.concatenate([b[1] for b in _batches(t)])
    want = j_evaluate_arrays(np.asarray(jpreds), gts, klc=True, num_classes=4)
    for k in ("dc", "hd", "asd"):
        np.testing.assert_allclose(results[k], want[k], rtol=0, atol=1e-4, err_msg=k)
    t.restore_checkpoint(ckpt, params_only=True)
    assert t.eval("test_t") == results


def _batches(t):
    from slcl_torch.data import Loader
    return Loader(t.datasets["test_t"], 4, shuffle=False, drop_last=False, num_threads=1)
