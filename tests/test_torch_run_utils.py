"""The run utilities of the port against ``slcl_tpu.utils``: the results
tables (strings equal), TensorBoard scalars (read back from the event
files, equal to what JAX's ``TBWriter`` writes for the same record), and,
through ``Trainer.train()`` on the CPU, the per-epoch TB scalars and the
``run.profile_dir`` trace with its epoch clamp.
"""
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from slcl_torch.config import Config
from slcl_torch.utils import tables, tb, timer
from slcl_tpu.utils import tables as j_tables
from slcl_tpu.utils import tb as j_tb

torch.set_num_threads(1)


def _results(seed: int):
    rng = np.random.default_rng(seed)
    return {k: [float(v) for v in rng.random(6) * s] for k, s in
            (("dc", 1.0), ("hd", 40.0), ("asd", 9.0))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tables_equal_jax(seed):
    r = _results(seed)
    assert tables.results_to_markdown(r) == j_tables.results_to_markdown(r)
    assert tables.results_to_latex(r) == j_tables.results_to_latex(r)
    names = ("A", "B", "C")
    assert (tables.results_to_markdown(r, names) == j_tables.results_to_markdown(r, names))


def _scalars(log_dir: Path):
    """(tag, step, value) of every scalar in the event files under
    ``log_dir``, read from the TFRecord framing."""
    from tensorboardX.proto import event_pb2
    out = []
    for f in sorted(log_dir.glob("events.out.tfevents.*")):
        data = f.read_bytes()
        pos = 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            ev = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 12 + n + 4
            for v in ev.summary.value:
                out.append((v.tag, ev.step, v.simple_value))
    return out


def test_tb_scalars_equal_jax(tmp_path):
    record = {"epoch": 3, "seg_s": 0.731, "loss_adv": 1.25e-3, "val_dice": 0.5,
              "early_stop": True, "name": "x", "n": 7}
    for mod, d in ((tb, tmp_path / "t"), (j_tb, tmp_path / "j")):
        w = mod.TBWriter(str(d))
        w.scalars(record, 4, prefix="train/")
        w.close()
    got, want = _scalars(tmp_path / "t"), _scalars(tmp_path / "j")
    assert got and got == want
    assert {t for t, _, _ in got} == {"train/epoch", "train/seg_s", "train/loss_adv",
                                      "train/val_dice", "train/early_stop", "train/n"}


def test_tb_writer_without_tensorboardx_writes_nothing(tmp_path, monkeypatch, capsys):
    """The card's host has no tensorboardX: JAX's message, no file."""
    import builtins
    real = builtins.__import__

    def no_tbx(name, *a, **k):
        if name.startswith("tensorboardX"):
            raise ImportError("No module named 'tensorboardX'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tbx)
    w = tb.TBWriter(str(tmp_path / "tb"))
    w.scalars({"a": 1.0}, 1)
    w.close()
    assert "tensorboardX unavailable" in capsys.readouterr().out
    assert not (tmp_path / "tb").exists()


def test_profile_trace_is_a_no_op_without_a_directory(tmp_path):
    with timer.profile_trace(None):
        pass
    with timer.profile_trace(""):
        pass
    assert not list(tmp_path.iterdir())


def test_train_writes_tb_scalars_and_the_clamped_profile(tmp_path, capsys):
    """One epoch with ``run.profile_epoch`` 1 (the default): clamped to 0
    with JAX's message, the epoch's trace written and parseable, and the
    epoch's record in the TB event file."""
    from slcl_torch.train.trainer import Trainer
    prof = tmp_path / "prof"
    cfg = Config.from_cli(["method=baseline", "data.dataset=synthetic", "data.crop=32",
                           "data.bs=2",
                           "data.eval_bs=2", "model.filters=8", "model.n_block=2",
                           "model.bottleneck_depth=2", "optim.epochs=1",
                           f"run.out_dir={tmp_path / 'runs'}", f"run.profile_dir={prof}"])
    trainer = Trainer(cfg, device="cpu")
    trainer.train()
    out = capsys.readouterr().out
    assert "run.profile_epoch clamped to 0 (run has only 1 epoch(s))" in out
    traces = list(prof.glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::convolution") for e in events)
    scalars = _scalars(trainer.out_dir / "tb")
    tags = {t for t, _, _ in scalars}
    assert {"epoch", "seg_s", "val_dice", "epoch_time_s"} <= tags
    assert {s for _, s, _ in scalars} == {1}
    rec = trainer.history[-1]
    assert dict((t, v) for t, _, v in scalars)["seg_s"] == pytest.approx(rec["seg_s"], rel=1e-6)
