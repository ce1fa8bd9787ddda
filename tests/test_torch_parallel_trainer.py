"""The Trainer under data parallelism (``slcl_torch/train/trainer.py``), on
the CPU over gloo: one synthetic epoch of ``train()`` (validation,
checkpoints, final test) at W = 2 equals one process's (the epoch's
metrics rel 1e-5, the state rtol 1e-4 / atol 1e-6, float64) and rank 0
alone writes, each rank in a directory of its own (the final restore of the
best checkpoint reaches rank 1 from rank 0); the refusals where JAX would
fall back to one device (``data.bs`` or the processes not divisible) and
DeepLabV2's under a contrastive method under ``mesh.spatial``, while a
DRUNet method steps on two model ranks' row bands; RAIN's ``mulstyle``
(a sampling row per image of the global batch) taking a step;
``pretrain_rain``, which stays unsharded: every rank's
step on the whole batch equals one process's; and ``mesh.from_writer``,
through which rank 0 alone reads a checkpoint for every rank.
"""
import json

import numpy as np
import pytest
import torch
import torch_parallel_common as C

from slcl_torch.parallel.dryrun import spawn

torch.set_num_threads(1)
MOD = "torch_parallel_common"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cfg = C.small_cfg("mpscl")
    cfg.model.multilvl = True
    two = tmp_path_factory.mktemp("two")
    ranks = spawn(2, "train_entry", (cfg, str(two)), module=MOD)
    one = C.train_entry(None, cfg, str(tmp_path_factory.mktemp("one")))
    return ranks, one


@pytest.mark.parametrize("rank", [0, 1])
def test_epoch_at_two_ranks_equals_one_process(trained, rank):
    ranks, one = trained
    got, want = ranks[rank], one
    g, w = got["history"][-1], want["history"][-1]
    C.assert_metrics_close({k: v for k, v in g.items() if k != "epoch_time_s"},
                           {k: v for k, v in w.items() if k != "epoch_time_s"},
                           1e-5, f"rank {rank}")
    C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"rank {rank}")


def test_only_rank_zero_writes(trained):
    """Each rank ran in a directory of its own: rank 1's stays empty, so its
    final restore of ``ckpt_best`` came from rank 0."""
    from pathlib import Path
    ranks, _ = trained
    assert [r["writer"] for r in ranks] == [True, False]
    out = Path(ranks[0]["out_dir"])
    assert out != Path(ranks[1]["out_dir"]) and not Path(ranks[1]["out_dir"]).exists()
    lines = (out / "log.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [0]
    assert (out / "summary.json").is_file()
    names = sorted(p.name for p in out.iterdir())
    assert not [n for n in names if n.endswith(".tmp")], names
    # the checkpoint is whole, in the one-process format
    ckpt = torch.load(out / "ckpt_last.pt", weights_only=True)
    state = ranks[0]["state"]
    for k, v in ckpt["seg"].items():
        np.testing.assert_array_equal(v.numpy(), state[f"seg/{k}"])


def test_refusals_and_unsharded_pretrain_rain(tmp_path):
    ranks = spawn(2, "raises_entry", (str(tmp_path / "w"),), module=MOD)
    want = C.pretrain_entry(None, str(tmp_path / "one"))
    # mesh.spatial on two model ranks: DRUNet's mpscl steps on row bands;
    # DeepLabV2 under a contrastive method keeps its refusal
    for got in spawn(2, "spatial_checks_entry", (str(tmp_path / "sp"),), model_axis=2,
                     module=MOD, spatial=True):
        assert got["local_rows"] == C.H // 2
        assert all(np.isfinite(v) for v in got["step"].values()) and got["step"]
        kind, msg = got["deeplabv2_slcl"]
        assert kind == "ValueError" and "model.filters=2048" in msg
    for got in ranks:
        kind, msg = got["bs"]
        assert kind == "ValueError" and "data.bs=3" in msg and "2 data ranks" in msg
        kind, msg = got["model_axis"]
        assert kind == "ValueError" and "2 processes" in msg and "model_axis=3" in msg
        # rain.mulstyle trains at two data ranks, its sampling a row per
        # image of the global batch, the ascent taken
        mul = got["mulstyle"]
        assert mul["sampling_rows"] == C.B
        assert all(np.isfinite(v) for v in mul["metrics"].values())
        assert mul["metrics"]["eps_step_norm"] > 0.0
        assert got["pretrain_mesh"] is None
        C.assert_metrics_close(got["pretrain_metrics"], want["pretrain_metrics"], 1e-6,
                               "pretrain_rain")
        C.assert_state_close(got["pretrain_state"], want["pretrain_state"], 1e-6, 1e-8,
                             "pretrain_rain")


def test_from_writer_sends_rank_zero_result_and_error(tmp_path):
    """What rank 0 alone reads (a checkpoint it wrote) reaches every rank,
    and so does its failure: the other ranks never run the read."""
    for got in spawn(2, "from_writer_entry", (str(tmp_path),), module=MOD):
        assert got["value"]["rank"] == 0 and got["value"]["t"].tolist() == [0, 1, 2]
        assert got["error"] == "FileNotFoundError"
