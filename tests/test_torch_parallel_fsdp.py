"""FSDP (``slcl_torch/parallel/mesh.py::fsdp_shard``) and checkpoints across
process counts, on the CPU over gloo, after ``tests/test_parallel.py``:

- FSDP on a 2 x 2 mesh (two data ranks, two model ranks, modules of 1024
  parameters or more sharded) against the same two steps replicated on the
  same mesh: metrics rel 1e-5, parameters rtol 1e-4 / atol 1e-6 (the
  discriminator, Adam's, atol 1e-5);
- a checkpoint saved at W = 2 under FSDP restores at W = 1, and one saved
  there restores at W = 2, each phase continuing as the uninterrupted
  one-process run (float64);
- the gloo dry run (``python -m slcl_torch.parallel.dryrun``) returns 1
  when a config's ranks fail.

The ranks are spawned processes that import ``tests/torch_parallel_common.py``
(torch and slcl_torch only), one thread each.
"""
import torch
import torch_parallel_common as C

from slcl_torch.parallel.dryrun import spawn

torch.set_num_threads(1)
MOD = "torch_parallel_common"


def test_fsdp_two_by_two_matches_replicated(tmp_path):
    """FSDP over two model ranks and two data ranks equals the replicated
    steps on the same mesh (JAX: test_fsdp_sharding_matches_replicated)."""
    cfg = C.small_cfg("mpscl")
    cfg.mesh.model_axis = 2
    cfg.mesh.fsdp_min_size = 1024
    args = (cfg, C.batches("mpscl", 2), [C.sched("mpscl")] * 2, str(tmp_path))
    ranks = spawn(4, "fsdp_pair_entry", args, model_axis=2, module=MOD)
    for r, got in enumerate(ranks):
        assert got["fsdp"]["steps"][0]["sharded"] > 0, "no parameter sharded"
        assert got["replicated"]["steps"][0]["sharded"] == 0
        for i in range(2):
            a, b = got["fsdp"]["steps"][i], got["replicated"]["steps"][i]
            C.assert_metrics_close(a["metrics"], b["metrics"], 1e-5, f"rank {r} step {i}")
            C.assert_state_close(a["state"], b["state"], 1e-4, 1e-6, f"rank {r} step {i}",
                                 disc_atol=1e-5)


def test_checkpoint_round_trip_across_process_counts(tmp_path):
    """W = 2 with FSDP (two model ranks) steps and saves; one process
    restores, steps and saves; W = 2 (two data ranks) restores and steps:
    each phase equals the uninterrupted one-process run, in float64."""
    b = C.batches("mpscl", 3)
    sc = [C.sched("mpscl")]
    fsdp = C.small_cfg("mpscl")
    fsdp.mesh.model_axis, fsdp.mesh.fsdp, fsdp.mesh.fsdp_min_size = 2, True, 1024
    plain = C.small_cfg("mpscl")
    f64 = torch.float64
    first = spawn(2, "steps_entry", (fsdp, b[:1], sc, str(tmp_path / "a"), f64, "", "",
                                     "w2"), model_axis=2, module=MOD)
    assert first[0]["steps"][0]["sharded"] > 0
    second = C.steps_entry(None, plain, b[1:2], sc, str(tmp_path / "b"), f64, "",
                           first[0]["ckpt"], "w1")
    third = spawn(2, "steps_entry", (plain, b[2:], sc, str(tmp_path / "c"), f64, "",
                                     second["ckpt"]), module=MOD)
    whole = C.steps_entry(None, plain, b, sc * 3, str(tmp_path / "d"), f64)["steps"]
    for i, got in enumerate((first[0]["steps"][0], second["steps"][0],
                             third[0]["steps"][0], third[1]["steps"][0])):
        want = whole[min(i, 2)]
        C.assert_metrics_close(got["metrics"], want["metrics"], 1e-5, f"phase {i}")
        C.assert_state_close(got["state"], want["state"], 1e-4, 1e-6, f"phase {i}")


def test_dry_run_fails_when_a_rank_fails(capsys):
    """``python -m slcl_torch.parallel.dryrun``: a config whose ranks raise
    (an unknown method) is reported and the run returns 1."""
    import json

    from slcl_torch.parallel import dryrun
    assert dryrun.main(["2", "no_such_method"]) == 1
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines[0]["config"] == "no_such_method" and not lines[0]["ok"]
    assert "ranks failed" in lines[0]["errors"][0]
    assert lines[-1] == {"ok": False}
