"""PyTorch port, data parallelism (``parallel/``, ``trainer.ShardedOptimizer``,
rank-split serving) on the CPU: gloo process groups of 2 and 4 spawned
ranks (``tests/torch_dist_workers.py``), the micro UNet with block
checkpointing.

* ``init_distributed`` without the environment, ``local_batch_slice`` and
  ``shard_batch`` against the JAX package's rows on its CPU mesh.
* One commit (k = 2) over 2 and 4 ranks on a global batch of 4 in float64
  against the single-process ``Trainer``: losses rel 1e-12, and per
  artifact the parameters and their update rel L2 1e-9, with and without
  clipping; each rank holds ceil(N / world) elements of each moment and of
  the gradient (N: the flat span, each parameter 256-byte aligned); the
  parameters are views of the flat buffer, aligned, and equal on every
  rank.
* ``train.main`` resumes rank 0's checkpoint on 2 ranks; a ``--tp`` that
  divides neither the world nor the widths, and a ``--dp`` other than the
  world size over tp, exit.
* Rank-split serving: 3 identities over 2 ranks with the SSM gather, each
  equal to the single-process ``generate_latents_batch``, and through the
  low-level ``serving.sample_video_batch(group=)`` (float64; atol
  1e-6 of the latents' range, the tolerance of the batched-against-alone
  test in ``test_torch_serving_data_train.py``: the port keeps norm statistics and the scan state in fp32
  even in a float64 UNet, and a block of 2 or 1 identities sums in another
  order than 3).
* The single-process commit against the JAX ``make_train_step``: in
  ``test_torch_parallel_jax.py`` (its compile alone takes a minute).
"""
import os

import jax
import numpy as np
import pytest
import torch

from actalker_tpu.parallel import distributed as JD
from actalker_tpu.parallel import mesh as JM
from actalker_tpu.training.train import synthetic_batches as j_batches
from actalker_tpu_torch.io import checkpoint as ckpt
from actalker_tpu_torch.parallel import distributed as P
from actalker_tpu_torch.parallel import mesh as M
from actalker_tpu_torch.training import train as TR
from actalker_tpu_torch.training import trainer as T
from tests import torch_dist_workers as DW
from tests.torch_threads import few_torch_threads  # noqa: F401 (autouse)
from tests.torch_tmp import drop_module_tmp  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs", "train.yaml")


def _ranks(tmp_path, fn, world, *args):
    out = str(tmp_path)
    DW.run_ranks(fn, world, out, *args)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def test_init_distributed_needs_the_environment(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert P.init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert (P.world_size(), P.get_rank()) == (1, 0)
    assert P.local_batch_slice(6) == JD.local_batch_slice(6) == slice(0, 6)
    assert [P.rank_block(3, 2, r) for r in (0, 1)] == [slice(0, 2), slice(2, 3)]
    assert P.rank_block(1, 2, 1) == slice(1, 1)
    with pytest.raises(ValueError, match="divide"):
        P.local_batch_slice(5, 2, 0)


@pytest.mark.parametrize("world", [2, 4])
def test_shard_batch_rows_equal_the_jax_mesh(world):
    """The port's rank r rows of a global batch are the JAX dp shard r
    (per-sample masks batched, as in the JAX package)."""
    jb = next(j_batches(4, 2, 8, 32, seed=1, raw_heads=True))
    jb = jb._replace(audio_mask=np.ones((4, 1, 64, 64), np.float32),
                     exp_mask=np.ones((4, 1, 64, 64), np.float32) * 0.5)
    pb = T.TrainBatch(**{k: torch.from_numpy(np.array(getattr(jb, k)))
                         for k in T.TrainBatch._fields
                         if getattr(jb, k) is not None})
    mesh = JM.make_mesh(devices=jax.devices()[:world], dp=world, tp=1)
    sharded = JM.shard_batch(jb, mesh)
    for r in range(world):
        mine = M.shard_batch(pb, world, r)
        for k in T.TrainBatch._fields:
            if getattr(sharded, k) is None:        # the pre-encoded fields
                assert getattr(mine, k) is None, k
                continue
            shards = {s.device: s.data for s in getattr(sharded, k).addressable_shards}
            want = np.asarray(shards[mesh.devices[r, 0]])
            np.testing.assert_array_equal(getattr(mine, k).numpy(), want, err_msg=k)


def test_zero_layout_buckets_and_bytes():
    lay = M.ZeroLayout([5, 7, 3, 11], world=4, bucket_elems=8)
    assert lay.numel == 26 and lay.shard_numel == 7 and lay.padded == 28
    assert [(b.start, b.stop, b.chunk, b.shard_start, b.real) for b in lay.buckets] == [
        (0, 8, 2, 0, 8), (8, 16, 2, 2, 8), (16, 24, 2, 4, 8), (24, 28, 1, 6, 2)]
    assert list(lay.buckets_of(5, 7)) == [0, 1] and list(lay.buckets_of(15, 11)) == [1, 2, 3]
    # each parameter starting at a multiple of 4: gaps count in the span only
    lay = M.ZeroLayout([5, 7, 3, 11], world=4, bucket_elems=8, align=4)
    assert lay.offsets == [0, 8, 16, 20] and lay.numel == 31 and lay.shard_numel == 8
    assert [(b.start, b.stop, b.real) for b in lay.buckets] == [
        (0, 8, 5), (8, 16, 7), (16, 24, 7), (24, 32, 7)]
    n = 1_775_460_842                       # the UNet of configs/train.yaml
    assert M.per_rank_bytes(n, 1)["total"] == 16 * n
    s = -(-n // 4)                          # the masters padded to 4 s
    assert M.per_rank_bytes(n, 4) == {"masters": 16 * s, "moments": 8 * s,
                                      "grads": 4 * s, "total": 28 * s}


@pytest.mark.parametrize("world,max_norm", [(2, 1e6), (4, 1e-4)],
                         ids=["2 ranks", "4 ranks clipped"])
def test_sharded_commit_equals_single_process(tmp_path, world, max_norm):
    res = _ranks(tmp_path, DW.commit_rank, world, max_norm)
    r0 = res[0]
    single = r0["single_records"]
    for got in (r["records"] for r in res):
        assert [x["commit"] for x in got] == [False, True]
        for a, b in zip(got, single):
            assert abs(a["loss"] - b["loss"]) <= 1e-12 * abs(b["loss"])
        assert abs(got[1]["grad_norm"] - single[1]["grad_norm"]) \
            <= 1e-8 * single[1]["grad_norm"]
    # clipping engaged exactly when the all-reduced norm exceeds the limit
    assert (single[1]["grad_norm"] >= max_norm) == (max_norm < 1.0)
    for name in TR.TRAINABLE:
        assert r0["params_rel"][name] <= 1e-9, name
        assert r0["update_rel"][name] <= 1e-9, (name, r0["update_rel"][name])
    shard = -(-r0["numel"] // world)
    for r in res:
        assert r["same_as_rank0"] and r["views"] and r["aligned"]
        assert r["moments"] == [shard, shard] and r["grad"] == shard
        want = M.per_rank_bytes(r0["numel"], world, 8)
        assert r["bytes"] == {k: want[k] for k in ("masters", "grads", "moments")}


def test_train_main_resumes_rank0_checkpoint_on_two_ranks(tmp_path):
    out = str(tmp_path / "run")
    first = TR.main(["--config", CFG, "--micro-model", "--synthetic", "2",
                     "--steps", "2", "--device", "cpu", "--output", out])
    assert first["final_step"] == 2 and ckpt.list_checkpoints(out) == [2]
    argv = ["--config", CFG, "--micro-model", "--synthetic", "2", "--steps", "4",
            "--device", "cpu", "--output", out, "--dp", "2"]
    res = _ranks(tmp_path, DW.train_main_rank, 2, argv)
    for r in res:
        assert r["resumed_equal"] and r["same_as_rank0"]
        assert (r["start_step"], r["final_step"]) == (2, 4)
        assert [x["step"] for x in r["records"]] == [2, 3]
        assert all(np.isfinite(x["loss"]) for x in r["records"])
    # every rank logs the global mean; rank 0 alone wrote
    assert [x["loss"] for x in res[0]["records"]] == [x["loss"] for x in res[1]["records"]]
    assert ckpt.list_checkpoints(out) == [2, 4]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert len(f.readlines()) == 4


def test_train_main_refuses_tp_and_a_wrong_dp(tmp_path):
    """A --tp that does not divide the world or the widths, and a --dp other
    than the world size over tp, exit."""
    base = ["--config", CFG, "--micro-model", "--synthetic", "1", "--device",
            "cpu", "--output", str(tmp_path)]
    with pytest.raises(SystemExit, match="--tp 2 != the 1 ranks"):
        TR.main(base + ["--tp", "2"])
    with pytest.raises(SystemExit, match="does not divide the UNet width 32"):
        TR.main(base + ["--tp", "3"])
    with pytest.raises(SystemExit, match="--dp 2"):
        TR.main(base + ["--dp", "2"])


def test_rank_split_serving_equals_single_process(tmp_path):
    pipe, cfg = DW.serve_pipeline(), DW.serve_config()
    n = len(DW.SERVE_BOXES)
    prepared = [DW.prepare_identity(pipe, cfg, i) for i in range(n)]
    budget = pipe._capacity_fracs(
        cfg, torch.stack([p[1].audio_mask for p in prepared])[:, 0], None, (8, 8))
    assert budget is not None           # the gather path
    want = pipe.generate_latents_batch(prepared, cfg)
    res = _ranks(tmp_path, DW.serve_rank, 2, n)
    assert [r["rows"] for r in res] == [(0, 2), (2, 3)]
    assert res[1]["latents"] is None
    # rank 1's face box alone is the largest: the MAX over ranks is the budget
    assert all(r["budgets"] == [budget, None] for r in res)
    got = res[0]["latents"]
    assert got.shape == want.shape == (n, 3, 8, 8, 4) and torch.isfinite(got).all()
    for i in range(n):
        np.testing.assert_allclose(got[i].numpy(), want[i].numpy(), rtol=0,
                                   atol=1e-6 * float(want[i].abs().max()))
    assert (want[0] - want[2]).abs().max() > 1e-2
    # serving.sample_video_batch(group=): each rank its block of all inputs
    low = DW.sample_all(pipe, cfg, n)
    assert res[1]["low"] is None and res[0]["low"].shape == low.shape
    for i in range(n):
        np.testing.assert_allclose(res[0]["low"][i].numpy(), low[i].numpy(), rtol=0,
                                   atol=1e-6 * float(low[i].abs().max()))


def test_uneven_blocks_gather_in_rank_order(tmp_path):
    """One identity over 2 ranks: rank 1's block is empty and the call
    still completes, with the single identity on rank 0."""
    res = _ranks(tmp_path, DW.serve_rank, 2, 1)
    assert [r["rows"] for r in res] == [(0, 1), (1, 1)]
    assert res[0]["latents"].shape == (1, 3, 8, 8, 4)
    assert res[0]["low"].shape[0] == 1 and res[1]["low"] is None
