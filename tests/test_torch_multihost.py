"""``loghisto_tpu_torch.parallel.multihost`` (the counterpart of
``tests/test_multihost.py``), on two real processes under gloo: one
launch (``test_torch_ranks.launch``) runs every scenario below on both
ranks, whose process group comes up through ``initialize`` with a
``FileStore`` rendezvous.

One device per process (ROADMAP D8): ``local_sample_shard`` gives each
rank its stream row's slice (the whole batch when both ranks share one
row, on the (1, 2) mesh); ``make_global_arrays`` places the local shard
on the rank's device; ``global_put`` / ``host_gather`` move a host
array to this rank's part and back.  The two-process step (the
reference's ``test_two_process_distributed_step``, which fails on the
CPU for an upstream reason) runs here on both meshes of two processes:
the per-batch step's counts equal the JAX step's on the same global
stream, the interval step's twice that."""

import jax.numpy as jnp
import numpy as np
import pytest

from loghisto_tpu.parallel.aggregator import (
    make_distributed_step as jax_distributed_step,
    make_sharded_accumulator as jax_sharded_accumulator,
)
from loghisto_tpu.parallel.mesh import make_mesh as jax_make_mesh

import test_torch_ranks as R

PS = np.array([0.5, 1.0], dtype=np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {"mh.ids": rng.integers(0, R.MH_M, R.MH_BATCH).astype(np.int32),
            "mh.values": rng.lognormal(2, 1, R.MH_BATCH).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    return R.launch(tmp_path_factory.mktemp("multihost"), R.MH_WORLD,
                    "multihost", inputs)


def test_local_sample_shard_covers_batch(ranks):
    assert [tuple(r["shard"].tolist()) for r in ranks] == [(0, 400),
                                                          (400, 400)]
    for r in ranks:  # not divisible by the 2 stream rows
        assert "not divisible by the stream axis (2)" in str(
            r["refuse.shard"])


def test_global_mesh_spans_the_ranks(ranks):
    for r in ranks:
        assert r["mh1.shape"].tolist() == [2, 1]
        assert r["mh2.shape"].tolist() == [1, 2]
    # (2, 1): a stream row each; (1, 2): one row, replicated over metric
    assert [r["mh1.slice"].tolist() for r in ranks] == [[0, 2048],
                                                        [2048, 2048]]
    assert [r["mh2.slice"].tolist() for r in ranks] == [[0, 4096]] * 2


@pytest.mark.parametrize("metric", [1, 2])
def test_two_process_distributed_step(ranks, inputs, metric):
    ids, values = inputs["mh.ids"], inputs["mh.values"]
    mesh = jax_make_mesh(stream=R.MH_WORLD // metric, metric=metric)
    step = jax_distributed_step(mesh, R.MH_M, R.MH_BL, PS)
    acc, stats = step(
        jax_sharded_accumulator(mesh, R.MH_M, 2 * R.MH_BL + 1),
        jnp.asarray(ids), jnp.asarray(values))
    expected = np.bincount(ids, minlength=R.MH_M)
    np.testing.assert_array_equal(np.asarray(stats["counts"]), expected)
    for r in ranks:
        np.testing.assert_array_equal(r[f"mh{metric}.counts"], expected)
        np.testing.assert_array_equal(r[f"mh{metric}.acc"], np.asarray(acc))
        # interval-amortized: two collective-free folds, one all_reduce
        np.testing.assert_array_equal(r[f"mh{metric}.counts2"],
                                      2 * expected)


@pytest.mark.parametrize("metric", [1, 2])
def test_global_put_and_host_gather_round_trip(ranks, metric):
    table = np.arange(R.MH_M * 3, dtype=np.int64).reshape(R.MH_M, 3)
    for rank, r in enumerate(ranks):
        # the metric block at the rank's position (replicated over stream)
        rows = R.MH_M // metric
        lo = (rank % metric) * rows
        np.testing.assert_array_equal(r[f"mh{metric}.put"],
                                      table[lo:lo + rows])
        np.testing.assert_array_equal(r[f"mh{metric}.gather"], table)


def test_make_global_arrays_requires_equal_shards(ranks):
    for r in ranks:
        assert "equal per-process shards required" in str(
            r["refuse.global"])
