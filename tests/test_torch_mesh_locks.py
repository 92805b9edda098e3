"""The locks narrowed at the mesh's entry points (ROADMAP D14): the
aggregator's, the lifecycle's, the drift engine's and the wheel's
states, the lifecycle's policy pass and the wheel's recompute take their
copies under the lock and make their collectives after it.  On two gloo
ranks of each shape (``tests/test_torch_ranks.py``'s launcher), the
transfer worker folds a probe batch during every collective of those
entry points, and every count stays exact: the probes' row, each
state's snapshot of it, and the committed names'."""

import numpy as np
import pytest

import test_torch_ranks as R


@pytest.mark.parametrize("shape", R.LK_SHAPES,
                         ids=[f"{s}x{m}" for s, m in R.LK_SHAPES])
def test_the_worker_records_during_the_narrowed_entry_points(shape,
                                                            tmp_path):
    s, m = shape
    res = R.launch(tmp_path, s * m, f"mesh_locks:{s}x{m}")
    for r in res:
        applied = r["lk.applied"]
        # collectives per round: the state's reduce and gather, the
        # policy pass's gather, the activity gather, the two bank
        # gathers, one ring gather a tier, the recompute's three
        assert len(applied) == R.LK_ROUNDS * (6 + len(R.ML_DRIFT_TIERS)
                                              + 3), applied
        assert applied.all(), applied
        got, want = r["lk.probe"]
        assert got == want > 0
        for snap, expect in r["lk.snaps"]:
            assert snap == expect
        assert np.array_equal(r["lk.counts"][:, 0], r["lk.counts"][:, 1])
    assert np.array_equal(res[0]["lk.counts"], res[-1]["lk.counts"])
