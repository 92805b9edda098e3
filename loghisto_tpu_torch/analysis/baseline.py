"""Reviewed baseline suppressions for the port's static analyzer.

Each entry pins ONE intentional finding, capability-table style:

    (pass, repo-relative path, scope, detail, reason)

The first four fields are the finding's line-number-independent key
(``Finding.key()``); the fifth is the justification a reviewer signed
off on: for a locks finding, which thread could wait on that lock, and
why that is acceptable; for a programs finding (a registry step's
scope), what the step costs on the card.  A stale entry — one that no
longer matches any finding — is itself reported as a failure, so the
table can only shrink when the code actually improves.  ROADMAP.md
decisions D14 (locks) and D15 (programs) record the review.
"""

BASELINE: tuple[tuple[str, str, str, str, str], ...] = (
    (
        "locks", "loghisto_tpu_torch/anomaly/manager.py",
        "AnomalyManager.score_now",
        "blocking-under-lock:mesh_reduce",
        "on a mesh the readiness MIN and the sharded K7 pass, whose score "
        "gather over the metric axis runs inside `_div`, read the banks, "
        "the view and the registry generation as one state under "
        "`_dev_lock`; only the dense mesh's transfer worker (its K1/K3 "
        "folds) and a writer growing the registry wait, once a scored "
        "interval, for one MIN and one [M] x 3 gather (drift is "
        "dense-only, D5)",
    ),
    (
        "locks", "loghisto_tpu_torch/lifecycle/manager.py",
        "LifecycleManager.evict_ids",
        "blocking-under-lock:fold_rows_into",
        "eviction is deliberately stop-the-world, as the reference's "
        "compaction: the pool, the ring blocks and the activity block "
        "fold as one under `_dev_lock` and the wheel's `_lock` before "
        "the registry releases the rows; on a paged mesh the transfer "
        "worker only appends to the MeshStage (D12) and the committer "
        "applies on this thread (D9), so only a writer growing the "
        "registry waits, for one eviction's gathers",
    ),
    (
        "locks", "loghisto_tpu_torch/parallel/aggregator.py",
        "TorchAggregator._mesh_regrow",
        "blocking-under-lock:mesh_reduce",
        "growth re-lays every block under `_dev_lock`: a K1/K3 fold of "
        "the dense mesh's transfer worker during the gathers would land "
        "in the old block and be lost from the new one, so the worker "
        "waits for the spill MAX and the block gathers; growth doubles "
        "the rows, so it runs a handful of times in a process's life",
    ),
    (
        "locks", "loghisto_tpu_torch/parallel/aggregator.py",
        "TorchAggregator._mesh_regrow",
        "blocking-under-lock:cpu",
        "the regrown host spill comes back from the gather inside the "
        "same re-layout, which must be one step against the transfer "
        "worker's folds (see the mesh_reduce entry above)",
    ),
    (
        "locks", "loghisto_tpu_torch/utils/checkpoint.py", "save",
        "blocking-under-lock:decode_dense",
        "a one-card paged save decodes the pool under `_dev_lock`: the "
        "pool, the page table, the codecs and the host spill must be "
        "one state, and the transfer worker's translate + K4 and "
        "prepare_batch + K4f change them under this lock, so ingest "
        "waits for the decode; a save is an operator's or the "
        "resilience loop's rare call, and its price is that stall",
    ),
    (
        "locks", "loghisto_tpu_torch/utils/checkpoint.py",
        "_put_paged_mesh",
        "blocking-under-lock:decode_dense",
        "on a paged mesh the transfer worker takes no `_dev_lock` (it "
        "appends to the MeshStage, D12) and the committer applies on "
        "this thread (D9); only a writer growing the registry waits, "
        "for the cells' length gather and one gather to rank (0, 0)",
    ),
    (
        "programs", "loghisto_tpu_torch/ops/lifecycle.py",
        "sharded_fold_evict", "host-sync:_local_scalar_dense",
        "the dense mesh fold returns `moved`, the victims' total summed "
        "over the mesh, as a host int for the lifecycle's counters: "
        "`int()` of the rank's share waits, once an eviction, for the "
        "stream to finish the victims' row sum and the work queued before "
        "it, one 8-byte read on the card; under gloo the share goes "
        "through the host for the SUM anyway",
    ),
    (
        "programs", "loghisto_tpu_torch/ops/lifecycle.py",
        "sharded_fold_evict", "collective-dtype:all_reduce",
        "`moved` is a lifetime total of whole rows, which can pass 2^31, "
        "so its SUM over the mesh (`mesh_reduce`, one all_reduce an axis "
        "an eviction) carries one int64: 8 bytes a rank an axis; int32 "
        "would wrap it, and no count the rings or the accumulator hold "
        "travels in int64",
    ),
)
