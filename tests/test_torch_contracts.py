"""The port's program registry (``loghisto_tpu_torch/analysis/
program_audit.py``): every JAX program of ``jaxpr_audit.py`` answered by
an entry, every entry's contract declared and holding on the CPU, each
one-device step equal to the JAX program of the same name on the same
seeded operands, the known-bad fixtures caught with their details, the
CLI, the kernel wrappers' entry counts, the mesh entries on a (2, 2)
gloo mesh of four ranks (``tests/test_torch_ranks.py``'s launcher, job
``programs``) against their one-device twins, and, on a card, the
chip phase's checks.

Tolerances: integers bit for bit everywhere.  Floats against JAX: the
EWMA banks rtol 1e-6 / atol 1e-7 and the drift scores ks atol 2e-6, jsd
atol 1e-5, emd rtol 1e-4 + atol B * 2^-23 (``tests/test_torch_anomaly.py``
states why); the float32 row sums (a matvec each library orders its
own way) rtol 1e-5 / atol 1e-6, as ``tests/test_torch_commit.py``.  The
mesh ranks against their twins: the same plain PyTorch on a block of
the same rows, floats within the same tolerances.

JAX is imported inside the tests that hold the port against it, so the
``cuda`` test runs on a card with ``--noconftest`` and no JAX."""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from loghisto_tpu_torch.analysis import baseline as baseline_mod
from loghisto_tpu_torch.analysis import program_audit as pa
from loghisto_tpu_torch.ops import backend

REPO = Path(__file__).resolve().parent.parent
ONE_DEVICE = [s.name for s in pa.PROGRAMS if not s.mesh]
MESH = [s.name for s in pa.PROGRAMS if s.mesh]
BANK_TOL = dict(rtol=1e-6, atol=1e-7)
SUMS_TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = {"ks": dict(rtol=0, atol=2e-6), "jsd": dict(rtol=0, atol=1e-5),
             "emd": dict(rtol=1e-4, atol=pa.B * 2.0**-23)}


def _cli(*args, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "loghisto_tpu_torch.analysis", *args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
    )


def _flat(obj, key=None):
    """(key, array) leaves of a step's outputs, dict keys sorted (the
    JAX tree order), tensors as NumPy."""
    if isinstance(obj, dict):
        for k in sorted(obj):
            yield from _flat(obj[k], k)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _flat(v, key)
    elif obj is not None:
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        yield key, np.asarray(obj)


def _assert_same(got, want, what, tol=None):
    got, want = list(_flat(got)), list(_flat(want))
    assert len(got) == len(want), (what, len(got), len(want))
    for i, ((key, g), (_, w)) in enumerate(zip(got, want)):
        if g.shape != w.shape and g.shape[:-1] == w.shape[:-1] \
                and w.shape[-1] > g.shape[-1]:
            w = w[..., :g.shape[-1]]      # a JAX lane pad, stripped
        assert g.shape == w.shape, (what, i, key, g.shape, w.shape)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g.astype(np.int64),
                                          w.astype(np.int64),
                                          err_msg=f"{what} [{i}] {key}")
        else:
            t = (tol or {}).get(key, SCORE_TOL.get(key, SUMS_TOL))
            np.testing.assert_allclose(g, w, err_msg=f"{what} [{i}] {key}",
                                       **t)


# -- the registry -------------------------------------------------------------

def test_every_jax_program_is_answered_by_an_entry():
    from loghisto_tpu.analysis import jaxpr_audit

    answered = {ref for spec in pa.PROGRAMS for ref in spec.reference}
    names = set(jaxpr_audit.program_names())
    assert len(names) == 27
    assert names <= answered, sorted(names - answered)
    assert answered <= names, sorted(answered - names)


def test_every_entry_declares_every_field():
    assert len(set(pa.program_names())) == len(pa.PROGRAMS)
    for spec in pa.PROGRAMS:
        c = spec.contract
        for field in dataclasses.fields(c):
            assert getattr(c, field.name) is not None, (spec.name, field)
        assert c.description and spec.reference and spec.factory, spec.name
        assert set(c.launches) <= set(backend.KERNELS), spec.name
        path, line = pa.factory_origin(spec.factory)
        assert (REPO / path).is_file() and line > 0, (spec.name, path)
        assert spec.mesh == spec.name.startswith("sharded_"), spec.name
        if spec.mesh:
            assert isinstance(c.collectives, dict), spec.name
        else:
            assert c.collectives == {}, spec.name


@pytest.mark.parametrize("name", ONE_DEVICE)
def test_assert_contract_holds(name):
    pa.assert_contract(name)


def test_the_int32_partial_bound_holds():
    assert pa.constant_findings() == []


def test_an_unknown_name_raises_key_error():
    with pytest.raises(KeyError, match="unknown audited program"):
        pa.get_spec("no_such_step")
    with pytest.raises(KeyError):
        pa.assert_contract("no_such_step")


# -- parity with the JAX programs ---------------------------------------------

def _jax_args(name, a):
    """The JAX program's operands from the port step's (host copies):
    the port's packed (id, codec bucket, count) triples become the
    reference's (ids, dense bucket, weights) columns, host tier ints
    int32 arrays, the page-major table its [M, pages_per_row] layout."""
    import jax.numpy as jnp

    def cells(packed):
        return (packed[:, 0], packed[:, 1] + pa.BL, packed[:, 2])

    def i32(v):
        return jnp.asarray(np.asarray(v, dtype=np.int32))

    a = list(a)
    if name in ("fused_commit", "fused_commit_snapshot"):
        acc, rings, slots, keeps, packed, *rest = a
        return (acc, tuple(rings), i32(slots), i32(keeps), *cells(packed),
                *rest)
    if name == "fused_commit_full":
        acc, rings, la, ih, slots, keeps, packed, epoch, ifirst = a
        return (acc, tuple(rings), la, ih, i32(slots), i32(keeps),
                *cells(packed), i32(epoch), i32(ifirst))
    if name == "fused_commit_snapshot_full":
        (acc, rings, la, ih, banks, slots, keeps, packed, epoch, masks,
         ifirst, bank, decay, min_count) = a
        return (acc, tuple(rings), la, ih, tuple(banks), i32(slots),
                i32(keeps), *cells(packed), i32(epoch), masks, i32(ifirst),
                i32(bank), jnp.asarray(np.float32(decay)), i32(min_count))
    if name in ("paged_fused_commit", "paged_fused_commit_snapshot"):
        pool, rings, slots, keeps, packed, triples, *rest = a
        return (pool, tuple(rings), i32(slots), i32(keeps), *cells(packed),
                triples, *rest)
    if name == "fused_paged_ingest":
        *head, table = a
        return (*head, np.ascontiguousarray(table.T))
    if name in ("fold_evict", "fold_evict_paged", "compact"):
        *head, epoch = a
        return (*[tuple(x) if isinstance(x, list) else x for x in head],
                i32(epoch))
    if name in ("divergence",):
        *head, bank, min_samples = a
        return (*head, i32(bank), i32(min_samples))
    return tuple(a)


def _like(got, want):
    """``got`` with only the dict keys ``want`` has (the port's queries
    also return the selected buckets)."""
    if isinstance(got, dict) and isinstance(want, dict):
        return {k: _like(got[k], want[k]) for k in want}
    if isinstance(got, (list, tuple)) and isinstance(want, (list, tuple)):
        return [_like(g, w) for g, w in zip(got, want)]
    return got


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.numpy().copy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


PARITY = [(s.name, ref) for s in pa.PROGRAMS if not s.mesh
          for ref in s.reference]


@pytest.mark.parametrize("name,ref", PARITY)
def test_one_device_step_equals_its_jax_program(name, ref):
    import jax

    from loghisto_tpu.analysis import jaxpr_audit

    step, args = pa.get_spec(name).build("cpu")
    jargs = _jax_args(name, _host(args))
    got = step(*args)
    fn, _ = jaxpr_audit.get_spec(ref).build()
    want = jax.device_get(fn(*jax.tree_util.tree_map(
        lambda x: jax.numpy.asarray(x) if isinstance(x, np.ndarray) else x,
        jargs, is_leaf=lambda x: isinstance(x, np.ndarray))))
    if name == "fold_evict":   # JAX counts are int32, the port's int64
        got = got[:3] + (got[3].to(torch.int32),)
    # unkeyed floats are the EWMA banks
    _assert_same(_like(got, want), want, f"{name} vs JAX {ref}",
                 tol={None: BANK_TOL})


# -- known-bad fixtures -------------------------------------------------------

FIXTURES = textwrap.dedent('''\
    import torch

    from loghisto_tpu_torch.analysis.program_audit import (
        Contract, ProgramSpec, dense_whole, paged_whole)
    from loghisto_tpu_torch.ops.sparse_ingest import sparse_ingest

    D = dense_whole()


    def _acc(device):
        return torch.from_numpy(D["acc"].copy())


    def _packed(device):
        return torch.from_numpy(D["packed"].copy())


    def twice(device):
        def step(acc, packed):
            sparse_ingest(acc, packed, 64)
            return sparse_ingest(acc, packed, 64)
        return step, (_acc(device), _packed(device))


    def new_carry(device):
        def step(acc, packed):
            return sparse_ingest(acc.clone(), packed, 64)
        return step, (_acc(device), _packed(device))


    def dense_on_paged(device):
        def step(pool):
            rows = torch.zeros((40, 129), dtype=torch.int32)
            return pool.add_(rows.sum())
        return step, (torch.from_numpy(paged_whole()["pool"]),)


    def reads_back(device):
        def step(acc):
            return acc.add_(int(acc.sum()) % 3)
        return step, (_acc(device),)


    def float_scatter(device):
        def step(acc):
            out = torch.zeros((32, 129), dtype=torch.float32)
            return out.index_add_(0, torch.arange(32), acc.float())
        return step, (_acc(device),)


    PROGRAMS = (
        ProgramSpec("twice", "fixture", twice,
                    Contract(launches={"sparse_ingest": 1}, in_place=1)),
        ProgramSpec("new_carry", "fixture", new_carry,
                    Contract(launches={"sparse_ingest": 1}, in_place=1)),
        ProgramSpec("dense_on_paged", "fixture", dense_on_paged,
                    Contract(forbidden_shapes=((40, 129), (20, 129)))),
        ProgramSpec("reads_back", "fixture", reads_back,
                    Contract(in_place=1)),
        ProgramSpec("float_scatter", "fixture", float_scatter,
                    Contract(int32_scatter_shapes=((32, 129),))),
    )
''')

CAUGHT = {
    "twice": "launch-count:sparse_ingest",
    "new_carry": "in-place-dropped",
    "dense_on_paged": "forbidden-shape",
    "reads_back": "host-sync:_local_scalar_dense",
    "float_scatter": "scatter-dtype",
}


def _fixtures(tmp_path):
    import importlib.util

    path = tmp_path / "bad_programs.py"
    path.write_text(FIXTURES)
    spec = importlib.util.spec_from_file_location("bad_programs", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return path, {s.name: s for s in module.PROGRAMS}


@pytest.mark.parametrize("case", sorted(CAUGHT))
def test_a_known_bad_fixture_is_caught(case, tmp_path):
    _, specs = _fixtures(tmp_path)
    found = pa.audit_spec(specs[case])
    assert [f.detail for f in found] == [CAUGHT[case]], [
        f.render() for f in found]
    assert all(f.pass_name == "programs" and f.scope == case for f in found)


# -- the CLI ------------------------------------------------------------------

def test_cli_programs_pass_exits_zero_on_the_tree():
    proc = _cli("--pass", "programs")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == ""
    pins = sum(1 for e in baseline_mod.BASELINE if e[0] == "programs")
    assert f"0 finding(s), {pins} baseline-suppressed, passes=programs" \
        in proc.stderr, proc.stderr


def test_cli_no_mesh_skips_the_mesh_entries_and_their_pins():
    proc = _cli("--pass", "programs", "--no-mesh")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 finding(s), 0 baseline-suppressed, passes=programs" \
        in proc.stderr, proc.stderr


def test_cli_exits_nonzero_on_the_fixtures(tmp_path):
    path, _ = _fixtures(tmp_path)
    proc = _cli("--pass", "programs", "--programs", str(path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    for case in CAUGHT:
        assert f"[programs] {case}:" in proc.stdout, proc.stdout
    assert f"{len(CAUGHT)} finding(s)" in proc.stderr, proc.stderr


def test_cli_list_prints_every_entry():
    proc = _cli("--list")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert [ln.split(":", 1)[0].split(" ")[0] for ln in lines] == list(
        pa.program_names())
    for ln, spec in zip(lines, pa.PROGRAMS):
        assert f"factory={spec.factory}" in ln
        assert ("aten_ops=" in ln) != spec.mesh


# -- the wrappers' entry counts -----------------------------------------------

def _wrapper_calls():
    from loghisto_tpu_torch.ops import (anomaly, fused_ingest, lifecycle,
                                        multirow_ingest, paged_store,
                                        row_ingest, sparse_ingest, window)

    d, p = pa.dense_whole(), pa.paged_whole()

    def t(x):
        return torch.from_numpy(np.array(x, copy=True))

    def fused():
        fused_ingest.fused_ingest_batch(t(d["acc"]), t(d["raw_ids"]),
                                        t(d["values"]), pa.BL)

    def fused_paged():
        fused_ingest.fused_paged_ingest_batch(
            t(p["pool"]), t(p["raw_ids"]), t(p["values"]), t(p["row_codec"]),
            t(p["enc_luts"]), t(p["table"].T), pa.BL)

    def multirow():
        multirow_ingest.multirow_step(
            torch.zeros((pa.M, pa.B), dtype=torch.int32), t(d["raw_ids"]),
            t(d["values"]), pa.BL)

    values = np.resize(d["values"], 2048)
    return {
        "sparse_ingest": ("sparse_ingest", lambda: sparse_ingest.sparse_ingest(
            t(d["acc"]), t(d["packed"]), pa.BL)),
        "window_merge": ("window_merge", lambda: window.window_merge_views(
            t(d["rings"][0]), d["masks"][0])),
        "paged_scatter": ("paged_scatter", lambda: paged_store.paged_scatter(
            t(p["pool"]), t(p["triples"]))),
        "fused_ingest": ("fused_ingest", fused),
        "fused_paged_ingest": ("fused_paged_ingest", fused_paged),
        "compact_rows": ("compact_rows", lambda: lifecycle.compact_rows_kernel(
            t(d["acc"]), d["perm"])),
        "divergence": ("divergence", lambda: anomaly.divergence_kernel(
            t(d["cdf"]), t(d["counts"]), t(d["prof"][0]), t(d["wsum"][0]),
            10)),
        "histogram_row": ("row_ingest", lambda: row_ingest.histogram_row(
            torch.zeros(pa.B, dtype=torch.int32), t(values), pa.BL)),
        "row_ingest_batch": ("row_ingest", lambda: row_ingest.row_ingest_batch(
            torch.zeros((1, pa.B), dtype=torch.int32), t(d["raw_ids"]),
            t(d["values"]), pa.BL)),
        "multirow_ingest": ("multirow_ingest", multirow),
    }


@pytest.mark.parametrize("wrapper", sorted(_wrapper_calls()))
def test_a_cpu_call_of_each_wrapper_counts_one_entry_and_no_launch(wrapper):
    kernel, call = _wrapper_calls()[wrapper]
    entries, launches = backend.wrapper_entries(), backend.kernel_launches()
    call()
    after = backend.wrapper_entries()
    assert {k: after[k] - entries[k] for k in after
            if after[k] != entries[k]} == {kernel: 1}
    assert backend.kernel_launches() == launches


# -- the mesh entries on four ranks -------------------------------------------

@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    import test_torch_ranks as R

    res = R.launch(tmp_path_factory.mktemp("programs"), 4, "programs")
    return {tuple(int(c) for c in r["coord"]): r for r in res}


def _report(r, name):
    return json.loads(str(r[f"{name}.report"]))


def _outs(r, name):
    n = sum(1 for k in r if k.startswith(f"{name}.out"))
    return [r[f"{name}.out{i}"] for i in range(n)]


def _pinned(name):
    return {e[3] for e in baseline_mod.BASELINE
            if e[0] == "programs" and e[2] == name}


def _twin(name):
    """The one-device twin's outputs (host NumPy leaves) on the whole
    operands the mesh entry cuts its blocks from."""
    from loghisto_tpu_torch.ops import anomaly, commit, lifecycle, paged_store
    from loghisto_tpu_torch.ops.fused_ingest import fused_paged_ingest_batch

    dense = name in ("sharded_fused_commit", "sharded_fused_commit_snapshot",
                     "sharded_fold_evict", "sharded_compact",
                     "sharded_divergence", "sharded_bank_compact")
    d = (pa.dense_whole((pa.M, pa.M)) if dense
         else pa.paged_whole((pa.PAGED_RING_ROWS[0],) * pa.TIERS))

    def t(x):
        return torch.from_numpy(np.array(x, copy=True))

    rings = tuple(t(r) for r in d["rings"])
    if name == "sharded_fused_commit":
        out = commit.make_fused_commit_fn(pa.TIERS, pa.BL)(
            t(d["acc"]), rings, d["slots"], d["keeps"], t(d["packed"]))
    elif name == "sharded_fused_commit_snapshot":
        out = commit.make_fused_commit_snapshot_fn(pa.TIERS, pa.BL)(
            t(d["acc"]), rings, d["slots"], d["keeps"], t(d["packed"]),
            d["masks"])[:3]
    elif name.startswith("sharded_paged_fused_commit"):
        args = [t(d["pool"]), rings, d["slots"], d["keeps"], t(d["packed"]),
                t(d["triples"])]
        if name.endswith("snapshot"):
            out = commit.make_paged_fused_commit_snapshot_fn(
                pa.TIERS, pa.BL)(*args, d["masks"])
        else:
            out = commit.make_paged_fused_commit_fn(pa.TIERS, pa.BL)(*args)
    elif name == "sharded_fused_paged_ingest":
        out = fused_paged_ingest_batch(
            t(d["pool"]), t(d["raw_ids"]), t(d["values"]), t(d["row_codec"]),
            t(d["enc_luts"]), t(d["table"].T), pa.BL)
    elif name == "sharded_paged_commit":
        out = paged_store.paged_scatter(t(d["pool"]), t(d["triples"]))
    elif name == "sharded_fold_evict":
        out = lifecycle.make_fold_evict_fn(pa.TIERS)(
            t(d["acc"]), rings, t(d["last_active"]), d["victims"],
            d["targets"], pa.EPOCH)
    elif name == "sharded_fold_evict_paged":
        out = lifecycle.make_fold_evict_fn(pa.TIERS, with_acc=False)(
            rings, t(d["last_active"]), d["victims"], d["targets"], pa.EPOCH)
    elif name == "sharded_compact":
        out = lifecycle.make_compact_fn(pa.TIERS)(
            t(d["acc"]), list(rings), t(d["last_active"]), d["perm"],
            pa.EPOCH)
    elif name == "sharded_compact_paged":
        out = lifecycle.make_compact_fn(pa.TIERS, with_acc=False)(
            list(rings), t(d["last_active"]), d["perm"], pa.EPOCH)
    elif name == "sharded_divergence":
        out = anomaly.divergence_scores(t(d["cdf"]), t(d["counts"]),
                                        t(d["prof"]), t(d["wsum"]),
                                        d["bank"], d["min_samples"])
    else:
        out = anomaly.make_bank_compact_fn()(t(d["prof"]), t(d["wsum"]),
                                             t(d["ihist"]), d["perm"])
    return [x.numpy() for x in pa.tensor_leaves(out)]


def _block(name, i, whole, m):
    """Rank column m's block of the twin's i-th output: a pool's arena,
    the scores whole (every rank gathers them), else the rows of its
    block along the first axis that spans a row space."""
    arena = pa.POOL_PAGES // pa.MESH_SHAPE[1]
    if name in ("sharded_paged_commit", "sharded_fused_paged_ingest") or (
            name.startswith("sharded_paged_fused_commit") and i == 0):
        return whole[m * arena:(m + 1) * arena]
    if name == "sharded_divergence":
        return whole
    axis = next(k for k, n in enumerate(whole.shape)
                if n in (pa.M, pa.PM, pa.PAGED_RING_ROWS[0]))
    rows = whole.shape[axis] // pa.MESH_SHAPE[1]
    return np.take(whole, np.arange(m * rows, (m + 1) * rows), axis=axis)


@pytest.mark.parametrize("name", MESH)
def test_a_mesh_entry_holds_its_census_and_equals_its_twin(mesh_ranks, name):
    spec = pa.get_spec(name)
    twin = _twin(name)
    pinned = _pinned(name)
    for (s, m), r in sorted(mesh_ranks.items()):
        rep = _report(r, name)
        assert {f["detail"] for f in rep["findings"]} == pinned, rep
        want = {f"{op}:{axis}": n
                for (op, axis), n in spec.contract.collectives.items()}
        assert rep["collectives"] == want, (s, m, rep["collectives"])
        assert rep["launches"] == spec.contract.launches, (s, m)
        ints = [p for p in rep["payloads"]
                if not p.endswith(("float32", "float64"))]
        allowed = ({"all_reduce:stream:int64", "all_reduce:metric:int64"}
                   if "collective-dtype:all_reduce" in pinned else set())
        assert all(p.endswith("int32") or p in allowed for p in ints), ints
        if spec.contract.forbidden_shapes:
            assert not {str(list(f)) for f in
                        spec.contract.forbidden_shapes} & set(rep["shapes"])
        outs = _outs(r, name)
        # the mesh fold returns the total moved, not each victim's count
        whole_outs = twin[:4] if name == "sharded_fold_evict" else twin
        assert len(outs) == len(whole_outs), (name, len(outs), len(twin))
        for i, (got, whole) in enumerate(zip(outs, whole_outs)):
            acc_partial = (i == 0 and name in (
                "sharded_fused_commit", "sharded_fused_commit_snapshot",
                "sharded_fold_evict", "sharded_compact"))
            if acc_partial:   # the stream rows' partials sum to the block
                got = sum(_outs(mesh_ranks[(k, m)], name)[0]
                          for k in range(pa.MESH_SHAPE[0]))
            want = _block(name, i, whole, m)
            if got.dtype.kind == "f":
                key = ("ks", "emd", "jsd")[i] if name == "sharded_divergence" \
                    else None
                np.testing.assert_allclose(
                    got, want, err_msg=f"{name} rank {(s, m)} out {i}",
                    **SCORE_TOL.get(key, SUMS_TOL))
            else:
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{name} rank {(s, m)} out {i}")
        if name == "sharded_fold_evict":
            moved = rep["scalars"][0]
            assert moved == int(twin[-1].astype(np.int64).sum()), moved


# -- on the card --------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the registry's kernels run only "
                    "on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ONE_DEVICE)
def test_a_registry_entry_on_the_card(dev, name):
    """chip_smoke.py phase ``analysis``'s checks: the recorder's contract
    on the card, launches equal to wrapper entries and to the contract,
    a warm call free of syncs, outputs equal to the CPU's."""
    spec = pa.get_spec(name)
    _, want, _ = pa.run_spec(spec, "cpu")
    launched, entered = backend.kernel_launches(), backend.wrapper_entries()
    found, got, _ = pa.run_spec(spec, "cuda")
    torch.cuda.synchronize()
    la, en = backend.kernel_launches(), backend.wrapper_entries()
    assert found == [], [f.render() for f in found]
    delta = {k: la[k] - launched[k] for k in la if la[k] != launched[k]}
    assert delta == {k: en[k] - entered[k] for k in en
                     if en[k] != entered[k]} == spec.contract.launches
    step, args = spec.build("cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for out in (got, warm):
        _assert_same(out, want, f"{name} on the card",
                     tol={k: dict(rtol=t[0], atol=t[1]) for k, t in
                          (("ks", (0.0, 2e-6)), ("jsd", (0.0, 1e-5)),
                           ("emd", (1e-4, pa.B * 2.0**-23)))}
                     | {None: dict(rtol=1e-5, atol=1e-3),
                        "sums": dict(rtol=1e-5, atol=1e-3)})
