"""Distributed paths on an 8-device CPU mesh (SURVEY.md §4.3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_tpu.formats.synthetic import random_csr, webgraph_like
from spmm_tpu.parallel import (
    make_mesh,
    partition_rows,
    spmm_dist,
    spmm_dist_ring,
    spmv_dist,
)
from spmm_tpu.parallel.partition import unshard_rows


@pytest.fixture(scope="module")
def mesh():
    return make_mesh()


@pytest.fixture(scope="module")
def mats():
    A = webgraph_like(2000, 14000, seed=0)
    S = partition_rows(A, 8)
    B = np.random.default_rng(0).standard_normal((2000, 16)).astype(np.float32)
    return A, S, B


def test_partition_rows_roundtrip(mats):
    A, S, _ = mats
    # reassemble and compare
    rows = []
    for i in range(S.n_shards):
        ptr = np.asarray(S.indptr[i])
        nnz_i = ptr[-1]
        rows.append((np.asarray(S.data[i][:nnz_i]), np.asarray(S.indices[i][:nnz_i])))
    data = np.concatenate([d for d, _ in rows])
    idx = np.concatenate([i for _, i in rows])
    np.testing.assert_array_equal(data, np.asarray(A.data[: A.nnz]))
    np.testing.assert_array_equal(idx, np.asarray(A.indices[: A.nnz]))


def test_spmm_dist_allgather(mesh, mats):
    A, S, B = mats
    Y = unshard_rows(np.asarray(spmm_dist(S, jnp.asarray(B), mesh)), S)
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_spmm_dist_ring_matches_allgather(mesh, mats):
    A, S, B = mats
    Bpad = np.zeros((S.rows_per_shard * 8, 16), np.float32)
    Bpad[:2000] = B
    Yr = unshard_rows(np.asarray(spmm_dist_ring(S, jnp.asarray(Bpad), mesh)), S)
    np.testing.assert_allclose(Yr, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_spmm_dist_colsplit(mesh, mats):
    """Contraction-axis split: A column-sharded, zero-comm partials, one
    psum_scatter — parity with the row-sharded strategies."""
    from spmm_tpu.parallel import partition_cols, spmm_dist_colsplit

    A, _, B = mats
    Sc = partition_cols(A, 8)
    Y = np.asarray(spmm_dist_colsplit(Sc, jnp.asarray(B), mesh))
    Y = Y.reshape(-1, B.shape[1])[: A.shape[0]]
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_partition_cols_roundtrip(mats):
    """Column blocks reassemble to the original matrix exactly."""
    import scipy.sparse as sp

    from spmm_tpu.parallel import partition_cols

    A, _, _ = mats
    Sc = partition_cols(A, 8)
    m, n = A.shape
    acc = sp.csr_matrix((m, n), dtype=np.float64)
    for i in range(Sc.n_shards):
        ptr = np.asarray(Sc.indptr[i], np.int64)[: m + 1]
        k = int(ptr[-1])
        block = sp.csr_matrix(
            (np.asarray(Sc.data[i][:k], np.float64),
             np.asarray(Sc.indices[i][:k], np.int64) + int(Sc.col_starts[i]),
             ptr),
            shape=(m, n),
        )
        acc = acc + block
    d = abs(acc - A.to_scipy())
    assert d.nnz == 0 or d.max() == 0


def test_spmv_dist(mesh, mats):
    A, S, B = mats
    x = B[:, 0].copy()
    y = unshard_rows(np.asarray(spmv_dist(S, jnp.asarray(x), mesh))[..., None], S)
    np.testing.assert_allclose(y[:, 0], A.to_scipy() @ x, rtol=1e-4, atol=1e-4)


def test_spgemm_dist_spmd_fixture_mats(mesh, mats):
    """SPMD SpGEMM on the shared fixture matrices (the host-loop spgemm_dist
    this replaced is gone: one SPMD program supersedes per-shard dispatch)."""
    from spmm_tpu.parallel import spgemm_dist_spmd

    A, S, _ = mats
    C = spgemm_dist_spmd(S, A, mesh)
    refC = (A.to_scipy() @ A.to_scipy()).tocsr()
    refC.sum_duplicates()
    refC.sort_indices()
    assert C.nnz == refC.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), refC.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), refC.data, rtol=1e-4, atol=1e-4)


def test_uneven_rows_and_empty_shards(mesh):
    # nrow not divisible by shards; trailing shards nearly empty
    A = random_csr(1003, 777, 0.01, seed=3)
    S = partition_rows(A, 8)
    B = np.random.default_rng(1).standard_normal((777, 8)).astype(np.float32)
    Y = unshard_rows(np.asarray(spmm_dist(S, jnp.asarray(np.concatenate([B, np.zeros((S.rows_per_shard*8 - 777, 8), np.float32)])), mesh)), S)
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_chip_smoke_multichip_phase_on_four_devices():
    """chip_smoke.py's distributed phase (the `--chips 4` run) on 4 of the
    8 virtual devices at tiny size: every strategy against scipy."""
    import chip_smoke

    lines = chip_smoke.phase_multichip(
        4, 1200, 7200, seed=1, k=16, classes=(16, 64), slot_budget=1 << 14
    )
    names = [check.split()[0] for check, _, _ in lines]
    assert names == [
        "spmm_dist_ring", "spmm_dist_colsplit", "spgemm_dist_spmd",
        "spgemm_dist_plan/exec", "spgemm_dist_revalue", "spgemm_dist_big",
    ]


def test_spgemm_dist_spmd_matches_scipy():
    """SPMD row-partitioned SpGEMM on the
    8-device CPU mesh vs the scipy oracle."""
    import numpy as np

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_spmd

    import dataclasses

    # random values: exercises the value-bits path (pattern auto-detect off)
    A = webgraph_like(3000, 21000, seed=11)
    rng = np.random.default_rng(11)
    A = dataclasses.replace(
        A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32)
    )
    mesh = make_mesh()
    S = partition_rows(A, mesh.shape["rows"])
    C = spgemm_dist_spmd(S, A, mesh)
    Sp = A.to_scipy()
    ref = (Sp @ Sp).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indptr), ref.indptr.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-5, atol=2e-5)


def test_spgemm_dist_spmd_with_tail_rows():
    """A heavy row (expansion above the class ceiling) routes through the
    per-shard host fallback and merges into the global CSR."""
    import numpy as np
    import scipy.sparse as sp

    from spmm_tpu.formats.containers import CSR
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_spmd

    rng = np.random.default_rng(3)
    n = 600
    A = sp.random(n, n, density=0.01, random_state=3, format="lil", dtype=np.float32)
    A[5, :] = rng.standard_normal(n)
    A = A.tocsr()
    Ac = CSR.from_scipy(A)
    mesh = make_mesh()
    S = partition_rows(Ac, mesh.shape["rows"])
    C = spgemm_dist_spmd(S, Ac, mesh, classes=(4, 8, 16))
    ref = (A @ A).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4)


def test_spgemm_dist_halo_matches_scipy():
    """Halo-restricted SPMD SpGEMM (each shard holds only its referenced B
    rows) vs scipy, pattern and value modes."""
    import dataclasses

    import numpy as np

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import partition_halo, spgemm_dist_halo

    A = webgraph_like(2400, 16000, seed=13)
    mesh = make_mesh()
    S = partition_rows(A, mesh.shape["rows"])

    # halo restriction is real: every shard's local B is smaller than B
    _, lb_iptr, _, _, _, halo_counts = partition_halo(S, A)
    assert halo_counts.max() < A.nrow

    for values in ("pattern", "random"):
        Ax = A
        if values == "random":
            rng = np.random.default_rng(13)
            Ax = dataclasses.replace(
                A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32)
            )
            S2 = partition_rows(Ax, mesh.shape["rows"])
        else:
            S2 = S
        C = spgemm_dist_halo(S2, Ax, mesh)
        Sp = Ax.to_scipy()
        ref = (Sp @ Sp).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        assert C.nnz == ref.nnz
        np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
        np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-5, atol=2e-5)


def test_spgemm_dist_halo_tail_fallback():
    """Halo SpGEMM on a power-law graph WITH heavy-tail rows and default
    classes: tails route through the host fallback instead of raising."""
    import numpy as np
    import scipy.sparse as sp

    from spmm_tpu.formats.containers import CSR
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_halo

    rng = np.random.default_rng(7)
    n = 800
    A = sp.random(n, n, density=0.008, random_state=7, format="lil", dtype=np.float32)
    A[3, :] = rng.standard_normal(n)  # heavy row: expansion > class ceiling
    A[n - 2, :] = rng.standard_normal(n)
    A = A.tocsr()
    Ac = CSR.from_scipy(A)
    mesh = make_mesh()
    S = partition_rows(Ac, mesh.shape["rows"])
    C = spgemm_dist_halo(S, Ac, mesh, classes=(4, 8, 16, 32))
    ref = (A @ A).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4)


def test_spgemm_dist_csr_device_resident():
    """Device-resident distributed output: C stays row-sharded on device
    (per-shard _compact_to_csr inside the SPMD program); reassembly matches
    scipy and the result chains into a second distributed product."""
    import numpy as np

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_csr

    A = webgraph_like(2400, 12000, seed=17)
    mesh = make_mesh()
    S = partition_rows(A, mesh.shape["rows"])
    C = spgemm_dist_csr(S, A, mesh, classes=(16, 64, 256, 1024, 4096, 16384))
    Sp = A.to_scipy()
    ref = (Sp @ Sp).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    # per-shard local CSRs are device arrays; reassemble on host
    import jax

    assert all(
        isinstance(x, jax.Array) for x in (C.data, C.indices, C.indptr)
    )
    rows_l, cols_l, vals_l = [], [], []
    iptr = np.asarray(C.indptr, np.int64)
    for s in range(C.n_shards):
        k = int(iptr[s, -1])
        lens = iptr[s, 1:] - iptr[s, :-1]
        rows_l.append(
            np.repeat(np.arange(C.rows_per_shard), lens) + int(C.row_starts[s])
        )
        cols_l.append(np.asarray(C.indices[s, :k], np.int64))
        vals_l.append(np.asarray(C.data[s, :k]))
    import scipy.sparse as sp

    got = sp.coo_matrix(
        (np.concatenate(vals_l), (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=C.shape,
    ).tocsr()
    got.sum_duplicates()
    assert abs(got - ref).max() < 1e-4


def test_spgemm_dist_halo_exchange_matches_scipy(monkeypatch):
    """Runtime halo exchange: B row-block sharded, working sets pulled by an
    in-program all_to_all.  Parity in pattern and
    value modes; the collective is actually traced into the program."""
    import dataclasses

    import jax
    import numpy as np

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import make_mesh, partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_halo_exchange

    calls = []
    orig = jax.lax.all_to_all

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(jax.lax, "all_to_all", spy)

    A = webgraph_like(2400, 16000, seed=19)
    mesh = make_mesh()
    for values in ("pattern", "random"):
        Ax = A
        if values == "random":
            rng = np.random.default_rng(19)
            Ax = dataclasses.replace(
                A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32)
            )
        S = partition_rows(Ax, mesh.shape["rows"])
        C = spgemm_dist_halo_exchange(S, Ax, mesh)
        Sp = Ax.to_scipy()
        ref = (Sp @ Sp).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        assert C.nnz == ref.nnz
        np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
        np.testing.assert_allclose(
            np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-5, atol=2e-5
        )
    assert calls, "all_to_all collective was never traced into the program"


def test_spgemm_dist_plan_reuse(mesh):
    """Distributed two-phase: spgemm_dist_plan + spgemm_dist_exec must match
    the one-shot SPMD path and scipy exactly, pattern and value modes,
    including heavy-tail rows, across repeated executions."""
    import dataclasses as _dc

    from spmm_tpu.parallel import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_exec, spgemm_dist_plan

    A = webgraph_like(1024, 6100, seed=11)
    rng = np.random.default_rng(12)
    Av = _dc.replace(A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32))
    for M in (A, Av):
        S = partition_rows(M, 8)
        plan = spgemm_dist_plan(S, M, mesh, classes=(16, 64, 256), slot_budget=1 << 14)
        ref = (M.to_scipy() @ M.to_scipy()).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        for _ in range(2):  # re-exec: the reuse contract
            C = spgemm_dist_exec(plan, mesh)
            assert C.nnz == ref.nnz
            np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
            np.testing.assert_allclose(
                np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4
            )


def test_spgemm_dist_plan_b_sharded(mesh):
    """Two-phase plan with B row-BLOCK sharded: structure exchanged once at
    plan time via the in-program ``all_to_all``, aligned cache device
    resident, re-execution collective-free — parity with scipy in pattern
    AND value modes: plan reuse does not require a replicated B."""
    import dataclasses as _dc

    from spmm_tpu.parallel import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_exec, spgemm_dist_plan

    A = webgraph_like(1024, 6100, seed=21)
    rng = np.random.default_rng(22)
    Av = _dc.replace(A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32))
    for M in (A, Av):
        S = partition_rows(M, 8)
        plan = spgemm_dist_plan(
            S, M, mesh, classes=(16, 64, 256), slot_budget=1 << 14,
            b_sharded=True,
        )
        ref = (M.to_scipy() @ M.to_scipy()).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        for _ in range(2):  # re-exec: no collective, same result
            C = spgemm_dist_exec(plan, mesh)
            assert C.nnz == ref.nnz
            np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
            np.testing.assert_allclose(
                np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4
            )


def test_spgemm_dist_big(mesh, tmp_path, monkeypatch):
    """Streamed distributed SpGEMM: pieces
    of every shard run through ONE compiled SPMD program; exact scipy parity
    of the stitched CSR; piece-granular checkpoint/resume."""
    import glob
    import os

    from spmm_tpu.ops import slab_spgemm as slab
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big

    A = webgraph_like(4096, 26000, seed=31)
    sC = (A.to_scipy() @ A.to_scipy()).tocsr()
    sC.sum_duplicates()
    sC.sort_indices()

    # forced multi-piece streaming via a tiny per-piece budget
    monkeypatch.setattr(slab, "_MAX_EXP_PAD", 1 << 13)
    C = spgemm_dist_big(A, A, mesh)
    assert C.nnz == sC.nnz
    np.testing.assert_array_equal(np.asarray(C.indptr), sC.indptr.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), sC.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), sC.data, rtol=1e-4, atol=1e-4)

    # checkpoint: run, delete one piece, resume; mismatched operands refuse
    d = str(tmp_path / "ck")
    C1 = spgemm_dist_big(A, A, mesh, pieces=2, checkpoint_dir=d)
    assert C1.nnz == sC.nnz
    files = sorted(glob.glob(os.path.join(d, "piece_*.npz")))
    assert len(files) == 2
    os.remove(files[0])
    C2 = spgemm_dist_big(A, A, mesh, pieces=2, checkpoint_dir=d)
    assert C2.nnz == sC.nnz
    A2 = webgraph_like(4096, 26000, seed=32)
    with pytest.raises(ValueError):
        spgemm_dist_big(A2, A2, mesh, pieces=2, checkpoint_dir=d)


@pytest.mark.slow
def test_spgemm_dist_moderate_scale(mesh):
    """Moderate-scale distributed parity (the other distributed tests are
    toy-sized).  A power-law product with >=1M output
    nonzeros through BOTH the device-resident strategy and the runtime halo
    exchange, exact nnz/index parity against scipy."""
    from spmm_tpu.parallel import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import (
        spgemm_dist_csr,
        spgemm_dist_halo_exchange,
    )
    from spmm_tpu.parallel.partition import unshard_csr_rows

    A = webgraph_like(30000, 210000, seed=41)
    sC = (A.to_scipy() @ A.to_scipy()).tocsr()
    sC.sum_duplicates()
    sC.sort_indices()
    assert sC.nnz >= 1_000_000, sC.nnz

    S = partition_rows(A, 8)
    Cd = spgemm_dist_csr(S, A, mesh)
    C = unshard_csr_rows(Cd)
    assert C.nnz == sC.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), sC.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), sC.data, rtol=1e-4, atol=1e-4)

    Ch = spgemm_dist_halo_exchange(S, A, mesh)
    assert Ch.nnz == sC.nnz
    np.testing.assert_array_equal(np.asarray(Ch.indices[: Ch.nnz]), sC.indices)
    np.testing.assert_allclose(
        np.asarray(Ch.data[: Ch.nnz]), sC.data, rtol=1e-4, atol=1e-4
    )


def test_spgemm_dist_revalue(mesh):
    """Distributed revalue: same structure, new values — plan rebuilt
    through the memoized plan program (no re-sizing, no new exchange maps),
    exec parity with scipy on the NEW values; both B modes."""
    import dataclasses as _dc

    from spmm_tpu.parallel import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import (
        spgemm_dist_exec,
        spgemm_dist_plan,
        spgemm_dist_revalue,
    )

    A = webgraph_like(1024, 6100, seed=51)
    rng = np.random.default_rng(52)
    Av = _dc.replace(A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32))
    Av2 = _dc.replace(A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32))
    for bs in (False, True):
        S = partition_rows(Av, 8)
        plan = spgemm_dist_plan(
            S, Av, mesh, classes=(16, 64, 256), slot_budget=1 << 14,
            b_sharded=bs,
        )
        S2 = partition_rows(Av2, 8)
        plan2 = spgemm_dist_revalue(plan, S2, Av2, mesh)
        C = spgemm_dist_exec(plan2, mesh)
        ref = (Av2.to_scipy() @ Av2.to_scipy()).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        assert C.nnz == ref.nnz
        np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
        np.testing.assert_allclose(
            np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4
        )
        # structure mismatch must raise
        bad = webgraph_like(1024, 6000, seed=53)
        with pytest.raises(ValueError):
            spgemm_dist_revalue(plan, partition_rows(bad, 8), bad, mesh)


def test_spgemm_dist_big_b_sharded(mesh):
    """Streamed distributed SpGEMM with B row-BLOCK sharded: every piece's
    halo working set fetched by the in-program all_to_all (no device holds a
    full B replica), all pieces through ONE compiled exchange program with
    piece-wise-max map paddings.  Exact scipy parity, pattern + value."""
    import dataclasses as _dc

    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big

    A = webgraph_like(4096, 26000, seed=71)
    sC = (A.to_scipy() @ A.to_scipy()).tocsr()
    sC.sum_duplicates()
    sC.sort_indices()
    C = spgemm_dist_big(A, A, mesh, pieces=2, b_sharded=True)
    assert C.nnz == sC.nnz
    np.testing.assert_array_equal(np.asarray(C.indptr), sC.indptr.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), sC.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), sC.data, rtol=1e-4, atol=1e-4)

    Av = _dc.replace(
        A, data=np.random.default_rng(72).standard_normal(
            A.data.shape[0]).astype(np.float32)
    )
    sv = (Av.to_scipy() @ Av.to_scipy()).tocsr()
    sv.sum_duplicates()
    sv.sort_indices()
    Cv = spgemm_dist_big(Av, Av, mesh, pieces=2, b_sharded=True)
    assert Cv.nnz == sv.nnz
    np.testing.assert_allclose(
        np.asarray(Cv.data[: Cv.nnz]), sv.data, rtol=1e-4, atol=1e-4
    )


def test_spgemm_dist_big_all_tail(mesh):
    """Every row past the class ceiling (empty chunk schedule): the whole
    product routes through the host tail fallback instead of crashing inside
    the compact program trace."""
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big

    A = webgraph_like(1024, 8000, seed=81)
    sC = (A.to_scipy() @ A.to_scipy()).tocsr()
    sC.sum_duplicates()
    sC.sort_indices()
    C = spgemm_dist_big(A, A, mesh, pieces=2, classes=(8, 16), slot_budget=1 << 12)
    assert C.nnz == sC.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), sC.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), sC.data, rtol=1e-4, atol=1e-4)
