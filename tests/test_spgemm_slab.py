"""Slab-sorted ESC SpGEMM (ops/slab_spgemm.py) vs the scipy oracle.

The reference implies SpGEMM A_pattern x A_pattern as ground truth
(SURVEY.md §3.3-3.4); these tests extend that to general rectangular
real-valued products, the global-sort fallback equivalence, and the
degenerate shapes that exercise padding/tail paths.
"""

import numpy as np
import pytest
import scipy.sparse as sp

from spmm_tpu.formats.containers import CSR
from spmm_tpu.formats.synthetic import webgraph_like
from spmm_tpu.ops.slab_spgemm import spgemm_plan, spgemm_slab


def _oracle(A, B):
    C = (A @ B).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def _check(C, Cs):
    assert np.array_equal(np.asarray(C.indptr, np.int64), Cs.indptr.astype(np.int64))
    assert np.array_equal(np.asarray(C.indices[: C.nnz]), Cs.indices)
    # the prefix-sum-difference merge loses ~1 ulp per run vs scipy's direct
    # accumulation; tolerance reflects that
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), Cs.data, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_rectangular(seed):
    rng = np.random.default_rng(seed)
    m, n, k = (int(x) for x in rng.integers(5, 250, 3))
    A = sp.random(m, n, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    B = sp.random(n, k, density=0.05, random_state=seed + 99, format="csr", dtype=np.float32)
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B), classes=(4, 16, 64), slot_budget=1 << 14)
    _check(C, _oracle(A, B))


@pytest.mark.parametrize("seg_w", [1, 4, 8])
@pytest.mark.parametrize("values", ["pattern", "random"])
def test_webgraph_axa_seg_widths(seg_w, values):
    """Both the pattern fast path (all-ones values, value channels elided)
    and the general value-bits path, at every segment width."""
    import dataclasses

    A = webgraph_like(2000, 12000, seed=3)
    if values == "random":
        rng = np.random.default_rng(31)
        A = dataclasses.replace(
            A, data=rng.standard_normal(np.asarray(A.data).shape).astype(np.float32)
        )
    C = spgemm_slab(A, A, seg_w=seg_w)
    _check(C, _oracle(A.to_scipy(), A.to_scipy()))


def test_tail_fallback():
    """A row whose expansion exceeds the largest class goes through the
    global-sort path and must merge seamlessly."""
    rng = np.random.default_rng(7)
    n = 400
    A = sp.random(n, n, density=0.02, random_state=7, format="lil", dtype=np.float32)
    A[0, :] = rng.standard_normal(n)  # heavy row: expansion ~ nnz(B)
    A = A.tocsr()
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(A), classes=(4, 8), slot_budget=1 << 12)
    _check(C, _oracle(A, A))


def test_empty_and_zero_rows():
    A = sp.csr_matrix((5, 7), dtype=np.float32)
    B = sp.random(7, 3, density=0.3, random_state=0, format="csr", dtype=np.float32)
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B))
    assert C.nnz == 0 and C.shape == (5, 3)
    C2 = spgemm_slab(CSR.from_scipy(B), CSR.from_scipy(A.T.tocsr()))
    assert C2.nnz == 0 and C2.shape == (7, 5)


def test_duplicate_merge_values():
    """Columns hit via several A nonzeros must sum, matching scipy exactly."""
    A = sp.csr_matrix(np.array([[1.0, 2.0, 0.0], [0.0, 1.0, 1.0]], np.float32))
    B = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0], [0.5, 0.5]], np.float32))
    C = spgemm_slab(CSR.from_scipy(A), CSR.from_scipy(B))
    _check(C, _oracle(A, B))


def test_plan_metadata():
    A = webgraph_like(500, 3000, seed=4)
    plan = spgemm_plan(A, A, seg_w=4)
    assert plan.nrow == 500
    assert sum(plan.class_counts) <= 500
    # padded expansion covers the true expansion
    lenB = np.diff(np.asarray(A.indptr))
    exp = lenB[np.asarray(A.indices[: A.nnz])]
    assert plan.npa * plan.seg_w >= exp.sum()


def test_matches_global_sort_path():
    from spmm_tpu.ops.spgemm import spgemm_sorted

    A = webgraph_like(800, 4800, seed=5)
    C1 = spgemm_slab(A, A)
    C2 = spgemm_sorted(A, A)
    assert np.array_equal(np.asarray(C1.indices[: C1.nnz]), np.asarray(C2.indices[: C2.nnz]))
    np.testing.assert_allclose(
        np.asarray(C1.data[: C1.nnz]), np.asarray(C2.data[: C2.nnz]), rtol=1e-5
    )


def test_prebuilt_plan_uses_its_own_budget():
    """Regression: executing a plan built with a small slot budget through
    spgemm_slab_device's default budget scheduled chunks past the plan's
    rows_sorted padding (dynamic_slice crash)."""
    from spmm_tpu.ops.slab_spgemm import spgemm_plan, spgemm_slab_device

    A = webgraph_like(3000, 18000, seed=6)
    plan = spgemm_plan(A, A, slot_budget=1 << 14)
    outs, tails, _ = spgemm_slab_device(A, A, plan=plan)  # default budget differs
    nnz_out = sum(int(np.asarray(o[3]).sum()) for o in outs)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    assert nnz_out + 0 == ref.nnz - sum(  # tail rows handled by caller
        ref.indptr[r + 1] - ref.indptr[r] for r in np.asarray(tails, np.int64)
    )


def test_spgemm_slab_csr_device_chainable():
    """Device-resident CSR output chains into SpMM without host transfers."""
    import jax.numpy as jnp

    from spmm_tpu.ops.slab_spgemm import spgemm_slab_csr
    from spmm_tpu.ops import spmm_xla

    A = webgraph_like(1200, 7200, seed=8)
    C = spgemm_slab_csr(A, A)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    Ch = C.host()
    np.testing.assert_array_equal(np.asarray(Ch.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(np.asarray(Ch.indices[: C.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(Ch.data[: C.nnz]), ref.data, rtol=1e-4, atol=1e-4)
    # chain: y = C @ x entirely on device
    x = jnp.asarray(np.random.default_rng(0).standard_normal((1200, 4)).astype(np.float32))
    y = np.asarray(spmm_xla(C, x))
    np.testing.assert_allclose(y, ref @ np.asarray(x), rtol=2e-4, atol=2e-4)


def test_spgemm_chain_no_host_roundtrip(monkeypatch):
    """Chaining C = A@A into C@A keeps sizing ON DEVICE: no ``.host()`` pull
    and no nnz-scale ``np.asarray`` of the chained operand (`_sizing` used
    to pull the full device CSR per product)."""
    from spmm_tpu.ops.slab_spgemm import spgemm_slab_csr

    A = webgraph_like(900, 5400, seed=5)
    C = spgemm_slab_csr(A, A)  # device-resident

    pulled = []
    orig_host = CSR.host
    monkeypatch.setattr(CSR, "host", lambda self: pulled.append(self) or orig_host(self))
    D = spgemm_slab_csr(C, C.device())  # chained product, both operands device
    assert not pulled, "chained spgemm pulled a device CSR to host"

    Cs = _oracle(A.to_scipy(), A.to_scipy())
    ref = _oracle(Cs, Cs)
    assert D.nnz == ref.nnz
    Dh = orig_host(D)
    np.testing.assert_array_equal(np.asarray(Dh.indptr, np.int64), ref.indptr)
    np.testing.assert_array_equal(np.asarray(Dh.indices[: D.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(Dh.data[: D.nnz]), ref.data, rtol=2e-4, atol=2e-4)


def test_sizing_device_matches_host():
    """The device sizing pass agrees with the host/native sizing exactly
    (npa, nsegB, per-row class after folding, counts)."""
    from spmm_tpu.ops.slab_spgemm import (
        DEFAULT_CLASSES, _round_up, _sizing, _sizing_device,
    )

    A = webgraph_like(2500, 15000, seed=11)
    W = 4
    classes = tuple(sorted({_round_up(c, W) for c in DEFAULT_CLASSES}))
    npa_h, nsegB_h, cls_h, counts_h = _sizing(A, A, W, classes)
    npa_d, nsegB_d, cls_d, counts_d = _sizing_device(A.device(), A.device(), W, classes)
    assert (npa_h, nsegB_h) == (npa_d, nsegB_d)
    assert counts_h == counts_d
    np.testing.assert_array_equal(np.asarray(cls_h), np.asarray(cls_d))


def test_huge_expansion_row_chunking(monkeypatch):
    """Products whose padded expansion exceeds the int32 device budget split
    A's rows automatically (exercised via a tiny patched threshold)."""
    import spmm_tpu.ops.slab_spgemm as mod

    monkeypatch.setattr(mod, "_MAX_EXP_PAD", 4096)
    A = webgraph_like(1000, 6000, seed=14)
    C = mod.spgemm_slab(A, A)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    ref.sort_indices()
    assert C.nnz == ref.nnz
    np.testing.assert_array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
    np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-4, atol=2e-4)


def test_big_path_with_tail_rows(monkeypatch):
    """Uniform-piece big path with a heavy row above the class ceiling:
    tail-bearing pieces take the masked+counting-sort assembly, others the
    device compact; the stitched CSR must still be canonical."""
    import scipy.sparse as sp

    import spmm_tpu.ops.slab_spgemm as mod

    monkeypatch.setattr(mod, "_MAX_EXP_PAD", 4096)
    rng = np.random.default_rng(21)
    n = 900
    A = sp.random(n, n, density=0.015, random_state=21, format="lil", dtype=np.float32)
    A[7, :] = rng.standard_normal(n)  # heavy row -> tail in its piece
    A = A.tocsr()
    Ac = CSR.from_scipy(A)
    C = mod.spgemm_slab(Ac, Ac, classes=(4, 8, 16))
    _check(C, _oracle(A, A))


def test_big_path_checkpoint_resume(monkeypatch, tmp_path):
    """Piece-granular checkpoint/resume on the streamed big path (SURVEY.md
    §5: the reference has no checkpoint/resume at all): a second run with the
    same checkpoint dir recomputes NO pieces; deleting one piece file
    recomputes exactly that piece; a different product in the same dir is
    refused (manifest guard)."""
    import pytest

    import spmm_tpu.ops.slab_spgemm as mod

    monkeypatch.setattr(mod, "_MAX_EXP_PAD", 4096)
    A = webgraph_like(1000, 6000, seed=14)
    ref = _oracle(A.to_scipy(), A.to_scipy())

    ckdir = str(tmp_path / "ck")
    calls = []
    orig_exec = mod._piece_exec

    def counting_exec(*a, **k):
        calls.append(1)
        return orig_exec(*a, **k)

    monkeypatch.setattr(mod, "_piece_exec", counting_exec)

    C1 = mod.spgemm_slab(A, A, checkpoint_dir=ckdir)
    _check(C1, ref)
    n_pieces = len(calls)
    assert n_pieces >= 2  # the tiny budget forces a real split

    # full resume: every piece served from disk
    calls.clear()
    C2 = mod.spgemm_slab(A, A, checkpoint_dir=ckdir)
    _check(C2, ref)
    assert calls == []

    # partial resume: drop one piece file -> exactly one recompute
    import glob
    import os

    victim = sorted(glob.glob(os.path.join(ckdir, "piece_*.npz")))[1]
    os.remove(victim)
    calls.clear()
    C3 = mod.spgemm_slab(A, A, checkpoint_dir=ckdir)
    _check(C3, ref)
    assert len(calls) == 1

    # manifest guard: a different product in the same dir is refused
    A2 = webgraph_like(1000, 6000, seed=15)
    with pytest.raises(ValueError, match="manifest"):
        mod.spgemm_slab(A2, A2, checkpoint_dir=ckdir)


def test_rmat_axa():
    """Graph500-style RMAT input (heavier skew than the web-graph generator,
    duplicate edges summed at ingest) through the full slab path."""
    from spmm_tpu.formats.synthetic import rmat_matrix

    A = rmat_matrix(11, edge_factor=8, seed=19)  # 2048 nodes, ~16K edges
    C = spgemm_slab(A, A)
    _check(C, _oracle(A.to_scipy(), A.to_scipy()))


def test_plan_aligned_cache_parity():
    """The class-aligned pre-expanded cache (spgemm_plan(expand=True), the
    default) must produce bit-identical chunk outputs to the fetch-inside-
    chunks path (expand=False), in pattern and value modes."""
    import dataclasses as _dc

    from spmm_tpu.ops.slab_spgemm import spgemm_plan, spgemm_slab_device

    A = webgraph_like(1200, 7200, seed=7)
    rng = np.random.default_rng(8)
    Av = _dc.replace(
        A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32)
    )
    for M in (A, Av):
        p_al = spgemm_plan(M, M)  # expand=True default
        p_fe = spgemm_plan(M, M, expand=False)
        assert bool(p_al.aligned_cols) and not p_fe.aligned_cols
        o1, t1, _ = spgemm_slab_device(M, M, plan=p_al)
        o2, t2, _ = spgemm_slab_device(M, M, plan=p_fe)
        assert np.array_equal(t1, t2)
        for c1, c2 in zip(o1, o2):
            for x1, x2 in zip(c1, c2):
                assert np.array_equal(np.asarray(x1), np.asarray(x2))


def test_chain_device_matches_single():
    """spgemm_chain_device (N back-to-back plan-reuse products, one fence)
    returns chunk outputs bit-identical to one spgemm_slab_device(plan=...)
    execution, pattern and value modes."""
    import dataclasses as _dc

    from spmm_tpu.ops.slab_spgemm import (
        spgemm_chain_device, spgemm_plan, spgemm_slab_device,
    )

    A = webgraph_like(1200, 7200, seed=9)
    rng = np.random.default_rng(10)
    Av = _dc.replace(
        A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32)
    )
    for M in (A, Av):
        plan = spgemm_plan(M, M)
        o1, _, _ = spgemm_slab_device(M, M, plan=plan)
        oc = spgemm_chain_device(plan, 3)
        for c1, c2 in zip(o1, oc):
            for x1, x2 in zip(c1, c2):
                assert np.array_equal(np.asarray(x1), np.asarray(x2))


def test_plan_serialize_roundtrip(tmp_path):
    """A SpgemmPlan survives save/load (utils.serialize) and a loaded plan
    executes in a fresh context with bit-identical chunk outputs — the
    preprocess-once / multiply-in-another-process contract (the reference's
    whole premise, SURVEY.md §0, applied to the two-phase SpGEMM)."""
    import jax
    import jax.numpy as jnp

    from spmm_tpu.ops.slab_spgemm import spgemm_plan, spgemm_slab_device
    from spmm_tpu.utils.serialize import load, save

    A = webgraph_like(1100, 6600, seed=17)
    plan = spgemm_plan(A, A)
    path = tmp_path / "plan.npz"
    save(path, plan)
    plan2 = load(path)
    assert type(plan2).__name__ == "SpgemmPlan"
    # statics survive exactly (they gate the schedule + program selection)
    for f in ("classes", "class_counts", "seg_w", "npa", "nrow",
              "slot_budget", "a_dtype", "b_dtype", "pattern", "b2_ws",
              "aligned_accum"):
        assert getattr(plan2, f) == getattr(plan, f), f
    plan2 = jax.tree.map(jnp.asarray, plan2)  # one device move for reuse
    o1, t1, _ = spgemm_slab_device(A, A, plan=plan)
    o2, t2, _ = spgemm_slab_device(A, A, plan=plan2)
    assert np.array_equal(t1, t2)
    for c1, c2 in zip(o1, o2):
        for x1, x2 in zip(c1, c2):
            assert np.array_equal(np.asarray(x1), np.asarray(x2))


def test_auto_plan_reuse():
    """ops.spgemm(A, A) self-optimizes: call 2 builds the cached plan, call
    3 rides the gather-free aligned numeric path — results identical to the
    cold path and scipy across all calls, pattern and value modes."""
    import dataclasses as _dc

    from spmm_tpu.ops import slab_spgemm as ss

    old_min = ss.AUTO_PLAN_MIN_NNZ
    ss.AUTO_PLAN_MIN_NNZ = 1  # the test matrix is small
    try:
        A = webgraph_like(900, 5400, seed=9)
        rng = np.random.default_rng(10)
        Av = _dc.replace(
            A, data=rng.standard_normal(A.data.shape[0]).astype(np.float32)
        )
        for M in (A, Av):
            ss._PLAN_SEEN.clear(); ss._PLAN_CACHE.clear()
            ref = (M.to_scipy() @ M.to_scipy()).tocsr()
            ref.sum_duplicates(); ref.sort_indices()
            for call in range(3):
                C = ss.spgemm_slab(M, M)
                assert C.nnz == ref.nnz, (call, C.nnz, ref.nnz)
                np.testing.assert_array_equal(
                    np.asarray(C.indices[: C.nnz]), ref.indices
                )
                np.testing.assert_allclose(
                    np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-5, atol=1e-5
                )
            assert len(ss._PLAN_CACHE) == 1  # built on call 2, reused on 3
        # in-place value mutation must invalidate the cached plan (the plan
        # bakes values; the fingerprint guard catches the rewrite)
        Av.data[: Av.nnz] *= 2.0
        ref2 = (Av.to_scipy() @ Av.to_scipy()).tocsr()
        ref2.sum_duplicates(); ref2.sort_indices()
        C = ss.spgemm_slab(Av, Av)
        np.testing.assert_allclose(
            np.asarray(C.data[: C.nnz]), ref2.data, rtol=1e-4, atol=1e-4
        )
    finally:
        ss.AUTO_PLAN_MIN_NNZ = old_min
        ss._PLAN_SEEN.clear(); ss._PLAN_CACHE.clear()


def test_plan_revalue_new_values(monkeypatch):
    """spgemm_plan_revalue: same structure, new values (the cuSPARSE
    spgemm-reuse workload; the reference's preprocess-once premise,
    SURVEY.md §0).  The structure-only host sizing pass must NOT re-run —
    it is reused from the original plan — and the re-valued plan's numeric
    execution is exact for the new values."""
    import dataclasses as _dc

    from spmm_tpu.ops import slab_spgemm as ss

    A0 = webgraph_like(1500, 9000, seed=12)

    def with_vals(seed):
        r = np.random.default_rng(seed)
        return _dc.replace(
            A0, data=r.standard_normal(np.asarray(A0.data).shape).astype(np.float32)
        )

    def run(plan, M, N):
        outs, tails, _ = ss.spgemm_slab_device(M, N, plan=plan)
        rows, cols, vals = ss._pull_chunks(outs)
        if len(tails):
            tr, tc, tv = ss._tail_products(
                M.host(), np.asarray(tails, np.int64), N.host(), np.float32
            )
            rows.append(tr)
            cols.append(tc)
            vals.append(tv)
        return ss._assemble_csr(
            np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
            (M.nrow, N.ncol),
        )

    A1, B1 = with_vals(1), with_vals(2)
    plan1 = ss.spgemm_plan(A1, B1)
    _check(run(plan1, A1, B1), _oracle(A1.to_scipy(), B1.to_scipy()))

    A2, B2 = with_vals(3), with_vals(4)

    def boom(*a, **k):
        raise AssertionError("host sizing must not re-run on revalue")

    monkeypatch.setattr(ss, "_sizing", boom)
    plan2 = ss.spgemm_plan_revalue(plan1, A2, B2)
    monkeypatch.undo()
    _check(run(plan2, A2, B2), _oracle(A2.to_scipy(), B2.to_scipy()))

    # a pattern-mode original plan revalues into value mode the same way
    plan_p = ss.spgemm_plan(A0, A0)
    assert plan_p.pattern
    monkeypatch.setattr(ss, "_sizing", boom)
    plan_v = ss.spgemm_plan_revalue(plan_p, A1, B1)
    monkeypatch.undo()
    assert not plan_v.pattern
    _check(run(plan_v, A1, B1), _oracle(A1.to_scipy(), B1.to_scipy()))

    # structure mismatch is rejected
    bad = webgraph_like(1500, 9600, seed=13)
    with pytest.raises(ValueError):
        ss.spgemm_plan_revalue(plan1, bad, bad)
