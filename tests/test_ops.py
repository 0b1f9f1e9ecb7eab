import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_tpu.formats.synthetic import random_csr, webgraph_like
from spmm_tpu.ops import spgemm, spgemm_expand_bound, spmm_xla, spmv_xla


@pytest.mark.parametrize("m,n,k,density", [(64, 48, 8, 0.1), (200, 300, 32, 0.02), (33, 17, 5, 0.3)])
def test_spmm_matches_scipy(m, n, k, density):
    A = random_csr(m, n, density, seed=m + k)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((n, k)).astype(np.float32)
    got = np.asarray(spmm_xla(A.pad(16).device(), jnp.asarray(B)))
    ref = A.to_scipy() @ B
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_spmm_jit_and_grad():
    A = random_csr(32, 24, 0.2, seed=9).pad(8).device()
    B = jnp.asarray(np.random.default_rng(1).standard_normal((24, 16)).astype(np.float32))

    f = jax.jit(lambda a, b: spmm_xla(a, b).sum())
    v = f(A, B)
    g = jax.grad(lambda b: f(A, b))(B)
    # d(sum(AB))/dB = A^T @ ones
    ref = A.to_scipy().T @ np.ones((32, 16), np.float32)
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(v), (A.to_scipy() @ np.asarray(B)).sum(), rtol=1e-3)


def test_spmv_matches_scipy():
    A = random_csr(100, 80, 0.05, seed=2).pad(8).device()
    x = jnp.asarray(np.random.default_rng(3).standard_normal(80).astype(np.float32))
    got = np.asarray(spmv_xla(A, x))
    ref = A.to_scipy() @ np.asarray(x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_empty_rows_and_cols():
    # matrix with empty rows must produce zero rows, not garbage
    A = random_csr(50, 50, 0.01, seed=4).pad(8).device()
    B = jnp.ones((50, 4), jnp.float32)
    got = np.asarray(spmm_xla(A, B))
    ref = A.to_scipy() @ np.ones((50, 4), np.float32)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_spgemm_axa_pattern(seed):
    # the reference workload: A_pattern @ A_pattern on a square web-like graph
    # (SURVEY.md §3.4 — ground truth is scipy on the 0/1 pattern matrix)
    A = webgraph_like(400, 3000, seed=seed)
    C = spgemm(A, A)
    ref = (A.to_scipy() @ A.to_scipy()).tocsr()
    ref.sum_duplicates()
    got = C.to_scipy()
    assert got.shape == ref.shape
    assert (got != ref).nnz == 0 or np.abs((got - ref)).max() < 1e-4
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-5)


def test_spgemm_rectangular_real_values():
    A = random_csr(60, 40, 0.08, seed=7)
    B = random_csr(40, 70, 0.08, seed=8)
    C = spgemm(A, B)
    ref = (A.to_scipy() @ B.to_scipy()).tocsr()
    np.testing.assert_allclose(C.to_scipy().toarray(), ref.toarray(), rtol=1e-4, atol=1e-5)


def test_spgemm_chunked_matches_unchunked():
    from spmm_tpu.ops import spgemm_sorted

    A = webgraph_like(300, 2500, seed=3)
    big = spgemm_sorted(A, A)
    small = spgemm_sorted(A, A, max_expand_per_chunk=512)
    assert abs(big.to_scipy() - small.to_scipy()).max() < 1e-5
    # slab kernel (the production path) agrees with the global-sort path
    slab = spgemm(A, A)
    assert abs(big.to_scipy() - slab.to_scipy()).max() < 1e-5


def test_spgemm_expand_bound_exact():
    A = random_csr(30, 30, 0.1, seed=5)
    lb = np.diff(A.indptr)
    ref = int(lb[np.asarray(A.indices[: A.nnz])].sum())
    assert spgemm_expand_bound(A, A) == ref


def test_spgemm_empty():
    from spmm_tpu.formats.containers import COO, to_csr

    Z = to_csr(
        COO(
            row=np.zeros(1, np.int32),
            col=np.zeros(1, np.int32),
            data=np.zeros(1, np.float32),
            shape=(10, 10),
            nnz=0,
        )
    )
    C = spgemm(Z, Z)
    assert C.nnz == 0


def test_sddmm_matches_dense():
    import jax.numpy as jnp

    from spmm_tpu.ops.sddmm import sddmm, sddmm_values

    A = webgraph_like(120, 700, seed=9)
    rng = np.random.default_rng(9)
    U = rng.standard_normal((120, 16)).astype(np.float32)
    V = rng.standard_normal((120, 16)).astype(np.float32)
    Ad = A.pad(8).device()
    C = sddmm(Ad, jnp.asarray(U), jnp.asarray(V))
    dense = U @ V.T
    S = A.to_scipy()
    rows = np.repeat(np.arange(120), np.diff(np.asarray(A.indptr)))
    cols = np.asarray(A.indices[: A.nnz])
    ref = dense[rows, cols]
    np.testing.assert_allclose(np.asarray(C.data[: A.nnz]), ref, rtol=1e-4, atol=1e-5)
    # padding stays zero (canonical padded CSR)
    assert not np.any(np.asarray(C.data[A.nnz :]))
    # scaled variant: values multiply the samples (attention-style masking)
    C2 = sddmm(Ad, jnp.asarray(U), jnp.asarray(V), scale_by_values=True)
    np.testing.assert_allclose(
        np.asarray(C2.data[: A.nnz]), ref * np.asarray(A.data[: A.nnz]), rtol=1e-4, atol=1e-5
    )


def test_blocked_spmm_slab_view():
    """The v8-slab consumer (dense (L,8) tiles per group batch) matches the
    per-nonzero formulation and scipy, in original row order."""
    import numpy as np
    import jax.numpy as jnp

    from spmm_tpu.config import Config
    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.blocked import blocked_slab_view, blocked_spmm_slab
    from spmm_tpu.preprocess import preprocess

    A = webgraph_like(3000, 18000, seed=17)
    P = preprocess(A, Config(region_budget=1024, panel_rows=512)).device()
    view = blocked_slab_view(P)
    B = np.random.default_rng(3).standard_normal((3000, 16)).astype(np.float32)
    Y = np.asarray(blocked_spmm_slab(P, jnp.asarray(B), view))
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_spmv_auto_ell_pack_and_memoize():
    """Large host CSRs auto-pack to ELL in the spmv/spmm dispatchers (the
    raw gather+scatter CSR path pays a scalar gather and a scatter per
    nonzero) and
    the pack is built once per CSR instance."""
    import jax.numpy as jnp
    import numpy as np

    import importlib

    sp = importlib.import_module("spmm_tpu.ops.spmm")  # the module (the
    # package re-exports a same-named function that shadows attribute access)
    from spmm_tpu.formats.synthetic import webgraph_like

    A = webgraph_like(4000, 24000, seed=29)
    x = np.random.default_rng(7).standard_normal(4000).astype(np.float32)
    B = np.random.default_rng(8).standard_normal((4000, 8)).astype(np.float32)

    old_thresh = sp.AUTO_ELL_THRESHOLD
    sp.AUTO_ELL_THRESHOLD = 1000
    try:
        packs = []
        orig = sp._ell_of

        def counting(Ah):
            packs.append(1)
            return orig(Ah)

        sp._ell_of = counting
        try:
            y1 = np.asarray(sp.spmv(A, jnp.asarray(x)))
            y2 = np.asarray(sp.spmv(A, jnp.asarray(x)))
            Y = np.asarray(sp.spmm(A, jnp.asarray(B)))
        finally:
            sp._ell_of = orig
        assert len(packs) == 3  # dispatcher consulted each call...
        key = id(A)
        assert key in sp._ELL_CACHE  # ...but the pack itself is memoized
        np.testing.assert_allclose(y1, A.to_scipy() @ x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(y2, y1)
        np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)
        # device-resident CSRs auto-pack too — via ell_pack_device, so
        # nnz-scale data never crosses the host boundary (the pack's leaves
        # must come out as device arrays, not numpy)
        Ad = A.pad(8).device()
        assert sp._auto_ell(Ad)
        Ed = sp._ell_of(Ad)
        import jax

        leaves = jax.tree.leaves((Ed.data, Ed.cols))
        assert leaves and all(isinstance(l, jax.Array) for l in leaves)
    finally:
        sp.AUTO_ELL_THRESHOLD = old_thresh


def test_blocked_spmm_panel_two_stage():
    """The two-stage region-panel gather SpMM (stage the compacted RHS panel
    via gather_cols, then slot-gather — SURVEY.md §3.3's blueprint consumer)
    matches scipy in both the per-nonzero and v8-slab formulations."""
    import numpy as np
    import jax.numpy as jnp

    from spmm_tpu.config import Config
    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.blocked import (
        blocked_panel_view,
        blocked_slab_view,
        blocked_spmm_panel,
        blocked_spmm_slab,
    )
    from spmm_tpu.preprocess import preprocess

    A = webgraph_like(3000, 18000, seed=23)
    P = preprocess(A, Config(region_budget=1024, panel_rows=512)).device()
    B = np.random.default_rng(5).standard_normal((3000, 16)).astype(np.float32)
    ref = A.to_scipy() @ B

    Y = np.asarray(blocked_spmm_panel(P, jnp.asarray(B), view=blocked_panel_view(P)))
    np.testing.assert_allclose(Y, ref, rtol=1e-4, atol=1e-4)
    # no-view path
    Y2 = np.asarray(blocked_spmm_panel(P, jnp.asarray(B)))
    np.testing.assert_allclose(Y2, ref, rtol=1e-4, atol=1e-4)
    # slab (dense tile) formulation over the panel
    view = blocked_slab_view(P, panel=True)
    assert len(view) == 4
    Y3 = np.asarray(blocked_spmm_slab(P, jnp.asarray(B), view))
    np.testing.assert_allclose(Y3, ref, rtol=1e-4, atol=1e-4)


def test_blocked_chain_spmv_seq_input():
    """The self-referential seq_input contract (SURVEY.md §2.8): chained
    A^k x products through the packed format stay in final order and gather
    their per-region panels via gather_rows; matches dense chaining."""
    import numpy as np
    import jax.numpy as jnp

    from spmm_tpu.config import Config
    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.blocked import blocked_chain_spmv
    from spmm_tpu.preprocess import preprocess

    A = webgraph_like(1400, 8400, seed=27)
    P = preprocess(A, Config(region_budget=512, panel_rows=256)).device()
    x = np.random.default_rng(8).standard_normal(1400).astype(np.float32)
    y = np.asarray(blocked_chain_spmv(P, jnp.asarray(x), iters=3))
    S = A.to_scipy()
    ref = S @ (S @ (S @ x))
    np.testing.assert_allclose(y, ref, rtol=2e-3, atol=2e-3)
