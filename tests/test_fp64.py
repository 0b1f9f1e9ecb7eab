"""fp64 tolerance parity (SURVEY.md §7 'fp64 parity').

fp64 runs live on the CPU backend here (these
tests, per conftest) with ``jax.enable_x64`` — fp32 remains the
performance dtype.  Tolerances here are at fp64 machine-epsilon scale, far
tighter than the fp32 kernels' 1e-5.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
import jax.numpy as jnp

from spmm_tpu.formats.containers import CSR


def _random64(m, n, d, seed):
    A = sp.random(m, n, density=d, random_state=seed, format="csr", dtype=np.float64)
    A.data[:] = np.random.default_rng(seed).standard_normal(len(A.data))
    return A


def test_spmm_fp64_parity():
    with jax.enable_x64():
        A = _random64(120, 90, 0.05, 0)
        Ac = CSR.from_scipy(A)
        B = np.random.default_rng(1).standard_normal((90, 16))
        from spmm_tpu.ops import spmm_xla

        Y = np.asarray(spmm_xla(Ac.pad(8).device(), jnp.asarray(B), accum_dtype=jnp.float64))
        assert Y.dtype == np.float64
        np.testing.assert_allclose(Y, A @ B, rtol=1e-13, atol=1e-13)


def test_spgemm_fp64_parity():
    with jax.enable_x64():
        A = _random64(150, 150, 0.04, 2)
        Ac = CSR.from_scipy(A)
        from spmm_tpu.ops.slab_spgemm import spgemm_slab

        C = spgemm_slab(Ac, Ac, accum_dtype=jnp.float64)
        ref = (A @ A).tocsr()
        ref.sum_duplicates()
        ref.sort_indices()
        assert np.array_equal(np.asarray(C.indices[: C.nnz]), ref.indices)
        assert np.asarray(C.data).dtype == np.float64
        np.testing.assert_allclose(np.asarray(C.data[: C.nnz]), ref.data, rtol=1e-12, atol=1e-14)


def test_bsr_fp64_parity():
    with jax.enable_x64():
        from spmm_tpu.formats.bsr import csr_to_bsr
        from spmm_tpu.formats.synthetic import banded_random
        from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla

        A = banded_random(128, 32, 0.4, seed=3, dtype=np.float64)
        Bsr = csr_to_bsr(A, (8, 128))
        B = np.random.default_rng(4).standard_normal((A.shape[1], 8))
        Y = np.asarray(bsr_spmm_xla(Bsr.device(), jnp.asarray(B)))
        ref = A.to_scipy() @ B
        np.testing.assert_allclose(Y, ref, rtol=1e-12, atol=1e-12)


def test_mtx_real_values_fp64_roundtrip(tmp_path):
    """Real-valued .mtx ingest preserves fp64 values exactly (the reference
    DISCARDS values — serial_newblock_clock.cpp:84,96; we keep both modes)."""
    from spmm_tpu.formats.containers import to_coo
    from spmm_tpu.formats.mtx import read_mtx, write_mtx

    rng = np.random.default_rng(5)
    A = _random64(40, 30, 0.1, 6)
    from spmm_tpu.formats.containers import CSR

    p = tmp_path / "t.mtx"
    write_mtx(str(p), to_coo(CSR.from_scipy(A)), pattern=False)
    M = read_mtx(str(p), values="native", dtype=np.float64)
    from spmm_tpu.formats.containers import to_csr

    A2 = to_csr(M, sort_within_row=True, sum_duplicates=True).to_scipy()
    assert (abs(A2 - A) > 1e-12 * abs(A)).nnz == 0
