import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spmm_tpu.formats.bsr import csr_to_bsr
from spmm_tpu.formats.ell import ell_pack
from spmm_tpu.formats.synthetic import banded_random, random_csr, webgraph_like
from spmm_tpu.ops.ell_spmm import ell_spmm, ell_spmv
from spmm_tpu.ops.pallas_bsr import bsr_spmm_pallas, bsr_spmm_xla


@pytest.mark.parametrize("gen,args", [
    (webgraph_like, (1500, 10000)),
    (random_csr, (800, 800, 0.01)),
    (banded_random, (600, 60, 0.3)),
])
def test_ell_spmm_matches_scipy(gen, args):
    A = gen(*args, seed=5)
    E = ell_pack(A, exact_max=8, step=8, max_len=32).device()  # force leftover CSR use
    B = np.random.default_rng(0).standard_normal((A.shape[1], 16)).astype(np.float32)
    Y = np.asarray(jax.jit(ell_spmm)(E, jnp.asarray(B)))
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_ell_spmv_matches_scipy():
    A = webgraph_like(2000, 12000, seed=6)
    E = ell_pack(A).device()
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(np.float32)
    y = np.asarray(jax.jit(ell_spmv)(E, jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-4, atol=1e-4)


def test_ell_pack_structure():
    A = webgraph_like(1000, 8000, seed=7)
    E = ell_pack(A, exact_max=4, step=4, max_len=16)
    # permutations invert
    np.testing.assert_array_equal(np.asarray(E.inv_perm)[np.asarray(E.perm)], np.arange(1000))
    # all slab widths distinct and ascending row coverage
    covered = E.n_empty + sum(d.shape[0] for d in E.data) + E.n_rest_rows
    assert covered == 1000
    # slab padding only at row tails (data zeros beyond the row length)
    lens = np.diff(A.indptr)[np.asarray(E.perm)]
    row = E.n_empty
    for d in E.data:
        R, L = d.shape
        ln = lens[row : row + R]
        for i in range(0, R, max(1, R // 5)):
            assert np.all(np.asarray(d[i, int(ln[i]) :]) == 0)
        assert ln.max() <= L
        row += R


def test_bsr_roundtrip_and_spmm():
    A = banded_random(300, 64, 0.4, seed=8)
    Ab = csr_to_bsr(A, (8, 128))
    np.testing.assert_allclose(Ab.to_dense(), A.to_scipy().toarray(), atol=1e-6)
    B = np.random.default_rng(2).standard_normal((300, 128)).astype(np.float32)
    Yx = np.asarray(bsr_spmm_xla(Ab.device(), jnp.asarray(B)))
    np.testing.assert_allclose(Yx, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)
    Yp = np.asarray(bsr_spmm_pallas(Ab.device(), jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(Yp, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


def test_bsr_empty_block_rows():
    # matrix with entirely empty row bands
    A = random_csr(512, 512, 0.002, seed=9)
    Ab = csr_to_bsr(A, (8, 128))
    B = np.random.default_rng(3).standard_normal((512, 128)).astype(np.float32)
    Yp = np.asarray(bsr_spmm_pallas(Ab.device(), jnp.asarray(B), interpret=True))
    np.testing.assert_allclose(Yp, A.to_scipy() @ B, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,k,block", [
    (300, 40, (8, 128)),  # B rows padded to the block column, k to the k tile
    (250, 16, (16, 64)),  # 16-row blocks: no in-kernel row padding
    (200, 100, (32, 32)),  # two k tiles, the second padded
    (130, 8, (8, 16)),  # k below the 16-wide dot minimum
])
def test_bsr_kernel_shapes_and_padding(n, k, block):
    """The Triton kernel (interpret mode) over block shapes and RHS widths
    that need padding, against the XLA formulation and scipy."""
    A = banded_random(n, 48, 0.3, seed=n)
    Ab = csr_to_bsr(A, block).device()
    B = np.random.default_rng(k).standard_normal((n, k)).astype(np.float32)
    ref = A.to_scipy() @ B
    Yp = np.asarray(bsr_spmm_pallas(Ab, jnp.asarray(B), interpret=True))
    assert Yp.shape == (n, k)
    np.testing.assert_allclose(Yp, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(bsr_spmm_xla(Ab, jnp.asarray(B))), ref, rtol=1e-4, atol=1e-4
    )


def test_bsr_kernel_rejects_block_shapes_it_cannot_tile():
    A = banded_random(96, 16, 0.3, seed=1)
    B = jnp.ones((96, 16), jnp.float32)
    for block in ((8, 8), (12, 128)):
        with pytest.raises(ValueError, match="block shape"):
            bsr_spmm_pallas(csr_to_bsr(A, block).device(), B, interpret=True)


def test_bsr_dispatcher_chooses_kernel_by_backend(monkeypatch):
    """ops.spmm on a BSR runs the Triton kernel on a GPU backend (for block
    shapes it takes) and the XLA formulation elsewhere."""
    import spmm_tpu.ops.pallas_bsr as pb
    from spmm_tpu.ops import spmm

    A = banded_random(200, 32, 0.3, seed=4)
    B = jnp.asarray(np.random.default_rng(4).standard_normal((200, 32)).astype(np.float32))
    calls = []
    monkeypatch.setattr(pb, "bsr_spmm_pallas", lambda *a, **k: calls.append("kernel"))
    monkeypatch.setattr(pb, "bsr_spmm_xla", lambda *a, **k: calls.append("xla"))
    spmm(csr_to_bsr(A).device(), B)
    monkeypatch.setattr(pb.jax, "default_backend", lambda: "gpu")
    spmm(csr_to_bsr(A).device(), B)
    spmm(csr_to_bsr(A, (8, 8)).device(), B)  # bn < 16: no kernel
    assert calls == ["xla", "kernel", "xla"]


def test_bsr_kernel_lowers_for_cuda():
    """The kernel lowers to Triton IR for a CUDA target (done on the host,
    no GPU needed): catches operand rules of the Triton route, such as the
    dot's 16-wide minimum, before a run on the card."""
    A = banded_random(256, 64, 0.3, seed=2)
    Ab = csr_to_bsr(A).device()
    for dt in (jnp.float32, jnp.bfloat16):
        Bs = dataclasses.replace(Ab, data=jnp.asarray(Ab.data).astype(dt))
        B = jnp.ones((256, 128), dt)
        text = (
            jax.jit(bsr_spmm_pallas).trace(Bs, B)
            .lower(lowering_platforms=("cuda",)).as_text()
        )
        assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
def test_bsr_kernel_compiled_matches_xla():
    """On the card: the compiled kernel (no interpret mode) against the XLA
    formulation and scipy, fp32 to full precision."""
    A = banded_random(4096, 256, 0.25, seed=6)
    Ab = csr_to_bsr(A).device()
    B = np.random.default_rng(6).standard_normal((4096, 128)).astype(np.float32)
    ref = A.to_scipy().astype(np.float64) @ B.astype(np.float64)
    Yp = np.asarray(jax.jit(bsr_spmm_pallas)(Ab, jnp.asarray(B)), np.float64)
    Yx = np.asarray(jax.jit(bsr_spmm_xla)(Ab, jnp.asarray(B)), np.float64)
    scale = np.abs(ref).max()
    assert np.abs(Yp - ref).max() <= 1e-4 * scale
    assert np.abs(Yx - ref).max() <= 1e-4 * scale


def test_spmm_dispatcher_formats():
    from spmm_tpu.ops import spmm

    A = webgraph_like(600, 4000, seed=10)
    B = jnp.asarray(np.random.default_rng(4).standard_normal((600, 16)).astype(np.float32))
    ref = A.to_scipy() @ np.asarray(B)
    E = ell_pack(A).device()
    np.testing.assert_allclose(np.asarray(spmm(E, B)), ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(spmm(A.pad(8).device(), B)), ref, rtol=1e-4, atol=1e-4)


def test_ell_spmm_long_rows_and_narrow_k():
    """Rows beyond the exact-length classes (einsum slab path) and k < 128
    (the lane-padding workaround) — full-precision parity vs an f64 oracle.
    Regression: a default-precision einsum may run reduced-precision passes."""
    import numpy as np
    import jax.numpy as jnp

    from spmm_tpu.formats.ell import ell_pack
    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.ell_spmm import ell_spmm

    A = webgraph_like(4000, 26000, seed=7)
    lens = np.diff(np.asarray(A.indptr))
    assert lens.max() > 64, "fixture must exercise the einsum slab path"
    E = ell_pack(A).device()
    S = A.to_scipy().astype(np.float64)
    # 8/32: reshape-select narrow path; 20: pad-to-pow2 then narrow; 128: wide
    for k in (8, 20, 32, 128):
        B = np.random.default_rng(k).standard_normal((4000, k)).astype(np.float32)
        Y = np.asarray(ell_spmm(E, jnp.asarray(B)))
        ref = S @ B.astype(np.float64)
        np.testing.assert_allclose(Y, ref, rtol=2e-4, atol=2e-4)


def test_bsr_spmv_fp32_fp64_parity():
    """Block-compressed SpMV, fp32/fp64 tolerance parity."""
    import numpy as np
    import jax.numpy as jnp

    from spmm_tpu.formats.bsr import csr_to_bsr
    from spmm_tpu.formats.synthetic import banded_random
    from spmm_tpu.ops.pallas_bsr import bsr_spmv

    A = banded_random(600, 96, 0.35, seed=11)
    S64 = A.to_scipy().astype(np.float64)
    x = np.random.default_rng(5).standard_normal(600)

    Bs32 = csr_to_bsr(A, (8, 128)).device()
    y32 = np.asarray(bsr_spmv(Bs32, jnp.asarray(x.astype(np.float32))))
    np.testing.assert_allclose(y32, S64 @ x, rtol=1e-4, atol=1e-4)

    import dataclasses
    import jax

    if jax.config.read("jax_enable_x64"):
        A64 = dataclasses.replace(A, data=np.asarray(A.data, np.float64))
        Bs64 = csr_to_bsr(A64, (8, 128))
        y64 = np.asarray(bsr_spmv(Bs64, jnp.asarray(x)))
        np.testing.assert_allclose(y64, S64 @ x, rtol=1e-12, atol=1e-12)


def test_ell_spmm_wide_k():
    """k > 128 (multiple of the lane tile) through the wide path."""
    A = webgraph_like(1200, 8000, seed=25)
    E = ell_pack(A).device()
    B = np.random.default_rng(7).standard_normal((1200, 256)).astype(np.float32)
    Y = np.asarray(ell_spmm(E, jnp.asarray(B)))
    np.testing.assert_allclose(Y, A.to_scipy() @ B, rtol=2e-4, atol=2e-4)


def test_bf16_operands_supported():
    """bf16 RHS/values are first-class: kernels gather in the storage dtype
    and accumulate fp32 (``accum_dtype``), so bf16 operands halve operand HBM
    footprint at ~1e-3 relative error.  The BSR kernel multiplies bf16
    blocks with an fp32 accumulator."""
    import dataclasses

    A = webgraph_like(1200, 9000, seed=12)
    S = A.to_scipy()
    E = ell_pack(A).device()
    B = np.random.default_rng(6).standard_normal((1200, 128)).astype(np.float32)
    ref = S @ B
    scale = np.abs(ref).max()
    Y = np.asarray(ell_spmm(E, jnp.asarray(B).astype(jnp.bfloat16))).astype(np.float32)
    assert Y.dtype == np.float32  # accumulated fp32
    assert np.abs(Y - ref).max() / scale < 2e-2

    Ab = banded_random(304, 64, 0.4, seed=13)
    Bs = csr_to_bsr(Ab, (8, 128)).device()
    Bs16 = dataclasses.replace(Bs, data=jnp.asarray(Bs.data).astype(jnp.bfloat16))
    Bd = np.random.default_rng(7).standard_normal((304, 128)).astype(np.float32)
    refb = Ab.to_scipy() @ Bd
    Yb = np.asarray(
        bsr_spmm_pallas(Bs16, jnp.asarray(Bd).astype(jnp.bfloat16), interpret=True)
    )
    assert Yb.dtype == np.float32  # preferred_element_type accumulation
    assert np.abs(Yb - refb).max() / max(np.abs(refb).max(), 1e-9) < 2e-2


def test_ell_pack_device_matches_host():
    """ell_pack_device on a device-resident CSR: same multiply results as
    the host pack (incl. the leftover-CSR path), only the (nrow+1,) indptr
    crosses to host."""
    from spmm_tpu.formats.ell import ell_pack_device

    A = webgraph_like(1200, 9600, seed=21)
    Ad = A.device()
    # small max_len forces leftover rows so the rest-gather path is covered
    E1 = ell_pack(A, max_len=64).device()
    E2 = ell_pack_device(Ad, max_len=64)
    assert E2.n_rest_rows == E1.n_rest_rows > 0
    assert E2.padded_nnz == E1.padded_nnz
    B = jnp.asarray(
        np.random.default_rng(0).standard_normal((1200, 16)).astype(np.float32)
    )
    y1 = np.asarray(ell_spmm(E1, B))
    y2 = np.asarray(ell_spmm(E2, B))
    np.testing.assert_allclose(y1, y2, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y2, A.to_scipy() @ np.asarray(B), rtol=1e-4, atol=1e-4)


def test_spgemm_output_chains_to_ell_spmv(monkeypatch):
    """Full device chain: C = A@A (device CSR, spgemm_slab_csr) -> the
    spmv dispatcher auto-packs C via ell_pack_device — the HOST pack must
    never run (no nnz-scale D2H) — and the result matches scipy."""
    import importlib

    import spmm_tpu.formats.ell as ell_mod
    from spmm_tpu.ops.slab_spgemm import spgemm_slab_csr

    # ops.__init__ rebinds the name `spmm` to the function; fetch the module
    spmm_mod = importlib.import_module("spmm_tpu.ops.spmm")

    A = webgraph_like(900, 5400, seed=22)
    Cd = spgemm_slab_csr(A, A)
    assert not isinstance(Cd.data, np.ndarray)  # device-resident

    def boom(*a, **k):
        raise AssertionError("host ell_pack must not run on a device CSR")

    monkeypatch.setattr(ell_mod, "ell_pack", boom)
    monkeypatch.setattr(spmm_mod, "AUTO_ELL_THRESHOLD", 1)
    x = jnp.asarray(
        np.random.default_rng(1).standard_normal(900).astype(np.float32)
    )
    y = np.asarray(spmm_mod.spmv(Cd, x))
    ref_C = (A.to_scipy() @ A.to_scipy()).tocsr()
    np.testing.assert_allclose(y, ref_C @ np.asarray(x), rtol=1e-4, atol=1e-4)
