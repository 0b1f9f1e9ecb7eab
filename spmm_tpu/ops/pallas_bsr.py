"""BSR SpMM and SpMV — dense-block products.

The block-sparse kernel the reference format points at (SURVEY.md §3.3):
dense (bm, bn) blocks multiplied against (bn, k) RHS tiles.

``bsr_spmm_pallas`` is a Pallas kernel on the Triton route: one program per
(block row, k tile) walks its block row through ``block_indptr``, loads each
A block and the B tile its block column selects, accumulates the product in
registers and writes its Y tile once.  HBM traffic is A once, the B tiles
(mostly L2 hits: B is a few tens of MB), and Y once.

``bsr_spmm_xla`` is the plain formulation: gather the B tiles, batched
block products, segment-sum over block rows.  It writes and re-reads two
intermediates of nblocks·(bn + bm)·k elements, which the kernel never
materializes.  It is the reference the kernel is tested against and the
path on backends without Triton.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from spmm_tpu.formats.bsr import BSR


#: k columns per program, warps per program, and software-pipeline stages.
#: Chosen on an H100 at the bench shape (PERF.md): 64/4/2 was within the
#: run-to-run spread of the best of the variants timed, and 32-wide tiles or
#: 8 warps were slower.
K_TILE = 64
NUM_WARPS = 4
NUM_STAGES = 2


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _kernel(indptr_ref, cols_ref, a_ref, b_ref, o_ref, *, bm, bn, bm_pad, k_tile,
            precision):
    i = pl.program_id(0)
    j = pl.program_id(1)
    # pl.dot needs >= 16 rows: blocks shorter than that are padded inside
    # the kernel by re-reading their last row and zeroing the copies
    r = jnp.arange(bm_pad, dtype=jnp.int32)
    live = r < bm
    rsel = jnp.minimum(r, bm - 1)

    def body(b, acc):
        a = a_ref[b * bm + rsel, :]
        a = jnp.where(live[:, None], a, jnp.zeros_like(a))
        bt = b_ref[pl.ds(cols_ref[b] * bn, bn), pl.ds(j * k_tile, k_tile)]
        return acc + pl.dot(a, bt, precision=precision)

    acc = jax.lax.fori_loop(
        indptr_ref[i], indptr_ref[i + 1], body,
        jnp.zeros((bm_pad, k_tile), jnp.float32),
    )
    plgpu.store(
        o_ref.at[pl.ds(i * bm, bm_pad), pl.ds(j * k_tile, k_tile)],
        acc,
        mask=jnp.broadcast_to(live[:, None], (bm_pad, k_tile)),
    )


def _pad_rhs(B: jax.Array, n_pad: int, k_pad: int) -> jax.Array:
    n, k = B.shape
    if (n, k) != (n_pad, k_pad):
        B = jnp.pad(B, ((0, n_pad - n), (0, k_pad - k)))
    return B


@functools.partial(jax.jit, static_argnames=("interpret",))
def bsr_spmm_pallas(A: BSR, B: jax.Array, *, interpret: bool = False) -> jax.Array:
    """Y[m, k] = A_bsr @ B[n, k] through the Triton-route kernel.

    Block dimensions must be powers of two with bn >= 16 (the dot's
    operand rule); blocks under 16 rows are padded in-kernel.  B is
    zero-padded to the block-column multiple and to a multiple of the k
    tile.  fp32 operands multiply in full fp32 (no TF32); bf16 operands
    accumulate in fp32."""
    bm, bn = A.block_shape
    if not (_pow2(bm) and _pow2(bn) and bn >= 16):
        raise ValueError(f"block shape {A.block_shape}: need powers of two, bn >= 16")
    m, n = A.shape
    k = B.shape[-1]
    k_tile = min(K_TILE, max(16, 1 << (k - 1).bit_length()))
    k_pad = -(-k // k_tile) * k_tile
    B = _pad_rhs(B, -(-n // bn) * bn, k_pad)
    bm_pad = max(bm, 16)
    data = jnp.asarray(A.data).reshape(A.nblocks * bm, bn)
    if data.dtype != B.dtype:
        dt = jnp.promote_types(data.dtype, B.dtype)
        data, B = data.astype(dt), B.astype(dt)
    precision = jax.lax.Precision.HIGHEST if data.dtype == jnp.float32 else None
    kern = functools.partial(
        _kernel, bm=bm, bn=bn, bm_pad=bm_pad, k_tile=k_tile, precision=precision
    )
    out = pl.pallas_call(
        kern,
        grid=(A.nbrows, k_pad // k_tile),
        # bm_pad - bm spare rows keep the last block row's padded store in bounds
        out_shape=jax.ShapeDtypeStruct((A.nbrows * bm + bm_pad - bm, k_pad), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        cost_estimate=pl.CostEstimate(
            flops=2 * A.nblocks * bm * bn * k_pad,
            bytes_accessed=(A.nblocks * bm * bn + B.size + A.nbrows * bm * k_pad)
            * data.dtype.itemsize,
            transcendentals=0,
        ),
        interpret=interpret,
        name="bsr_spmm",
    )(jnp.asarray(A.block_indptr), jnp.asarray(A.block_cols), data, B)
    return out[:m, :k]


def bsr_spmm(A: BSR, B: jax.Array) -> jax.Array:
    """SpMM on a BSR operand: the Triton kernel on a GPU backend for block
    shapes it takes, the XLA formulation otherwise."""
    bm, bn = A.block_shape
    if jax.default_backend() == "gpu" and _pow2(bm) and _pow2(bn) and bn >= 16:
        return bsr_spmm_pallas(A, B)
    return bsr_spmm_xla(A, B)


@functools.partial(jax.jit, static_argnames=("accum_dtype",))
def bsr_spmv(A: BSR, x: jax.Array, *, accum_dtype=None) -> jax.Array:
    """y[m] = A_bsr @ x[n] (block-compressed SpMV).

    One aligned (nblocks, bn) row gather of x tiles + per-block dense
    matvecs + a block-row segment sum — the BSR recast of the dense-block
    partial-product contract (SURVEY.md §3.3).  fp64 inputs accumulate in
    fp64 (CPU/x64 parity tests); fp32 in fp32."""
    bm, bn = A.block_shape
    m, n = A.shape
    n_pad = (n + bn - 1) // bn * bn
    if x.shape[0] != n_pad:
        x = jnp.concatenate([x, jnp.zeros((n_pad - x.shape[0],), x.dtype)])
    acc = accum_dtype or jnp.result_type(jnp.asarray(A.data).dtype, jnp.float32)
    xt = x.reshape(n_pad // bn, bn)
    gx = jnp.take(xt, jnp.asarray(A.block_cols), axis=0)  # (nblocks, bn)
    prods = jnp.einsum(
        "bij,bj->bi",
        jnp.asarray(A.data).astype(acc),
        gx.astype(acc),
        precision=jax.lax.Precision.HIGHEST,
    )
    y = jax.ops.segment_sum(
        prods, jnp.asarray(A.block_rows), num_segments=A.nbrows, indices_are_sorted=True
    )
    return y.reshape(A.nbrows * bm)[:m]


@jax.jit
def bsr_spmm_xla(A: BSR, B: jax.Array) -> jax.Array:
    """Plain XLA formulation (reference for the kernel)."""
    bm, bn = A.block_shape
    m, n = A.shape
    k = B.shape[-1]
    n_pad = (n + bn - 1) // bn * bn
    if B.shape[0] != n_pad:
        B = jnp.concatenate([B, jnp.zeros((n_pad - B.shape[0], k), B.dtype)], axis=0)
    Bt = B.reshape(n_pad // bn, bn, k)
    btiles = jnp.take(Bt, jnp.asarray(A.block_cols), axis=0)  # (nblocks, bn, k)
    acc = jnp.result_type(jnp.asarray(A.data).dtype, jnp.float32)
    prods = jnp.einsum(
        "bij,bjk->bik", jnp.asarray(A.data), btiles, preferred_element_type=acc,
        precision=jax.lax.Precision.HIGHEST,
    )
    y = jax.ops.segment_sum(
        prods, jnp.asarray(A.block_rows), num_segments=A.nbrows, indices_are_sorted=True
    )
    return y.reshape(A.nbrows * bm, k)[:m]
