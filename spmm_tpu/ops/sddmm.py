"""SDDMM — sampled dense-dense matrix multiplication.

``C[i, j] = alpha * (U @ V^T)[i, j]`` for ``(i, j)`` in A's sparsity pattern
(optionally scaled by A's values).  The companion op to SpMM in sparse
frameworks (graph attention scores, low-rank residual sampling); the
reference has no compute ops at all, so this rounds out the kernel surface.

Shape: two aligned row gathers (U rows by nonzero row id, V rows by
column id) and an elementwise dot per nonzero.  No scatters; output values land in CSR nonzero order.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from spmm_tpu.formats.containers import CSR


def sddmm_values(A: CSR, U: jax.Array, V: jax.Array, *, accum_dtype=jnp.float32) -> jax.Array:
    """Per-nonzero values ``(U @ V^T)[row_e, col_e]`` (length = padded nnz;
    padding positions carry garbage samples — the row id saturates at the
    last row — so mask them or slice to A.nnz).  Jittable; rows derived on
    device from indptr."""
    from spmm_tpu.ops.segments import boundary_segments

    nnz_pad = jnp.asarray(A.indices).shape[0]
    rows = boundary_segments(jnp.asarray(A.indptr), nnz_pad)
    u = jnp.take(U, rows, axis=0).astype(accum_dtype)
    v = jnp.take(V, jnp.asarray(A.indices), axis=0).astype(accum_dtype)
    return jnp.sum(u * v, axis=1)


def sddmm(A: CSR, U: jax.Array, V: jax.Array, *, scale_by_values: bool = False) -> CSR:
    """CSR with A's pattern and SDDMM values (optionally ``A.data *`` them)."""
    vals = sddmm_values(A, U, V)
    if scale_by_values:
        vals = vals * jnp.asarray(A.data)
    else:
        # zero the padding tail so padded CSRs stay canonical
        nnz_pad = vals.shape[0]
        vals = jnp.where(jnp.arange(nnz_pad) < A.nnz, vals, 0)
    return dataclasses.replace(A, data=vals)
