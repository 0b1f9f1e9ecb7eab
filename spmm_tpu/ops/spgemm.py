"""SpGEMM — sparse × sparse (general A·B; A·A is the reference workload).

The reference only *prepares* matrices for this product and implies the
A_pattern × A_pattern ground truth (SURVEY.md §3.3-3.4).  Design:
the classic two-phase expand/sort/merge ESC algorithm recast onto XLA's
strengths — one big gather (expansion), one big multi-key ``lax.sort``, one
segment-sum (merge).  All shapes static: the exact expansion size is computed
host-side (O(nnz), cheap) and passed as a static pad bound, following the
reference's own trick of turning a dynamic working set into a static budget
(transmat.h:339).

Row-chunked driver bounds peak memory for huge products.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spmm_tpu.formats.containers import COO, CSR, to_csr

_INVALID = np.int32(np.iinfo(np.int32).max)


def spgemm_expand_bound(A: CSR, B: CSR) -> int:
    """Exact number of partial products  Σ_{(i,j)∈A} nnz(B row j)  — the ESC
    expansion size (= FLOPs/2 of the product)."""
    Ah, Bh = A.host(), B.host()
    lb = np.asarray(Bh.indptr[1:], dtype=np.int64) - np.asarray(Bh.indptr[:-1], dtype=np.int64)
    return int(lb[np.asarray(Ah.indices[: A.nnz], dtype=np.int64)].sum())


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _bucket(x: int, floor: int = 1024) -> int:
    """Round up to a power of two so jit compiles are shared across chunks and
    matrices (XLA sort compiles are expensive; one cache entry per bucket)."""
    b = floor
    while b < x:
        b <<= 1
    return b


def spgemm_coo_padded(
    A: CSR, B: CSR, expand_size: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Jittable ESC SpGEMM with a static expansion bound.

    Returns ``(rows, cols, vals, out_nnz)`` where the arrays have static
    length ``expand_size``; entries at positions ``>= out_nnz`` are zero
    padding.  ``expand_size`` must be >= spgemm_expand_bound(A, B).
    """
    m, _ = A.shape
    _, n = B.shape
    a_ind = jnp.asarray(A.indices)
    a_dat = jnp.asarray(A.data)
    b_indptr = jnp.asarray(B.indptr)
    b_ind = jnp.asarray(B.indices)
    b_dat = jnp.asarray(B.data)

    # ---- expand: one slot per partial product --------------------------------
    from spmm_tpu.ops.segments import boundary_segments

    pos = jnp.arange(A.nnz_pad, dtype=jnp.int32)
    a_rows = boundary_segments(jnp.asarray(A.indptr), A.nnz_pad)
    lb = b_indptr[1:] - b_indptr[:-1]
    counts = jnp.where(pos < A.nnz, lb[jnp.clip(a_ind, 0, B.shape[0] - 1)], 0)
    offsets = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)])
    total = offsets[-1]

    e = jnp.arange(expand_size, dtype=jnp.int32)
    src = boundary_segments(offsets, expand_size)
    valid = e < total
    j = jnp.clip(a_ind[src], 0, B.shape[0] - 1)
    t = e - offsets[src].astype(jnp.int32)
    bidx = jnp.clip(b_indptr[j] + t, 0, B.nnz_pad - 1)
    out_row = jnp.where(valid, a_rows[src], _INVALID)
    out_col = jnp.where(valid, b_ind[bidx], _INVALID)
    out_val = jnp.where(valid, a_dat[src] * b_dat[bidx], 0)

    # ---- sort by (row, col), merge duplicates ---------------------------------
    rs, cs, vs = jax.lax.sort((out_row, out_col, out_val), num_keys=2)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (rs[1:] != rs[:-1]) | (cs[1:] != cs[:-1])]
    )
    seg = jnp.cumsum(first) - 1
    vals = jax.ops.segment_sum(vs, seg, num_segments=expand_size)
    rows = jnp.zeros((expand_size,), jnp.int32).at[seg].set(rs, mode="drop")
    cols = jnp.zeros((expand_size,), jnp.int32).at[seg].set(cs, mode="drop")
    out_nnz = jnp.sum(first & (rs != _INVALID)).astype(jnp.int32)
    # scrub the invalid segment (all-invalid keys merge into one slot at out_nnz)
    slot = jnp.arange(expand_size, dtype=jnp.int32)
    keep = slot < out_nnz
    rows = jnp.where(keep, rows, 0)
    cols = jnp.where(keep, cols, 0)
    vals = jnp.where(keep, vals, 0)
    return rows, cols, vals, out_nnz


_ESC_JIT = None


def _jitted_esc():
    """Module-cached jit of the ESC kernel so repeated spgemm() calls with the
    same static buckets reuse compiles (large XLA sort programs compile
    slowly)."""
    global _ESC_JIT
    if _ESC_JIT is None:
        _ESC_JIT = jax.jit(spgemm_coo_padded, static_argnames=("expand_size",))
    return _ESC_JIT


def spgemm(
    A: CSR,
    B: CSR,
    *,
    max_expand_per_chunk: int = 64 * 1024 * 1024,
    as_csr: bool = True,
):
    """Global-sort ESC driver: exact expansion sizing, row-chunking for
    memory, device ESC per chunk, host concatenation.  Returns CSR (or COO).

    This is the fallback/oracle path (and the heavy-tail row handler for the
    production slab kernel, ops/slab_spgemm.py): one global ``lax.sort``
    over every partial product instead of the slab kernel's batched
    minor-axis sorts."""
    if A.nnz == 0 or B.nnz == 0:
        out = COO(
            row=np.zeros(0, np.int32),
            col=np.zeros(0, np.int32),
            data=np.zeros(0, np.float32),
            shape=(A.nrow, B.ncol),
            nnz=0,
        )
        return to_csr(out) if as_csr else out
    Ah = A.host()
    lbB = np.asarray(B.host().indptr, dtype=np.int64)
    lb = lbB[1:] - lbB[:-1]
    a_ind = np.asarray(Ah.indices[: A.nnz], dtype=np.int64)
    per_nnz = lb[a_ind]
    indptr = np.asarray(Ah.indptr, dtype=np.int64)
    # expansion prefix per row boundary: exp_prefix[i] = partial products of rows < i
    row_ids = np.searchsorted(indptr, np.arange(A.nnz, dtype=np.int64), side="right") - 1
    row_exp = np.zeros(A.nrow, dtype=np.int64)
    np.add.at(row_exp, row_ids, per_nnz)
    exp_prefix = np.zeros(A.nrow + 1, dtype=np.int64)
    np.cumsum(row_exp, out=exp_prefix[1:])

    # choose row chunk boundaries so each chunk's expansion fits the budget
    cuts = [0]
    while cuts[-1] < A.nrow:
        start = cuts[-1]
        target = exp_prefix[start] + max_expand_per_chunk
        end = int(np.searchsorted(exp_prefix, target, side="right")) - 1
        end = max(end, start + 1)
        cuts.append(min(end, A.nrow))
    Bd = B.pad(8).device()

    rows_all, cols_all, vals_all = [], [], []
    jitted = _jitted_esc()
    # uniform static shapes across chunks so XLA compiles once per bucket
    max_rows = max(t - s for s, t in zip(cuts[:-1], cuts[1:]))
    row_pad = _bucket(max_rows, 256)
    max_nnz = max(int(Ah.indptr[t]) - int(Ah.indptr[s]) for s, t in zip(cuts[:-1], cuts[1:]))
    nnz_pad = _bucket(max_nnz, 256)
    for s, t in zip(cuts[:-1], cuts[1:]):
        sub_indptr = np.asarray(Ah.indptr[s : t + 1], dtype=np.int64)
        lo, hi = int(sub_indptr[0]), int(sub_indptr[-1])
        indptr_p = np.full(row_pad + 1, hi - lo, dtype=np.int32)
        indptr_p[: t - s + 1] = (sub_indptr - lo).astype(np.int32)
        data_p = np.zeros(nnz_pad, dtype=np.asarray(Ah.data).dtype)
        data_p[: hi - lo] = np.asarray(Ah.data[lo:hi])
        ind_p = np.zeros(nnz_pad, dtype=np.int32)
        ind_p[: hi - lo] = np.asarray(Ah.indices[lo:hi], dtype=np.int32)
        sub = CSR(data=data_p, indices=ind_p, indptr=indptr_p,
                  shape=(row_pad, A.ncol), nnz=hi - lo)
        bound = int(exp_prefix[t] - exp_prefix[s])
        r, c, v, k = jitted(sub.device(), Bd, expand_size=_bucket(bound))
        k = int(k)
        rows_all.append(np.asarray(r[:k]) + s)
        cols_all.append(np.asarray(c[:k]))
        vals_all.append(np.asarray(v[:k]))

    rows = np.concatenate(rows_all) if rows_all else np.zeros(0, np.int32)
    cols = np.concatenate(cols_all) if cols_all else np.zeros(0, np.int32)
    vals = np.concatenate(vals_all) if vals_all else np.zeros(0, np.float32)
    out = COO(
        row=rows.astype(np.int32),
        col=cols.astype(np.int32),
        data=vals,
        shape=(A.nrow, B.ncol),
        nnz=int(len(rows)),
    )
    if as_csr:
        # already row-major sorted with unique keys; direct CSR assembly
        return to_csr(out, sort_within_row=False, sum_duplicates=False)
    return out


#: explicit name for the global-sort path (ops/__init__ rebinds ``spgemm``
#: to the slab kernel)
spgemm_sorted = spgemm
