"""ELLPACK / SELL format — scatter-free SpMM.

A segment-sum row reduction is a scatter, and XLA's scatters are slow next to
dense reductions.  Sorting rows by length and
padding each power-of-two length class to a dense (R, L) slab turns the row
reduction into a dense axis-1 sum — no scatter at all; one (m, k) gather
un-permutes the output.  This is the dense-slab version of the reference's
panel length sort (v8sort.h:152-232): same sort, but the payoff is cast as
dense-slab vectorization instead of SIMD v8 groups.

Row layout in sorted order: [empty rows][slab 0][slab 1]...[leftover rows],
where slab b holds all rows of its power-of-two length class and leftover
rows (length > max_len) form a padded CSR handled by the segment-sum path.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import numpy as np

from spmm_tpu.formats.containers import CSR

Array = object


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    #: per-class dense slabs: data[b] is (R_b, L_b)
    data: tuple  # tuple of float arrays
    cols: tuple  # tuple of int32 arrays, same shapes
    #: leftover long rows as a padded CSR (0 logical rows when none)
    rest: CSR
    #: sorted_pos -> original row
    perm: Array
    inv_perm: Array
    shape: Tuple[int, int] = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    n_empty: int = dataclasses.field(metadata=dict(static=True))
    n_rest_rows: int = dataclasses.field(metadata=dict(static=True))

    def device(self) -> "ELL":
        import jax.numpy as jnp

        return jax.tree.map(jnp.asarray, self)

    @property
    def padded_nnz(self) -> int:
        return int(sum(d.shape[0] * d.shape[1] for d in self.data)) + int(self.rest.nnz)


def _length_class(lens: np.ndarray, exact_max: int, step: int, max_len: int) -> np.ndarray:
    """Slab width per row: exact lengths up to ``exact_max`` (zero padding),
    multiples of ``step`` up to ``max_len`` (≤ step-1 padding per row), and
    ``max_len + 1`` marking leftover rows."""
    cls = np.where(lens <= exact_max, lens, ((lens + step - 1) // step) * step)
    return np.where(cls > max_len, max_len + 1, cls)


def _slab_plan(lens: np.ndarray, exact_max: int, step: int, max_len: int):
    """Host planning (all nrow-scale): length-sorted permutation, the
    [empty][slabs...][leftover] layout, and per-slab row ranges.
    Returns (perm, n_empty, slabs=[(L, lo, hi), ...], lo_rest)."""
    m = len(lens)
    cls = _length_class(lens, exact_max, step, max_len)
    # STABLE sort by class alone: rows within a slab share the width L, so
    # within-class order is layout-irrelevant (the mask fill padded short
    # rows either way) — the native O(n) counting sort replaces the ~100 ms
    # nrow-scale lexsort at web-Google scale
    perm = None
    try:
        from spmm_tpu import native

        perm = native.counting_argsort_i32(cls.astype(np.int32), max_len + 2)
        if perm is not None:
            perm = perm.astype(np.int64)
    except Exception:
        perm = None
    if perm is None:
        perm = np.lexsort((np.arange(m), lens, cls))
    cls_s = cls[perm]
    n_empty = int(np.searchsorted(cls_s, 0, side="right"))
    slabs = []
    for L in np.unique(cls_s):
        if L == 0 or L > max_len:
            continue
        lo = int(np.searchsorted(cls_s, L, side="left"))
        hi = int(np.searchsorted(cls_s, L, side="right"))
        slabs.append((int(L), lo, hi))
    lo_rest = int(np.searchsorted(cls_s, max_len + 1, side="left"))
    return perm, n_empty, slabs, lo_rest


def ell_pack(A: CSR, *, exact_max: int = 64, step: int = 32, max_len: int = 2048) -> ELL:
    """Host packing: sort rows by slab width; one dense slab per distinct
    width (padding factor ~1.1 on power-law graphs); rows longer than
    ``max_len`` go to the leftover CSR."""
    h = A.host()
    m, n = A.shape
    lens = np.asarray(h.row_lengths(), dtype=np.int64)
    indptr = np.asarray(h.indptr, dtype=np.int64)
    indices32 = np.ascontiguousarray(h.indices[: A.nnz], dtype=np.int32)
    dat = np.ascontiguousarray(h.data[: A.nnz])

    perm, n_empty, slabs, lo_rest = _slab_plan(lens, exact_max, step, max_len)

    try:
        from spmm_tpu import native

        use_native = native.available()
    except Exception:
        use_native = False

    data_slabs, col_slabs = [], []
    indices = None  # int64 view built lazily, numpy fallback only
    for L, lo, hi in slabs:
        R = hi - lo
        rows_here = perm[lo:hi]
        ptr = np.ascontiguousarray(indptr[rows_here])
        ln = np.ascontiguousarray(lens[rows_here])
        if use_native:
            # single memcpy/memset pass per row (native/preprocess.cpp) —
            # the numpy mask path below costs ~5 nnz-scale passes
            slab_d = np.empty((R, L), dtype=dat.dtype)
            slab_c = np.empty((R, L), dtype=np.int32)
            if native.ell_fill_slab(dat, indices32, ptr, ln, slab_d, slab_c):
                data_slabs.append(slab_d)
                col_slabs.append(slab_c)
                continue
            use_native = False  # library vanished mid-loop: fall back
        if indices is None:
            indices = indices32.astype(np.int64)
        slab_d = np.zeros((R, L), dtype=dat.dtype)
        slab_c = np.zeros((R, L), dtype=np.int64)
        pos = np.arange(L)
        mask = pos[None, :] < ln[:, None]
        src = (ptr[:, None] + pos[None, :])[mask]
        slab_d[mask] = dat[src]
        slab_c[mask] = indices[src]
        data_slabs.append(slab_d)
        col_slabs.append(slab_c.astype(np.int32))

    # leftover long rows -> padded CSR in sorted order
    rest_rows = perm[lo_rest:]
    n_rest = len(rest_rows)
    if n_rest:
        ln = lens[rest_rows]
        rest_indptr = np.zeros(n_rest + 1, dtype=np.int64)
        np.cumsum(ln, out=rest_indptr[1:])
        pos = np.arange(int(rest_indptr[-1]), dtype=np.int64)
        r_of = np.repeat(np.arange(n_rest, dtype=np.int64), ln)
        src = indptr[rest_rows][r_of] + (pos - rest_indptr[r_of])
        rest = CSR(
            data=dat[src],
            indices=indices32[src],
            indptr=rest_indptr.astype(np.int32),
            shape=(n_rest, n),
            nnz=int(rest_indptr[-1]),
        ).pad(8)
    else:
        rest = CSR(
            data=np.zeros(1, dat.dtype),
            indices=np.zeros(1, np.int32),
            indptr=np.zeros(2, np.int32),
            shape=(1, n),
            nnz=0,
        )

    inv = np.empty(m, dtype=np.int64)
    inv[perm] = np.arange(m)
    return ELL(
        data=tuple(data_slabs),
        cols=tuple(col_slabs),
        rest=rest,
        perm=perm.astype(np.int32),
        inv_perm=inv.astype(np.int32),
        shape=(m, n),
        nnz=A.nnz,
        n_empty=n_empty,
        n_rest_rows=n_rest,
    )


# ---------------------------------------------------------------------------
# device packing — for device-resident CSRs (e.g. SpGEMM outputs)
# ---------------------------------------------------------------------------
import functools as _functools


@_functools.partial(jax.jit, static_argnames=("shapes",))
def _ell_gather_dev(indices, data, ptrs, lns, *, shapes):
    """All slab gathers in ONE compiled program: slab (R, L) reads row r's
    nonzeros at indices[ptr[r] : ptr[r]+L], masked past the row length."""
    import jax.numpy as jnp

    cols_t, data_t = [], []
    for (R, L), ptr, ln in zip(shapes, ptrs, lns):
        pos = jnp.arange(L, dtype=jnp.int32)
        mask = pos[None, :] < ln[:, None]
        src = jnp.where(mask, ptr[:, None] + pos[None, :], 0)
        cols_t.append(jnp.where(mask, indices[src], 0).astype(jnp.int32))
        data_t.append(jnp.where(mask, data[src], jnp.zeros((), data.dtype)))
    return tuple(cols_t), tuple(data_t)


@_functools.partial(jax.jit, static_argnames=("nnz_pad",))
def _rest_gather_dev(indices, data, row_ptr, rest_indptr, *, nnz_pad):
    """Leftover-row CSR gather: destination position -> source nonzero via
    searchsorted over the (small) leftover indptr — no nnz-scale host work."""
    import jax.numpy as jnp

    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    r_of = jnp.clip(
        jnp.searchsorted(rest_indptr, pos, side="right") - 1,
        0, row_ptr.shape[0] - 1,
    ).astype(jnp.int32)
    live = pos < rest_indptr[-1]
    src = jnp.where(live, row_ptr[r_of] + pos - rest_indptr[r_of], 0)
    return (
        jnp.where(live, data[src], jnp.zeros((), data.dtype)),
        jnp.where(live, indices[src], 0).astype(jnp.int32),
    )


def ell_pack_device(
    A: CSR, *, exact_max: int = 64, step: int = 32, max_len: int = 2048
) -> ELL:
    """ELL pack of a DEVICE-resident CSR (e.g. a chained SpGEMM output,
    ops.spgemm_slab_csr): only the (nrow+1,) indptr is pulled to host — the
    slab planning is nrow-scale — and every nnz-scale gather runs on device
    in one compiled program per phase.  This closes the chain
    C = A@B (device CSR) -> SpMM/SpMV at ELL speed without an nnz-scale
    host round-trip.  Same layout contract as :func:`ell_pack`."""
    import jax.numpy as jnp

    m, n = A.shape
    indptr = np.asarray(A.indptr, dtype=np.int64)  # nrow-scale D2H only
    lens = indptr[1:] - indptr[:-1]
    perm, n_empty, slabs, lo_rest = _slab_plan(lens, exact_max, step, max_len)

    shapes = tuple((hi - lo, L) for (L, lo, hi) in slabs)
    ptrs = tuple(jnp.asarray(indptr[perm[lo:hi]], jnp.int32) for (L, lo, hi) in slabs)
    lns = tuple(jnp.asarray(lens[perm[lo:hi]], jnp.int32) for (L, lo, hi) in slabs)
    cols_t, data_t = _ell_gather_dev(A.indices, A.data, ptrs, lns, shapes=shapes)

    rest_rows = perm[lo_rest:]
    n_rest = len(rest_rows)
    if n_rest:
        ln = lens[rest_rows]
        rest_indptr = np.zeros(n_rest + 1, dtype=np.int64)
        np.cumsum(ln, out=rest_indptr[1:])
        rest_nnz = int(rest_indptr[-1])
        nnz_pad = -(-rest_nnz // 8) * 8
        rd, ri = _rest_gather_dev(
            A.indices, A.data,
            jnp.asarray(indptr[rest_rows], jnp.int32),
            jnp.asarray(rest_indptr, jnp.int32),
            nnz_pad=nnz_pad,
        )
        rest = CSR(
            data=rd, indices=ri,
            indptr=jnp.asarray(rest_indptr, jnp.int32),
            shape=(n_rest, n), nnz=rest_nnz,
        )
    else:
        rest = CSR(
            data=jnp.zeros(1, A.data.dtype),
            indices=jnp.zeros(1, jnp.int32),
            indptr=jnp.zeros(2, jnp.int32),
            shape=(1, n), nnz=0,
        )

    inv = np.empty(m, dtype=np.int64)
    inv[perm] = np.arange(m)
    return ELL(
        data=data_t,
        cols=cols_t,
        rest=rest,
        perm=jnp.asarray(perm, jnp.int32),
        inv_perm=jnp.asarray(inv, jnp.int32),
        shape=(m, n),
        nnz=A.nnz,
        n_empty=n_empty,
        n_rest_rows=n_rest,
    )
