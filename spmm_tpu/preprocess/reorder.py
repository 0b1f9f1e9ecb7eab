"""Pass 1 — dominant-section row reordering.

Redesign of the reference's bitmap reorder
(reference: bitmap.h:108-170, invoked with SECT=2048 at
serial_newblock_clock.cpp:246).  Intent (SURVEY.md §2.3): split the column
space into fixed-width sections; cluster rows whose nonzeros concentrate in
the same section so that nearby rows share an RHS working set.

The reference's scanner has scoring quirks (the final run of a row is never
scored, scores aren't reset across sections — SURVEY.md §2.3 [verified]); we
implement the *intent*: with CSR columns sorted, a row's nonzeros inside one
section form one consecutive run, so the dominant section is simply the
section holding the most of the row's nonzeros (ties → lowest section).
Rows with no nonzeros go to bucket 0, like the reference's ``max_index=-1``
rows.  The permutation choice only affects locality, never numeric results
(results are un-permuted via ``row_inv``).

Both a numpy host path and a jit-able JAX device path are provided; the
device path is all sorts/segment-ops (no data-dependent shapes).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spmm_tpu.formats.containers import CSR, permute_rows


def dominant_sections(A: CSR, section_size: int = 2048) -> np.ndarray:
    """Per-row dominant section id, or -1 for empty rows (host path).

    Uses the native O(nnz) scan when available (CSR columns are sorted within
    rows by construction); falls back to a vectorized numpy formulation.
    """
    h = A.host()
    nrow = A.shape[0]
    if A.nnz == 0:
        return np.full(nrow, -1, dtype=np.int64)
    try:
        from spmm_tpu import native

        dom = native.dominant_sections(
            np.asarray(h.indptr, dtype=np.int64), np.asarray(h.indices[: A.nnz]), section_size
        )
        if dom is not None:
            return dom
    except Exception:
        pass
    lens = np.asarray(h.row_lengths(), dtype=np.int64)
    rows = np.repeat(np.arange(nrow, dtype=np.int64), lens)
    cols = np.asarray(h.indices[: A.nnz], dtype=np.int64)
    sect = cols // section_size
    nsect = int((A.shape[1] + section_size - 1) // section_size)

    key = rows * nsect + sect
    uniq, counts = np.unique(key, return_counts=True)
    urow, usect = uniq // nsect, uniq % nsect
    # per row: max count, tie -> lowest section.  lexsort: last key is primary.
    order = np.lexsort((-usect, counts, urow))
    urow_s, usect_s = urow[order], usect[order]
    last = np.nonzero(np.concatenate([urow_s[1:] != urow_s[:-1], np.ones(1, bool)]))[0]
    dom = np.full(nrow, -1, dtype=np.int64)
    dom[urow_s[last]] = usect_s[last]
    return dom


def bitmap_reorder(
    A: CSR, section_size: int = 2048, *, materialize: bool = True
) -> Tuple[CSR | None, np.ndarray]:
    """Returns ``(A_permuted | None, perm)`` with ``perm[new_pos] = old_row``:
    rows stably bucketed by dominant section (bucket 0 = empty rows)."""
    dom = dominant_sections(A, section_size)
    perm = None
    try:
        from spmm_tpu import native

        nsect = int((A.shape[1] + section_size - 1) // section_size)
        perm = native.counting_argsort(dom + 1, nsect + 1)
    except Exception:
        perm = None
    if perm is None:
        perm = np.argsort(dom + 1, kind="stable")
    out = permute_rows(A, perm) if materialize else None
    return out, perm


# ------------------------------------------------------------------------------
# device path
# ------------------------------------------------------------------------------


def dominant_sections_device(
    indices: jax.Array, indptr: jax.Array, nnz: int, shape: Tuple[int, int], section_size: int
) -> jax.Array:
    """Jit-able dominant-section computation.

    Strategy: sort per-nonzero (row, section) keys; run-lengths of equal keys
    are per-(row, section) counts; scatter-max a packed score
    ``count * nsect + (nsect - 1 - sect)`` per row (encodes the lowest-section
    tie-break); decode.  O(nnz log nnz), static shapes throughout.
    """
    nrow, ncol = shape
    nsect = (ncol + section_size - 1) // section_size
    from spmm_tpu.ops.segments import boundary_segments

    nnz_pad = indices.shape[0]
    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    rows = boundary_segments(indptr, nnz_pad)
    sect = jnp.asarray(indices, jnp.int32) // section_size
    valid = pos < nnz

    # rows*nsect+sect can overflow int32 for huge graphs, so sort two keys.
    rk = jnp.where(valid, rows, jnp.int32(2**31 - 1))
    sk = jnp.where(valid, sect, jnp.int32(2**31 - 1))
    rs, ss = jax.lax.sort((rk, sk), num_keys=2)
    first = jnp.concatenate([jnp.ones((1,), bool), (rs[1:] != rs[:-1]) | (ss[1:] != ss[:-1])])
    # count of each run via positions of run starts
    starts = jnp.nonzero(first, size=nnz_pad, fill_value=nnz_pad)[0]
    next_start = jnp.concatenate([starts[1:], jnp.array([nnz_pad])])
    # map back: for each run (indexed by order of starts), count:
    counts = (next_start - starts).astype(jnp.int32)
    run_rows = rs[jnp.clip(starts, 0, nnz_pad - 1)]
    run_sects = ss[jnp.clip(starts, 0, nnz_pad - 1)]
    run_valid = (starts < nnz_pad) & (run_rows != jnp.int32(2**31 - 1))
    run_row_idx = jnp.clip(run_rows, 0, nrow - 1)
    # two scatters avoid int32 overflow of a packed count*nsect score:
    # 1) max count per row; 2) min section among runs achieving that count.
    cnt = jnp.where(run_valid, counts, jnp.int32(-1))
    best_cnt = jnp.full((nrow,), -1, jnp.int32).at[run_row_idx].max(cnt, mode="drop")
    is_best = run_valid & (counts == best_cnt[run_row_idx])
    sect_c = jnp.where(is_best, run_sects, jnp.int32(2**31 - 1))
    best_sect = (
        jnp.full((nrow,), 2**31 - 1, jnp.int32).at[run_row_idx].min(sect_c, mode="drop")
    )
    return jnp.where(best_cnt < 0, -1, best_sect)


def bitmap_perm_device(A: CSR, section_size: int = 2048) -> jax.Array:
    """Device-computed permutation (new_pos → old_row)."""
    dom = dominant_sections_device(
        jnp.asarray(A.indices), jnp.asarray(A.indptr), A.nnz, A.shape, section_size
    )
    return jnp.argsort(dom + 1, stable=True).astype(jnp.int32)
