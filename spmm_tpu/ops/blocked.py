"""Kernels over the preprocessed BlockedCSR format.

This is the consumer the reference format implies but never ships
(SURVEY.md §3.3): per region, gather the compacted RHS panel
(``gather_cols`` slots — bounded by the region budget), then
multiply v8 groups as dense (8, L) tiles and remain rows as gathered dot
products, writing rows in final order; un-permute with ``row_inv`` at the end.

``blocked_spmm_slab`` is the production path; ``blocked_spmm_xla`` and
``blocked_spmm_panel`` are the alternative formulations it was chosen over.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spmm_tpu.formats.containers import BlockedCSR


def _final_out_rows(P: BlockedCSR) -> jax.Array:
    """Per packed nonzero: the (final-order) output row it contributes to.

    Remain rows: the CSR row containing the position.  v8 blocks are 8-row
    interleaved, so position ``group_nnz[g] + t`` belongs to group-row
    ``t % 8`` (reference layout, serial_newblock_clock.cpp:366-385).
    """
    from spmm_tpu.ops.segments import boundary_segments

    nnz_pad = P.data.shape[0]
    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    r0 = boundary_segments(jnp.asarray(P.indptr), nnz_pad)
    g = jnp.asarray(P.row_group)[r0]
    has_groups = P.ngroups > 0
    if not has_groups:
        return r0
    gsafe = jnp.clip(g, 0, P.ngroups - 1)
    off = pos - jnp.asarray(P.group_nnz)[gsafe]
    grow = jnp.asarray(P.group_row)[gsafe] + (off % 8)
    return jnp.where(g >= 0, grow, r0)


def _panel_slots(P: BlockedCSR) -> jax.Array:
    """Per packed nonzero: its slot in the region-concatenated relabel space
    (``region_gather[region] + cols_local`` — the compacted-panel index the
    reference's relabel pass exists to produce, SURVEY.md §2.7)."""
    from spmm_tpu.ops.segments import boundary_segments

    nnz_pad = P.data.shape[0]
    reg = boundary_segments(jnp.asarray(P.region_nnz), nnz_pad)
    slot = jnp.asarray(P.region_gather)[reg] + jnp.asarray(P.cols_local)
    return jnp.clip(slot, 0, P.ndistinct - 1)


def _global_cols(P: BlockedCSR) -> jax.Array:
    """Undo the per-region relabel: original column id per packed nonzero."""
    return jnp.asarray(P.gather_cols)[_panel_slots(P)]


def blocked_exec_view(P: BlockedCSR):
    """Pack-once execution view: (out_rows, global_cols) per packed nonzero,
    computed on device once and reused across multiplies — recomputing the
    v8-interleave/relabel indirections per call costs as much as the multiply
    itself (measured on web-Google on the first target)."""
    out_rows = _final_out_rows(P)
    gcols = _global_cols(P)
    return jax.block_until_ready((out_rows, gcols))


def blocked_spmm_xla(
    P: BlockedCSR,
    B: jax.Array,
    *,
    accum_dtype=jnp.float32,
    permute_back: bool = True,
    view=None,
) -> jax.Array:
    """Y = unpack(P) @ B via the packed stream (validates the full format:
    interleave, relabel, permutations).  Pass ``view=blocked_exec_view(P)``
    for the pack-once/multiply-many pattern."""
    out_rows, gcols = view if view is not None else (_final_out_rows(P), _global_cols(P))
    contrib = jnp.take(B, gcols, axis=0).astype(accum_dtype) * jnp.asarray(P.data).astype(
        accum_dtype
    )[:, None]
    # mask padding (if any): positions >= nnz contribute zero via data==0
    y_final = jax.ops.segment_sum(contrib, out_rows, num_segments=P.nrow)
    if not permute_back:
        return y_final
    return y_final[jnp.asarray(P.row_inv)]


def blocked_panel_view(P: BlockedCSR):
    """Pack-once view for the TWO-STAGE panel SpMM: (out_rows, slots,
    gather_cols) — ``slots`` index the region-concatenated compacted panel
    instead of the full B (the blueprint consumer of SURVEY.md §3.3 /
    reference serial_newblock_clock.cpp:187-204: the relabel exists so the
    multiply reads a compacted working set)."""
    return jax.block_until_ready(
        (_final_out_rows(P), _panel_slots(P), jnp.asarray(P.gather_cols))
    )


def blocked_spmm_panel(
    P: BlockedCSR,
    B: jax.Array,
    *,
    accum_dtype=jnp.float32,
    permute_back: bool = True,
    view=None,
) -> jax.Array:
    """Y = unpack(P) @ B via the two-stage region-panel gather: stage 1
    compacts the referenced B rows once (``take(B, gather_cols)`` —
    ndistinct ≤ nnz rows, each region's stretch budget-bounded by the
    region split, SURVEY.md §2.4); stage 2 gathers each packed nonzero's
    contribution from the COMPACTED panel by relabeled slot.  Compare
    against :func:`blocked_spmm_xla` (single gather from full B) — the
    benchmark decides which formulation the dispatcher uses."""
    out_rows, slots, gcols = (
        view if view is not None
        else (_final_out_rows(P), _panel_slots(P), jnp.asarray(P.gather_cols))
    )
    panel = jnp.take(B, gcols, axis=0).astype(accum_dtype)  # stage 1
    contrib = jnp.take(panel, slots, axis=0) * jnp.asarray(P.data).astype(
        accum_dtype
    )[:, None]
    y_final = jax.ops.segment_sum(contrib, out_rows, num_segments=P.nrow)
    if not permute_back:
        return y_final
    return y_final[jnp.asarray(P.row_inv)]


def blocked_slab_view(P: BlockedCSR, *, panel: bool = False):
    """Pack-once v8-SLAB execution view — the fast consumer of the packed
    format.  The 8-row interleave (slot ``base + 8e + r``) means each group's
    packed block reshapes DIRECTLY to a dense (L, 8) tile, so groups of equal
    L multiply as one batched einsum (the reference's v8 layout used exactly
    as intended, SURVEY.md §3.3).  Buckets groups by length; leftover rows
    become a sorted gather+segment-sum stream; a single precomputed gather
    un-permutes the concatenated parts to original row order.

    Returns ``(buckets, rem, order_map)``:
      buckets: list of (d3 (G,L,8) values, c3 (G,L,8) GLOBAL col ids);
      rem: (cols, vals, seg_ids) for non-group rows;
      order_map: (nrow,) concat position of each ORIGINAL row.

    ``panel=True``: column indices are relabeled PANEL SLOTS instead of
    global ids and the view carries ``gather_cols`` as a 4th element — the
    multiply then stages the compacted panel first (two-stage gather, see
    :func:`blocked_spmm_panel`)."""
    import numpy as np

    h_gl = np.asarray(P.group_len, np.int64)
    h_gn = np.asarray(P.group_nnz, np.int64)
    h_grow = np.asarray(P.group_row, np.int64)
    indptr = np.asarray(P.indptr, np.int64)
    nrow = P.nrow

    # (nnz_pad,) device, computed once: panel slots or global column ids
    gcols_full = _panel_slots(P) if panel else _global_cols(P)
    data_full = jnp.asarray(P.data)

    buckets = []
    order_map_final = np.empty(nrow, np.int64)
    off = 0
    for L in np.unique(h_gl):
        ids = np.nonzero(h_gl == L)[0]
        G = len(ids)
        pos = (h_gn[ids][:, None] + np.arange(8 * int(L))[None, :]).reshape(-1)
        posd = jnp.asarray(pos, jnp.int32)
        d3 = jnp.take(data_full, posd).reshape(G, int(L), 8)
        c3 = jnp.take(gcols_full, posd).reshape(G, int(L), 8)
        buckets.append((d3, c3))
        rows8 = h_grow[ids][:, None] + np.arange(8)[None, :]  # (G, 8)
        order_map_final[rows8.reshape(-1)] = off + np.arange(G * 8)
        off += G * 8

    # non-group rows (incl. empty): sorted stream, segment ids = row rank
    h_rg = np.asarray(P.row_group, np.int64)
    nongroup = np.nonzero(h_rg < 0)[0]
    rank = np.full(nrow, -1, np.int64)
    rank[nongroup] = np.arange(len(nongroup))
    order_map_final[nongroup] = off + rank[nongroup]
    lens = indptr[1:] - indptr[:-1]
    row_of_pos = np.repeat(np.arange(nrow), lens)
    rem_mask = h_rg[row_of_pos] < 0
    rem_pos = np.nonzero(rem_mask)[0]
    rem_seg = rank[row_of_pos[rem_pos]]
    rp = jnp.asarray(rem_pos, jnp.int32)
    # n_nongroup is NOT stored (an int leaf would trace under jit and break
    # num_segments); consumers derive it from static shapes:
    # nrow - 8 * sum(bucket group counts)
    rem = (
        jnp.take(gcols_full, rp),
        jnp.take(data_full, rp),
        jnp.asarray(rem_seg, jnp.int32),
    )
    # original row i sits at final position row_inv[i], whose concat slot is
    # order_map_final[row_inv[i]]
    inv = np.asarray(P.row_inv, np.int64)
    order_map = jnp.asarray(order_map_final[inv], jnp.int32)
    out = (tuple(buckets), rem, order_map)
    if panel:
        out = out + (jnp.asarray(P.gather_cols),)
    return jax.block_until_ready(out)


def blocked_spmm_slab(
    P: BlockedCSR, B: jax.Array, view, *, accum_dtype=jnp.float32
) -> jax.Array:
    """Y = unpack(P) @ B via the v8-slab view (pack once, multiply many) —
    dense (L, 8) tiles per group batch + sorted leftover stream.  Rows
    return in ORIGINAL order.  A 4-element (panel) view stages the compacted
    RHS panel once and all tile gathers read it by relabeled slot."""
    hi = jax.lax.Precision.HIGHEST
    if len(view) == 4:
        buckets, rem, order_map, gcols = view
        B = jnp.take(B, gcols, axis=0)  # stage 1: compacted panel
    else:
        buckets, rem, order_map = view
    k = B.shape[-1]
    parts = []
    for d3, c3 in buckets:
        G, L, _ = d3.shape
        g = jnp.take(B, c3.reshape(-1), axis=0).astype(accum_dtype).reshape(G, L, 8, k)
        yb = jnp.einsum("gle,glek->gek", d3.astype(accum_dtype), g, precision=hi)
        parts.append(yb.reshape(G * 8, k))
    cols, vals, seg = rem
    n_nongroup = order_map.shape[0] - sum(d3.shape[0] * 8 for d3, _ in buckets)
    contrib = jnp.take(B, cols, axis=0).astype(accum_dtype) * vals.astype(accum_dtype)[:, None]
    parts.append(
        jax.ops.segment_sum(contrib, seg, num_segments=n_nongroup, indices_are_sorted=True)
    )
    ys = jnp.concatenate(parts, axis=0)
    return jnp.take(ys, order_map, axis=0)


def blocked_chain_spmv(
    P: BlockedCSR, x: jax.Array, iters: int, *, accum_dtype=jnp.float32
) -> jax.Array:
    """y = A^iters @ x on a SQUARE matrix via the self-referential gather map
    — the exact runtime contract the reference's ``seq_input`` exists for
    (reference wbsort.h:81-95, SURVEY.md §2.8/§3.3): relabeled column ``j``
    of region ``r`` reads the iterate at FINAL position
    ``gather_rows[region_gather[r] + j]``, so chained products never leave
    the permuted order — the permutations are applied exactly once at entry
    (``row_perm``) and once at exit (``row_inv``)."""
    from spmm_tpu.ops.segments import boundary_segments

    if P.shape[0] != P.shape[1]:
        raise ValueError("seq_input chaining is defined for square matrices only")
    nnz_pad = P.data.shape[0]
    out_rows = _final_out_rows(P)
    # per packed nonzero: its slot in the region-concatenated relabel space
    reg = boundary_segments(jnp.asarray(P.region_nnz), nnz_pad)
    slot = jnp.asarray(P.region_gather)[reg] + jnp.asarray(P.cols_local)
    slot = jnp.clip(slot, 0, P.ndistinct - 1)
    gr = jnp.asarray(P.gather_rows)
    vals = jnp.asarray(P.data).astype(accum_dtype)

    x_f = jnp.take(x.astype(accum_dtype), jnp.asarray(P.row_perm))  # to final order

    def step(y_f, _):
        panel = jnp.take(y_f, gr)  # compacted per-region RHS panel (seq_input)
        contrib = vals * jnp.take(panel, slot)
        y_next = jax.ops.segment_sum(contrib, out_rows, num_segments=P.nrow)
        return y_next, None

    y_f, _ = jax.lax.scan(step, x_f, None, length=iters)
    return jnp.take(y_f, jnp.asarray(P.row_inv))  # back to original order


def blocked_spmm(
    P: BlockedCSR, B: jax.Array, *, view=None, accum_dtype=jnp.float32
) -> jax.Array:
    """Dispatcher for the packed-format SpMM — routes to the v8-SLAB path,
    which beat the two-stage panel gather and the segment-sum formulations
    on the accelerator this was first built on; not re-measured on a GPU.

    ``view``: a :func:`blocked_slab_view` built once for repeated multiplies
    (pack-once / multiply-many); one-shot calls build it here.

    The two-stage panel gather (the SURVEY §3.3 blueprint) is
    :func:`blocked_spmm_panel`; DESIGN.md §3 says why panel compaction did
    not pay on power-law graphs.  For raw one-shot SpMM speed
    use the ELL kernel (ops/ell_spmm.py); this format's unique payoff is
    :func:`blocked_chain_spmv` (the reference's seq_input A^k·x contract).
    """
    if view is None:
        view = blocked_slab_view(P)
    return blocked_spmm_slab(P, B, view, accum_dtype=accum_dtype)
