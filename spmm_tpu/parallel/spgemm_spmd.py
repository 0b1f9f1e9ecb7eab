"""SPMD distributed SpGEMM — row-partitioned A under shard_map.

Multi-device row-partitioned SpGEMM.  The left matrix is
row-block sharded over the mesh's "rows" axis (the reference's region split
is the shard unit, SURVEY.md §2.4/§2.12).  Two B strategies:

- :func:`spgemm_dist_spmd` — B's CSR replicated (random access to all rows);
- :func:`spgemm_dist_halo` — each shard holds ONLY the B rows its column ids
  reference (the halo set, SURVEY.md §2.12; per-shard memory drops from
  nnz(B) to the shard's working set — the distributed analog of the
  reference's distinct-column region budget, transmat.h:334-376).

(The dense-RHS ppermute ring lives in parallel/spmm_dist.py.)

Every shard runs the same slab-ESC program (ops/slab_spgemm.py) under
``shard_map``, which requires uniform static shapes across shards:

- pa/segment paddings are the max over shards;
- the chunk schedule is built from per-class MAX row counts; each shard gets
  its own runtime (start, count) scalars per chunk (empty chunks just mask);
- per-shard nnz enters as a traced scalar (the kernel only compares
  against it).

On a multi-GPU host the "rows" axis maps to the GPUs; on CI it is
the 8-device virtual CPU mesh (SURVEY.md §4.3).  No collectives are needed in
the compute itself (B replicated, outputs row-disjoint) — scaling efficiency
is bounded by shard balance, which the preprocessing reorder + region split
directly controls.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmm_tpu.formats.containers import CSR
from spmm_tpu.parallel.partition import ShardedCSR
from spmm_tpu.ops.slab_spgemm import (
    DEFAULT_CLASSES,
    DEFAULT_SEG_W,
    DEFAULT_SLOT_BUDGET,
    _bucket_pow2,
    _chunk_body,
    _chunk_fetch,
    _chunk_meta,
    _merge_block,
    _nseg_pad,
    _pick_b2_ws,
    _plan_body,
    _round_up,
)


def _per_shard_sizing(S: ShardedCSR, B: CSR, W: int, classes, b_iptr_per_shard=None):
    """Host-side sizing per shard (native one-pass when available).
    ``b_iptr_per_shard``: optional (nsh, nrowB_loc+1) per-shard local B indptr
    (the halo path); default is one replicated B."""
    # lazy: the halo path never uses the replicated indptr (and B may be
    # device-resident — .host() would be a full D2H)
    b_iptr_rep = (
        None if b_iptr_per_shard is not None
        else np.asarray(B.host().indptr, dtype=np.int64)
    )
    cls_all, counts_all, npa_max, nnz_s = [], [], 0, []
    ind = np.asarray(S.indices)
    iptr = np.asarray(S.indptr, dtype=np.int64)
    for s in range(S.n_shards):
        b_iptr = (
            np.asarray(b_iptr_per_shard[s], np.int64)
            if b_iptr_per_shard is not None
            else b_iptr_rep
        )
        lenB = b_iptr[1:] - b_iptr[:-1]
        nnz = int(iptr[s, -1])
        nnz_s.append(nnz)
        res = None
        try:
            from spmm_tpu import native

            res = native.spgemm_sizing(
                iptr[s], ind[s, :nnz], b_iptr, W, np.asarray(classes, np.int64)
            )
        except Exception:
            res = None
        if res is not None:
            npa, _, cls = res
        else:
            a_ind = ind[s, :nnz].astype(np.int64)
            nseg = np.where(lenB[a_ind] > 0, (lenB[a_ind] + W - 1) // W, 0)
            npa = int(nseg.sum())
            segc = np.zeros(nnz + 1, dtype=np.int64)
            np.cumsum(nseg, out=segc[1:])
            exp_pad = W * (segc[iptr[s, 1:]] - segc[iptr[s, :-1]])
            cls = np.zeros(S.rows_per_shard, dtype=np.int32)
            for c in classes:
                cls += (exp_pad > c).astype(np.int32)
            cls[exp_pad == 0] = len(classes) + 1
        if npa * W >= 2**31:
            raise ValueError(
                f"shard {s}: padded expansion exceeds int32 range; "
                "use more shards or chunk rows first"
            )
        npa_max = max(npa_max, npa)
        counts_all.append(np.bincount(cls, minlength=len(classes) + 2)[: len(classes) + 1])
        cls_all.append(cls)
    return (
        np.stack(cls_all),
        np.stack(counts_all).astype(np.int64),
        npa_max,
        np.asarray(nnz_s, np.int32),
    )


def _uniform_schedule(classes, counts, slot_budget):
    """Chunk schedule covering the max per-class count over shards, plus
    per-shard runtime (start, count) tables."""
    nsh = counts.shape[0]
    max_counts = counts.max(axis=0)
    offsets = np.concatenate(
        [np.zeros((nsh, 1), np.int64), np.cumsum(counts, axis=1)], axis=1
    )
    sched, starts, cnts = [], [], []
    for ci, L in enumerate(classes):
        n = int(max_counts[ci])
        rows_per_chunk = max(slot_budget // L, 8)
        for lo in range(0, n, rows_per_chunk):
            cap = min(rows_per_chunk, n - lo)
            R_pad = min(_bucket_pow2(cap), _round_up(cap, 1 << 10))
            sched.append((L, R_pad))
            starts.append(offsets[:, ci] + lo)
            cnts.append(np.clip(counts[:, ci] - lo, 0, rows_per_chunk))
    starts = np.stack(starts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    cnts = np.stack(cnts, axis=1).astype(np.int32) if sched else np.zeros((nsh, 0), np.int32)
    return sched, starts, cnts, offsets[:, len(classes)].astype(np.int64)



def _detect_shard_pattern(S: ShardedCSR, B: CSR) -> bool:
    """All-ones value detection over host shards (never D2H-scans device
    shards — see ops.slab_spgemm._is_pattern)."""
    from spmm_tpu.ops.slab_spgemm import _is_pattern

    if not isinstance(S.data, np.ndarray):
        return False
    siptr = np.asarray(S.indptr, np.int64)
    return _is_pattern(B) and all(
        bool(np.all(S.data[s, : int(siptr[s, -1])] == 1)) for s in range(S.n_shards)
    )


#: compiled-program memo: _make_spmd_run builds a fresh shard_map closure per
#: call, which costs a full retrace (+ cache-hit recompile) on EVERY repeated
#: distributed multiply — seconds per call on the CPU backend.  All inputs
#: that shape the program are hashable, so identical configurations reuse the
#: same jitted callable.
_SPMD_RUN_CACHE: dict = {}


def _make_spmd_run(mesh, axis, schedule, kw, W, accum_dtype, pattern, b_sharded,
                   compact_nnz_pad=None, exchange=None):
    key = (
        mesh, axis, tuple(schedule), tuple(sorted(kw.items())), W,
        str(jnp.dtype(accum_dtype).name), pattern, b_sharded,
        compact_nnz_pad, bool(exchange),
    )
    run = _SPMD_RUN_CACHE.get(key)
    if run is None:
        run = _make_spmd_run_uncached(
            mesh, axis, schedule, kw, W, accum_dtype, pattern, b_sharded,
            compact_nnz_pad=compact_nnz_pad, exchange=exchange,
        )
        if len(_SPMD_RUN_CACHE) > 32:
            _SPMD_RUN_CACHE.pop(next(iter(_SPMD_RUN_CACHE)))
        _SPMD_RUN_CACHE[key] = run
    return run


def _exchange_halo_body(b_ind, b_dat, extra, axis, pattern):
    """Runtime halo exchange, traced INSIDE a shard_map body: pack owned B
    rows requested by each peer, swap via ``all_to_all``, gather the received owner-major blocks into this shard's local
    halo CSR.  In pattern mode only column ids travel (values are all 1.0 —
    half the wire traffic).  Shared by the one-shot halo-exchange run and the
    sharded-B plan phase (exchange once at plan time, re-execute with no
    collectives)."""
    send_src, recv_gather, loc_iptr = (x[0] for x in extra)
    nsh = send_src.shape[0]
    send_ind = jnp.take(b_ind, send_src.reshape(-1), mode="clip").reshape(nsh, -1)
    got_ind = jax.lax.all_to_all(
        send_ind, axis, split_axis=0, concat_axis=0, tiled=True
    )
    b_ind = jnp.take(got_ind.reshape(-1), recv_gather, mode="clip")
    if pattern:
        b_dat = jnp.ones(b_ind.shape, b_dat.dtype)  # values all 1.0
    else:
        send_dat = jnp.take(b_dat, send_src.reshape(-1), mode="clip").reshape(
            nsh, -1
        )
        got_dat = jax.lax.all_to_all(
            send_dat, axis, split_axis=0, concat_axis=0, tiled=True
        )
        b_dat = jnp.take(got_dat.reshape(-1), recv_gather, mode="clip")
    return loc_iptr, b_ind, b_dat


def _make_spmd_run_uncached(mesh, axis, schedule, kw, W, accum_dtype, pattern,
                            b_sharded, compact_nnz_pad=None, exchange=None):
    """The one SPMD program every distribution strategy executes: per-shard
    plan + uniform runtime-scalar chunk schedule.  ``b_sharded`` selects
    whether the three B arrays carry a leading shard axis (halo path) or are
    replicated.  ``compact_nnz_pad``: when set, each shard compacts its chunk
    outputs to a local CSR *inside* the program (``_compact_to_csr``) and the
    result stays row-sharded on device — no host assembly, no padded-slab
    D2H.  ``exchange``: when set (the runtime-halo path), B arrives
    row-BLOCK sharded and each shard's working set is fetched in-program via
    an ``all_to_all`` collective over the mesh axis (SURVEY.md §2.12's halo
    exchange); the three extra operands are the host-precomputed
    (send_src, recv_gather, loc_iptr) maps."""
    spec_sh = P(axis)
    b_spec = spec_sh if b_sharded else P()
    n_extra = 3 if exchange else 0
    if compact_nnz_pad is None:
        out_specs = (spec_sh, tuple((spec_sh,) * 4 for _ in schedule))
    else:
        out_specs = (spec_sh, (spec_sh,) * 4)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_sh,) * 6 + (b_spec,) * 3 + (spec_sh,) * n_extra,
        out_specs=out_specs,
        check_vma=False,
    )
    def run(indptr, ind, dat, cls_s, nnz_sc, sc_tab, b_indptr, b_ind, b_dat,
            *extra):
        indptr, ind, dat = indptr[0], ind[0], dat[0]
        cls_s, nnz_sc, sc_tab = cls_s[0], nnz_sc[0], sc_tab[0]
        if b_sharded:
            b_indptr, b_ind, b_dat = b_indptr[0], b_ind[0], b_dat[0]
        if exchange:
            b_indptr, b_ind, b_dat = _exchange_halo_body(
                b_ind, b_dat, extra, axis, pattern
            )
        (b2p, pap, rowmeta, rows_sorted) = _plan_body(
            indptr, ind, dat, b_indptr, b_ind, b_dat, cls_s, nnz=nnz_sc[0],
            pattern=pattern, **kw
        )
        a_dt, b_dt = str(dat.dtype), str(b_dat.dtype)
        outs = []
        for i, (L, R_pad) in enumerate(schedule):
            outs.append(
                _chunk_body(
                    b2p, pap, rows_sorted, rowmeta,
                    sc_tab[0, i], sc_tab[1, i], L=L, R_pad=R_pad, W=W,
                    a_dtype=a_dt, b_dtype=b_dt, accum_dtype=accum_dtype,
                    pattern=pattern, b2_ws=kw.get("b2_ws"),
                )
            )
        if compact_nnz_pad is not None:
            from spmm_tpu.ops.slab_spgemm import _compact_to_csr

            data, indices, out_iptr, knnz = _compact_to_csr(
                tuple(o[0] for o in outs),
                tuple(o[1] for o in outs),
                tuple(o[2] for o in outs),
                tuple(o[3] for o in outs),
                nrow=kw["nrow"],
                nnz_pad=compact_nnz_pad,
            )
            return rows_sorted[None], (
                data[None], indices[None], out_iptr[None], knnz[None, None]
            )
        # re-add the leading shard axis for out_specs
        outs = tuple(tuple(x[None] for x in o) for o in outs)
        return rows_sorted[None], outs

    # shard_map WITHOUT jit executes eagerly — op-by-op through the shard_map
    # machinery, ~37 s of size-independent overhead per call for this program
    # (measured on the CPU mesh).  jit compiles it once per configuration;
    # the _SPMD_RUN_CACHE memo above keeps the jitted callable alive across
    # repeated distributed multiplies.
    return jax.jit(run)


def _pull_shard_chunks(outs, row_starts, nsh):
    """Masked pull of sharded chunk outputs -> (rows, cols, vals) lists with
    global row ids."""
    rows_l, cols_l, vals_l = [], [], []
    for r, cols_u, vals_u, nuniq in outs:
        r = np.asarray(r)  # (nsh, R_pad)
        nu = np.asarray(nuniq)
        cu = np.asarray(cols_u)
        vu = np.asarray(vals_u)
        L = cu.shape[-1]
        for s in range(nsh):
            mask = np.arange(L)[None, :] < nu[s][:, None]
            rows_l.append(np.repeat(r[s].astype(np.int64), nu[s]) + row_starts[s])
            cols_l.append(cu[s][mask].astype(np.int64))
            vals_l.append(vu[s][mask])
    return rows_l, cols_l, vals_l


def _finish_global_csr(rows_l, cols_l, vals_l, shape):
    from spmm_tpu.ops.slab_spgemm import _assemble_csr

    rows = np.concatenate(rows_l) if rows_l else np.zeros(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.zeros(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.zeros(0, np.float32)
    return _assemble_csr(rows, cols, vals, shape)


def _append_shard_tails(rows_sorted, counts, ncls, tail_per_shard, S, B,
                        accum_dtype, row_starts, rows_l, cols_l, vals_l):
    """Heavy-tail rows (padded expansion past the class ceiling) per shard:
    products via the global-sort host fallback on the ORIGINAL (unrelabeled)
    shard CSR against the full B, appended to the assembly lists in place."""
    from spmm_tpu.ops.slab_spgemm import _tail_products

    rs = np.asarray(rows_sorted)
    base = counts[:, :ncls].sum(axis=1)
    iptr = np.asarray(S.indptr, dtype=np.int64)
    Bh = B.host()
    for s in range(S.n_shards):
        nt = int(tail_per_shard[s])
        if not nt:
            continue
        trows = rs[s, int(base[s]) : int(base[s]) + nt].astype(np.int64)
        sub_full = CSR(
            data=np.asarray(S.data[s]),
            indices=np.asarray(S.indices[s], np.int32),
            indptr=iptr[s],
            shape=(S.rows_per_shard, S.shape[1]),
            nnz=int(iptr[s, -1]),
        )
        tr, tc, tv = _tail_products(sub_full, trows, Bh, accum_dtype)
        rows_l.append(tr + row_starts[s])
        cols_l.append(tc)
        vals_l.append(tv)


def spgemm_dist_spmd(
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    as_csr: bool = True,
    pattern: bool | None = None,
):
    """C = A @ B with A row-sharded over ``mesh[axis]``.  One SPMD program;
    all shards execute the identical slab-ESC kernel on their row block.

    Rows whose padded expansion exceeds the largest class go through the
    per-shard host fallback during assembly.  With ``as_csr=False`` the raw
    device outputs are returned as ``(rows_sorted, chunk_outputs,
    tail_rows_per_shard)`` — the caller owns the tail rows (their products
    are NOT in the chunk outputs).  ``pattern=None`` auto-detects all-ones
    values (reference forced-1.0 semantics) and drops the value channels
    from the device program, as in ops/slab_spgemm.py.
    """
    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = S.n_shards
    if pattern is None:
        pattern = _detect_shard_pattern(S, B)
    cls, counts, npa_max, nnz_s = _per_shard_sizing(S, B, W, classes)
    sched, starts, cnts, _ = _uniform_schedule(counts=counts[:, : len(classes) + 1],
                                               classes=classes, slot_budget=slot_budget)
    tail_per_shard = counts[:, len(classes)]

    Bh = B.host()
    b_iptr = np.asarray(Bh.indptr, dtype=np.int64)
    lenB = b_iptr[1:] - b_iptr[:-1]
    nsegB = int(((lenB + W - 1) // W).sum())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B.data.dtype), _nseg_pad(nsegB)),
    )
    schedule = tuple(sched)
    run = _make_spmd_run(mesh, axis, schedule, kw, W, accum_dtype, pattern,
                         b_sharded=False)

    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab = np.stack([starts, cnts], axis=1)  # (nsh, 2, nchunks)
    rows_sorted, outs = run(
        dev(np.asarray(S.indptr, np.int32)),
        dev(np.asarray(S.indices, np.int32)),
        dev(np.asarray(S.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        dev(sc_tab),
        jnp.asarray(Bh.indptr, jnp.int32),
        jnp.asarray(Bh.indices, jnp.int32),
        jnp.asarray(Bh.data),
    )
    if not as_csr:
        base = counts[:, : len(classes)].sum(axis=1)
        rs_host = np.asarray(rows_sorted)
        tails = [
            rs_host[s, int(base[s]) : int(base[s]) + int(tail_per_shard[s])]
            for s in range(nsh)
        ]
        return rows_sorted, outs, tails

    # ---- host assembly into a global CSR -----------------------------------
    row_starts = np.asarray(S.row_starts, np.int64)
    rows_l, cols_l, vals_l = _pull_shard_chunks(outs, row_starts, nsh)
    if tail_per_shard.sum():
        _append_shard_tails(
            rows_sorted, counts, len(classes), tail_per_shard, S, B,
            accum_dtype, row_starts, rows_l, cols_l, vals_l,
        )

    return _finish_global_csr(rows_l, cols_l, vals_l, (S.shape[0], B.ncol))


def spgemm_dist_csr(
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
) -> ShardedCSR:
    """C = A @ B with the output kept **row-sharded on device**: every shard
    compacts its chunk outputs to a local CSR inside the SPMD program
    (``_compact_to_csr`` per shard — the distributed mirror of
    ``spgemm_slab_csr``), so C never transits the host and chains directly
    into further distributed ops.  Only per-shard nnz scalars are pulled.

    Requires no heavy-tail rows (their products live outside the slabs);
    raise the class ceiling or use :func:`spgemm_dist_spmd` for host
    assembly with the tail fallback."""
    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = S.n_shards
    if pattern is None:
        pattern = _detect_shard_pattern(S, B)
    cls, counts, npa_max, nnz_s = _per_shard_sizing(S, B, W, classes)
    if counts[:, len(classes)].sum():
        raise ValueError(
            "device-resident output requires no heavy-tail rows; raise the "
            "class ceiling or use spgemm_dist_spmd (host assembly)"
        )
    sched, starts, cnts, _ = _uniform_schedule(
        counts=counts[:, : len(classes) + 1], classes=classes,
        slot_budget=slot_budget,
    )
    Bh = B.host()
    b_iptr = np.asarray(Bh.indptr, dtype=np.int64)
    lenB = b_iptr[1:] - b_iptr[:-1]
    nsegB = int(((lenB + W - 1) // W).sum())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B.data.dtype), _nseg_pad(nsegB)),
    )
    nnz_pad = _round_up(npa_max * W, 1024)
    run = _make_spmd_run(mesh, axis, tuple(sched), kw, W, accum_dtype, pattern,
                         b_sharded=False, compact_nnz_pad=nnz_pad)

    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab = np.stack([starts, cnts], axis=1)
    _, (data, indices, indptr, knnz) = run(
        dev(np.asarray(S.indptr, np.int32)),
        dev(np.asarray(S.indices, np.int32)),
        dev(np.asarray(S.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        dev(sc_tab),
        jnp.asarray(Bh.indptr, jnp.int32),
        jnp.asarray(Bh.indices, jnp.int32),
        jnp.asarray(Bh.data),
    )
    total = int(np.asarray(knnz).sum())  # the only D2H: nsh scalars
    return ShardedCSR(
        data=data,
        indices=indices,
        indptr=indptr,
        row_starts=np.asarray(S.row_starts, np.int32),
        shape=(S.shape[0], B.ncol),
        n_shards=nsh,
        rows_per_shard=rows_pad,
        nnz=total,
    )


# ---------------------------------------------------------------------------
# halo-restricted variant: ship each shard ONLY the B rows it references
# ---------------------------------------------------------------------------


def partition_halo(S: ShardedCSR, B: CSR, *, structure_only: bool = False):
    """Per-shard halo restriction of B (SURVEY.md §2.12: the off-shard rows a
    shard's column ids reference are its halo set; the reference's
    distinct-column working set, transmat.h:334-376, is the same bound
    computed per region).

    For shard ``s``: ``halo_rows[s]`` = sorted unique column ids of A_s;
    B restricted to those rows with A_s's indices relabeled to local halo
    positions (B's columns — the output space — stay global).  All shapes
    padded to the max over shards for shard_map uniformity.

    Returns ``(A_rel, b_indptr, b_ind, b_dat, halo_rows, halo_counts)``:
    A_rel a ShardedCSR with relabeled indices; the b_* arrays stacked
    (nsh, ...) per-shard local CSRs of B.

    ``structure_only=True`` skips materializing the local B element arrays
    (``b_ind``/``b_dat`` return as 1-element placeholders) — the runtime-
    exchange paths fetch the elements device-to-device and only need the
    relabeled A, the local indptr, and the halo row lists.
    """
    import dataclasses as _dc

    Bh = B.host()
    b_iptr = np.asarray(Bh.indptr, np.int64)
    b_ind_g = np.asarray(Bh.indices, np.int32)[: B.nnz]
    b_dat_g = np.asarray(Bh.data)[: B.nnz]

    nsh = S.n_shards
    ind = np.asarray(S.indices)
    iptr = np.asarray(S.indptr, np.int64)

    uniq_l, rel_l = [], []
    for s in range(nsh):
        nnz = int(iptr[s, -1])
        uniq, inv = np.unique(ind[s, :nnz], return_inverse=True)
        uniq_l.append(uniq.astype(np.int64))
        rel = np.zeros_like(ind[s])
        rel[:nnz] = inv.astype(ind.dtype)
        rel_l.append(rel)
    halo_counts = np.array([len(u) for u in uniq_l], np.int64)
    nrow_loc = int(halo_counts.max()) if nsh else 1

    # local B CSRs (padded uniform): rows = halo_rows[s], then zero rows
    loc_iptr = np.zeros((nsh, nrow_loc + 1), np.int64)
    loc_nnz = np.zeros(nsh, np.int64)
    for s in range(nsh):
        lens = b_iptr[uniq_l[s] + 1] - b_iptr[uniq_l[s]]
        loc_iptr[s, 1 : len(lens) + 1] = np.cumsum(lens)
        loc_iptr[s, len(lens) + 1 :] = loc_iptr[s, len(lens)]
        loc_nnz[s] = loc_iptr[s, -1]
    if structure_only:
        A_rel = _dc.replace(S, indices=np.stack(rel_l))
        ph = np.zeros((nsh, 1), np.int32)
        return A_rel, loc_iptr, ph, ph.astype(b_dat_g.dtype), uniq_l, halo_counts

    nnzB_pad = max(int(loc_nnz.max()), 1)
    loc_ind = np.zeros((nsh, nnzB_pad), np.int32)
    loc_dat = np.zeros((nsh, nnzB_pad), b_dat_g.dtype)
    for s in range(nsh):
        u = uniq_l[s]
        lens = b_iptr[u + 1] - b_iptr[u]
        nz = int(lens.sum())
        if nz == 0:
            continue
        pos = np.arange(nz, dtype=np.int64)
        starts = np.zeros(len(u) + 1, np.int64)
        np.cumsum(lens, out=starts[1:])
        rof = np.searchsorted(starts, pos, side="right") - 1
        src = b_iptr[u[rof]] + (pos - starts[rof])
        loc_ind[s, :nz] = b_ind_g[src]
        loc_dat[s, :nz] = b_dat_g[src]

    A_rel = _dc.replace(S, indices=np.stack(rel_l))
    return A_rel, loc_iptr, loc_ind, loc_dat, uniq_l, halo_counts


def spgemm_dist_halo(
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
):
    """C = A @ B, A row-sharded, with B **halo-restricted** per shard — each
    shard holds only the B rows its columns reference, instead of a full
    replica (SpGEMM's halo exchange, SURVEY.md §2.12; memory per shard drops
    from nnz(B) to the shard's working set).  One SPMD program, same uniform
    slab schedule as :func:`spgemm_dist_spmd`; returns a global host CSR."""
    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = S.n_shards
    A_rel, lb_iptr, lb_ind, lb_dat, halo_rows, halo_counts = partition_halo(S, B)
    if pattern is None:
        pattern = _detect_shard_pattern(S, B)

    cls, counts, npa_max, nnz_s = _per_shard_sizing(
        A_rel, B, W, classes, b_iptr_per_shard=lb_iptr
    )
    sched, starts, cnts, _ = _uniform_schedule(
        counts=counts[:, : len(classes) + 1], classes=classes, slot_budget=slot_budget
    )
    tail_per_shard = counts[:, len(classes)]
    lenB_loc = lb_iptr[:, 1:] - lb_iptr[:, :-1]
    nsegB = int(((lenB_loc + W - 1) // W).sum(axis=1).max())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B.data.dtype), _nseg_pad(nsegB)),
    )
    schedule = tuple(sched)
    run = _make_spmd_run(mesh, axis, schedule, kw, W, accum_dtype, pattern,
                         b_sharded=True)

    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab = np.stack([starts, cnts], axis=1)
    rows_sorted, outs = run(
        dev(np.asarray(A_rel.indptr, np.int32)),
        dev(np.asarray(A_rel.indices, np.int32)),
        dev(np.asarray(A_rel.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        dev(sc_tab),
        dev(lb_iptr.astype(np.int32)),
        dev(lb_ind),
        dev(lb_dat),
    )

    # host assembly (columns are global; same shape as the replicated path)
    row_starts = np.asarray(S.row_starts, np.int64)
    rows_l, cols_l, vals_l = _pull_shard_chunks(outs, row_starts, nsh)
    if tail_per_shard.sum():
        # heavy-tail fallback: rows past the class ceiling route through the
        # global-sort host path against the FULL B (their working set is by
        # definition unbounded — exactly the rows the halo restriction cannot
        # bound); on power-law graphs they are a handful per shard
        _append_shard_tails(
            rows_sorted, counts, len(classes), tail_per_shard, S, B,
            accum_dtype, row_starts, rows_l, cols_l, vals_l,
        )
    return _finish_global_csr(rows_l, cols_l, vals_l, (S.shape[0], B.ncol))


# ---------------------------------------------------------------------------
# runtime halo exchange: B row-BLOCK sharded, working sets fetched in-program
# ---------------------------------------------------------------------------


def _exchange_maps(halo_rows, b_part, b_iptr_global, *, qe=None, loc_pad=None,
                   sizes_only=False):
    """Host metadata for the in-program halo exchange (O(halo nnz) ints —
    the row DATA moves device-to-device, only these index maps are built on
    host).

    For each (owner t → requester s) pair: the flat element indices into
    owner t's local B arrays covering the rows s requests, padded per pair to
    a uniform Qe; and for each requester the gather map that compacts the
    owner-major received buffer into its local halo CSR element order
    (halo rows are sorted ascending, so owner blocks arrive in exactly local
    row order — the compaction only removes per-pair padding).

    ``qe``/``loc_pad`` force the per-pair / per-shard paddings (must cover
    the computed minima) — the streamed big path runs ONE compiled exchange
    program across pieces, so every piece's maps are padded to the
    piece-wise maxima.  ``sizes_only=True`` returns just ``(Qe,
    nnzB_loc_pad)`` without materializing the maps (the cheap first pass
    that finds those maxima)."""
    nsh = b_part.n_shards
    rb = b_part.rows_per_shard
    lptr = np.asarray(b_part.indptr, np.int64)  # (nsh, rb+1) local offsets
    lens_g = b_iptr_global[1:] - b_iptr_global[:-1]

    pair_nnz = np.zeros((nsh, nsh), np.int64)
    pair_rows = [[None] * nsh for _ in range(nsh)]
    for s in range(nsh):
        u = halo_rows[s]
        own = (u // rb).astype(np.int64)
        for t in np.unique(own):
            rows_t = u[own == t]
            pair_rows[s][int(t)] = rows_t
            pair_nnz[s, int(t)] = int(lens_g[rows_t].sum())
    Qe_min = _round_up(max(int(pair_nnz.max()), 1), 128)
    Qe = qe if qe is not None else Qe_min
    assert Qe >= Qe_min, (Qe, Qe_min)
    loc_min = _round_up(max(int(pair_nnz.sum(axis=1).max()), 1), 128)
    if sizes_only:
        return Qe_min, loc_min

    nnzB_pad_part = b_part.indices.shape[1]
    send_src = np.full((nsh, nsh, Qe), nnzB_pad_part - 1, np.int32)
    for t in range(nsh):
        for s in range(nsh):
            rows_t = pair_rows[s][t]
            if rows_t is None:
                continue
            lr = rows_t - t * rb
            lens = (lptr[t, lr + 1] - lptr[t, lr]).astype(np.int64)
            nz = int(lens.sum())
            if nz == 0:
                continue
            pos = np.arange(nz, dtype=np.int64)
            st = np.zeros(len(lr) + 1, np.int64)
            np.cumsum(lens, out=st[1:])
            rof = np.searchsorted(st, pos, side="right") - 1
            send_src[t, s, :nz] = (lptr[t, lr[rof]] + (pos - st[rof])).astype(
                np.int32
            )

    nnzB_loc_pad = loc_pad if loc_pad is not None else loc_min
    assert nnzB_loc_pad >= loc_min, (nnzB_loc_pad, loc_min)
    recv_gather = np.zeros((nsh, nnzB_loc_pad), np.int32)
    for s in range(nsh):
        pieces = [
            np.arange(int(pair_nnz[s, t]), dtype=np.int32) + t * Qe
            for t in range(nsh)
            if pair_nnz[s, t]
        ]
        if pieces:
            cat = np.concatenate(pieces)
            recv_gather[s, : len(cat)] = cat
    return send_src, recv_gather, nnzB_loc_pad


def spgemm_dist_halo_exchange(
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
):
    """C = A @ B with B **row-block sharded** and each shard's halo working
    set fetched at runtime by an ``all_to_all`` collective INSIDE the SPMD
    program (SURVEY.md §2.12's halo exchange).

    Unlike :func:`spgemm_dist_halo` — which builds every shard's full B
    working set on the host and ships it at launch — no device ever holds
    more than its own ``nnz(B)/n_shards`` block plus exchange buffers, and
    the collective is visible in the compiled HLO.  In pattern mode only
    column ids are exchanged (values are all 1.0 — half the wire traffic).
    Returns a global host CSR; heavy-tail rows use the host fallback."""
    from spmm_tpu.parallel.partition import partition_rows

    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = S.n_shards
    A_rel, lb_iptr, _lb_ind, _lb_dat, halo_rows, halo_counts = partition_halo(
        S, B, structure_only=True  # elements travel in-program (all_to_all)
    )
    if pattern is None:
        pattern = _detect_shard_pattern(S, B)

    cls, counts, npa_max, nnz_s = _per_shard_sizing(
        A_rel, B, W, classes, b_iptr_per_shard=lb_iptr
    )
    sched, starts, cnts, _ = _uniform_schedule(
        counts=counts[:, : len(classes) + 1], classes=classes, slot_budget=slot_budget
    )
    tail_per_shard = counts[:, len(classes)]

    # B row-block sharded: the owner layout the exchange pulls from
    b_part = partition_rows(B, nsh)
    Bh = B.host()
    b_iptr_g = np.asarray(Bh.indptr, np.int64)
    send_src, recv_gather, nnzB_loc_pad = _exchange_maps(
        halo_rows, b_part, b_iptr_g
    )
    # loc_iptr rows cover nnzB_loc elements; pad rows stay at the last value
    lenB_loc = lb_iptr[:, 1:] - lb_iptr[:, :-1]
    nsegB = int(((lenB_loc + W - 1) // W).sum(axis=1).max())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B.data.dtype), _nseg_pad(nsegB)),
    )
    run = _make_spmd_run(
        mesh, axis, tuple(sched), kw, W, accum_dtype, pattern,
        b_sharded=True, exchange=True,
    )

    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab = np.stack([starts, cnts], axis=1)
    rows_sorted, outs = run(
        dev(np.asarray(A_rel.indptr, np.int32)),
        dev(np.asarray(A_rel.indices, np.int32)),
        dev(np.asarray(A_rel.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        dev(sc_tab),
        dev(np.asarray(b_part.indptr, np.int32)),
        dev(np.asarray(b_part.indices, np.int32)),
        dev(np.asarray(b_part.data)),
        dev(send_src),
        dev(recv_gather),
        dev(lb_iptr.astype(np.int32)),
    )

    row_starts = np.asarray(S.row_starts, np.int64)
    rows_l, cols_l, vals_l = _pull_shard_chunks(outs, row_starts, nsh)
    if tail_per_shard.sum():
        _append_shard_tails(
            rows_sorted, counts, len(classes), tail_per_shard, S, B,
            accum_dtype, row_starts, rows_l, cols_l, vals_l,
        )
    return _finish_global_csr(rows_l, cols_l, vals_l, (S.shape[0], B.ncol))


# ---------------------------------------------------------------------------
# two-phase distributed SpGEMM (plan once / multiply many, the distributed
# mirror of ops.slab_spgemm.spgemm_plan + its class-aligned cache)
# ---------------------------------------------------------------------------

import dataclasses


@dataclasses.dataclass
class DistSpgemmPlan:
    """Row-sharded symbolic phase: per-shard class-aligned pre-expanded
    partials (flat blocks, one per uniform-schedule entry) + the runtime
    scalar tables, all resident on the mesh.  Heavy-tail products (host
    fallback) are structure+value dependent and therefore precomputed once
    here too.  Re-execution (:func:`spgemm_dist_exec`) runs ONE gather-free
    SPMD program: dynamic_slice, batched sort, merge — no collectives, no
    per-multiply host work beyond the assembly."""

    rows_sorted: jax.Array  #: (nsh, nrow_pad), sharded over the mesh axis
    sc_tab: jax.Array  #: (nsh, 2, nchunks) runtime (start, count) scalars
    aligned_cols: tuple  #: sharded (nsh, R_pad*L) flat blocks per entry
    aligned_vals: tuple  #: value-mode companions (empty in pattern mode)
    schedule: tuple  #: ((L, R_pad), ...) uniform over shards
    tail: tuple  #: host (rows_l, cols_l, vals_l) lists, global row ids
    row_starts: np.ndarray
    shape: tuple
    axis: str
    pattern: bool
    accum_dtype: object
    n_shards: int


#: memoized plan-phase SPMD programs (mirror of _SPMD_RUN_CACHE for the
#: numeric run): repeated spgemm_dist_plan calls with the same configuration
#: — in particular spgemm_dist_revalue — reuse the jitted callable instead
#: of paying a full shard_map retrace per build.
_PLAN_RUN_CACHE: dict = {}


def _make_plan_run(mesh, axis, schedule, kw, W, accum_dtype, pattern, b_sharded):
    key = (
        mesh, axis, tuple(schedule), tuple(sorted(kw.items())), W,
        str(jnp.dtype(accum_dtype).name), pattern, b_sharded,
    )
    run = _PLAN_RUN_CACHE.get(key)
    if run is not None:
        return run

    spec_sh = P(axis)
    b_spec = spec_sh if b_sharded else P()
    n_extra = 3 if b_sharded else 0
    out_specs = (
        spec_sh,
        tuple(spec_sh for _ in schedule),
        tuple(spec_sh for _ in schedule) if not pattern else (),
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_sh,) * 6 + (b_spec,) * 3 + (spec_sh,) * n_extra,
        out_specs=out_specs,
        check_vma=False,
    )
    def run_plan(indptr, ind, dat, cls_s, nnz_sc, sc_tab, b_indptr, b_ind,
                 b_dat, *extra):
        indptr, ind, dat = indptr[0], ind[0], dat[0]
        cls_s, nnz_sc, sc_tab = cls_s[0], nnz_sc[0], sc_tab[0]
        if b_sharded:
            b_indptr, b_ind, b_dat = b_indptr[0], b_ind[0], b_dat[0]
            b_indptr, b_ind, b_dat = _exchange_halo_body(
                b_ind, b_dat, extra, axis, pattern
            )
        (b2p, pap, rowmeta, _rows_sorted) = _plan_body(
            indptr, ind, dat, b_indptr, b_ind, b_dat, cls_s, nnz=nnz_sc[0],
            pattern=pattern, **kw
        )
        a_dt, b_dt = str(dat.dtype), str(b_dat.dtype)
        cols_t, vals_t = [], []
        for i, (L, R_pad) in enumerate(schedule):
            start, cnt = sc_tab[0, i], sc_tab[1, i]
            nblk = L // W
            base, nb, bm = _chunk_meta(rowmeta, start, cnt, R_pad, nblk)
            col, val = _chunk_fetch(
                b2p, pap, base, nb, bm,
                L=L, R_pad=R_pad, W=W, a_dtype=a_dt, b_dtype=b_dt,
                accum_dtype=accum_dtype, pattern=pattern,
                b2_ws=kw.get("b2_ws"),
            )
            cols_t.append(col.reshape(-1)[None])
            if val is not None:
                vals_t.append(val.reshape(-1)[None])
        return _rows_sorted[None], tuple(cols_t), tuple(vals_t)

    run = jax.jit(run_plan)  # see _make_spmd_run: unjitted = eager
    if len(_PLAN_RUN_CACHE) > 32:
        _PLAN_RUN_CACHE.pop(next(iter(_PLAN_RUN_CACHE)))
    _PLAN_RUN_CACHE[key] = run
    return run


def spgemm_dist_plan(
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
    b_sharded: bool = False,
) -> DistSpgemmPlan:
    """Distributed symbolic phase for C = A @ B (A row-sharded): per-shard
    sizing, plan, and class-aligned expansion in one SPMD program; heavy-tail
    products precomputed via the host fallback.

    ``b_sharded=False``: B replicated per device (random access to all rows).
    ``b_sharded=True``: B row-BLOCK sharded; each shard's halo working set is
    fetched by an in-program ``all_to_all`` AT PLAN TIME ONLY (the runtime
    exchange of :func:`spgemm_dist_halo_exchange`), and the class-aligned
    cache persists device-resident per shard — so re-execution via
    :func:`spgemm_dist_exec` is collective-free and no device ever holds a
    full B replica.  This is what makes the two-phase (plan-reuse) path and
    the memory-scalable (sharded-B) path composable at >=100M-nnz scale
    (SURVEY.md §2.12)."""
    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = S.n_shards
    if pattern is None:
        pattern = _detect_shard_pattern(S, B)
    Bh = B.host()
    if b_sharded:
        from spmm_tpu.parallel.partition import partition_rows

        A_sz, lb_iptr, _li, _ld, halo_rows, _hc = partition_halo(
            S, B, structure_only=True
        )
        cls, counts, npa_max, nnz_s = _per_shard_sizing(
            A_sz, B, W, classes, b_iptr_per_shard=lb_iptr
        )
        b_part = partition_rows(B, nsh)
        b_iptr_g = np.asarray(Bh.indptr, np.int64)
        send_src, recv_gather, _ = _exchange_maps(halo_rows, b_part, b_iptr_g)
        lenB_loc = lb_iptr[:, 1:] - lb_iptr[:, :-1]
        nsegB = int(((lenB_loc + W - 1) // W).sum(axis=1).max())
    else:
        A_sz = S
        cls, counts, npa_max, nnz_s = _per_shard_sizing(S, B, W, classes)
        b_iptr = np.asarray(Bh.indptr, dtype=np.int64)
        lenB = b_iptr[1:] - b_iptr[:-1]
        nsegB = int(((lenB + W - 1) // W).sum())
    sched, starts, cnts, _ = _uniform_schedule(
        counts=counts[:, : len(classes) + 1], classes=classes,
        slot_budget=slot_budget,
    )
    tail_per_shard = counts[:, len(classes)]

    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B.data.dtype), _nseg_pad(nsegB)),
    )
    schedule = tuple(sched)

    run_plan = _make_plan_run(
        mesh, axis, schedule, kw, W, accum_dtype, pattern, b_sharded
    )
    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab_h = np.stack([starts, cnts], axis=1)  # (nsh, 2, nchunks)
    sc_tab_d = dev(sc_tab_h)
    rows_sorted, aligned_cols, aligned_vals = run_plan(
        dev(np.asarray(A_sz.indptr, np.int32)),
        dev(np.asarray(A_sz.indices, np.int32)),
        dev(np.asarray(A_sz.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        sc_tab_d,
        *(
            (
                dev(np.asarray(b_part.indptr, np.int32)),
                dev(np.asarray(b_part.indices, np.int32)),
                dev(np.asarray(b_part.data)),
                dev(send_src),
                dev(recv_gather),
                dev(lb_iptr.astype(np.int32)),
            )
            if b_sharded
            else (
                jnp.asarray(Bh.indptr, jnp.int32),
                jnp.asarray(Bh.indices, jnp.int32),
                jnp.asarray(Bh.data),
            )
        ),
    )

    # heavy-tail products: structure+value dependent -> cache in the plan
    row_starts = np.asarray(S.row_starts, np.int64)
    rows_l, cols_l, vals_l = [], [], []
    if tail_per_shard.sum():
        _append_shard_tails(
            rows_sorted, counts, len(classes), tail_per_shard, S, B,
            accum_dtype, row_starts, rows_l, cols_l, vals_l,
        )
    _rebuild = dict(
        classes=classes, seg_w=W, slot_budget=slot_budget, kw=kw,
        cls=cls, counts=counts, nnz_s=nnz_s, b_sharded=b_sharded,
        a_indices=np.asarray(A_sz.indices), a_indptr=np.asarray(A_sz.indptr),
        exchange=(send_src, recv_gather, lb_iptr) if b_sharded else None,
        a_nnz=S.nnz, b_nnz=B.nnz,
    )
    plan = DistSpgemmPlan(
        rows_sorted=rows_sorted,
        sc_tab=sc_tab_d,
        aligned_cols=tuple(aligned_cols),
        aligned_vals=tuple(aligned_vals),
        schedule=schedule,
        tail=(rows_l, cols_l, vals_l),
        row_starts=row_starts,
        shape=(S.shape[0], B.ncol),
        axis=axis,
        pattern=pattern,
        accum_dtype=accum_dtype,
        n_shards=nsh,
    )
    plan._rebuild = _rebuild  # structure-only metadata for spgemm_dist_revalue
    return plan


def spgemm_dist_revalue(
    plan: DistSpgemmPlan,
    S: ShardedCSR,
    B: CSR,
    mesh: Mesh,
) -> DistSpgemmPlan:
    """New distributed plan for NEW VALUES on the SAME sparsity structure —
    the distributed mirror of :func:`spmm_tpu.ops.slab_spgemm.
    spgemm_plan_revalue` (cuSPARSE spgemm-reuse contract: iterative
    workloads update weights each step, structure fixed).

    Reuses from ``plan``: the per-shard sizing (cls/counts/schedule), the
    relabeled A structure, the exchange maps (sharded-B mode), and the
    already-compiled plan-phase SPMD program (``_PLAN_RUN_CACHE``) — only
    the value arrays re-upload and the one plan dispatch re-executes.  The
    caller guarantees S/B carry exactly the structure ``plan`` was built
    from (nnz validated, like cuSPARSE)."""
    rb = getattr(plan, "_rebuild", None)
    if rb is None:
        raise ValueError("plan lost its rebuild metadata (serialized?); "
                         "rebuild with spgemm_dist_plan")
    if S.nnz != rb["a_nnz"] or B.nnz != rb["b_nnz"]:
        raise ValueError(
            f"operand structure differs from the plan's: nnz {S.nnz}/{B.nnz} "
            f"vs plan {rb['a_nnz']}/{rb['b_nnz']}"
        )
    axis = plan.axis
    nsh = plan.n_shards
    accum_dtype = plan.accum_dtype
    pattern = plan.pattern
    classes = rb["classes"]
    run_plan = _make_plan_run(
        mesh, axis, plan.schedule, rb["kw"], rb["seg_w"], accum_dtype,
        pattern, rb["b_sharded"],
    )
    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    Bh = B.host()
    if rb["b_sharded"]:
        from spmm_tpu.parallel.partition import partition_rows

        send_src, recv_gather, lb_iptr = rb["exchange"]
        b_part = partition_rows(B, nsh)
        b_args = (
            dev(np.asarray(b_part.indptr, np.int32)),
            dev(np.asarray(b_part.indices, np.int32)),
            dev(np.asarray(b_part.data)),
            dev(send_src),
            dev(recv_gather),
            dev(lb_iptr.astype(np.int32)),
        )
    else:
        b_args = (
            jnp.asarray(Bh.indptr, jnp.int32),
            jnp.asarray(Bh.indices, jnp.int32),
            jnp.asarray(Bh.data),
        )
    rows_sorted, aligned_cols, aligned_vals = run_plan(
        dev(rb["a_indptr"].astype(np.int32)),
        dev(rb["a_indices"].astype(np.int32)),
        dev(np.asarray(S.data)),
        dev(rb["cls"]),
        dev(rb["nnz_s"][:, None]),
        plan.sc_tab,
        *b_args,
    )
    counts = rb["counts"]
    tail_per_shard = counts[:, len(classes)]
    rows_l, cols_l, vals_l = [], [], []
    if tail_per_shard.sum():
        _append_shard_tails(
            rows_sorted, counts, len(classes), tail_per_shard, S, B,
            accum_dtype, np.asarray(plan.row_starts, np.int64),
            rows_l, cols_l, vals_l,
        )
    new = DistSpgemmPlan(
        rows_sorted=rows_sorted,
        sc_tab=plan.sc_tab,
        aligned_cols=tuple(aligned_cols),
        aligned_vals=tuple(aligned_vals),
        schedule=plan.schedule,
        tail=(rows_l, cols_l, vals_l),
        row_starts=plan.row_starts,
        shape=plan.shape,
        axis=axis,
        pattern=pattern,
        accum_dtype=accum_dtype,
        n_shards=nsh,
    )
    new._rebuild = rb
    return new


def spgemm_dist_exec(plan: DistSpgemmPlan, mesh: Mesh, *, as_csr: bool = True):
    """Numeric phase over a :class:`DistSpgemmPlan`: one gather-free SPMD
    program (dynamic_slice + batched sort + merge per chunk), then host
    assembly (``as_csr=True``) or the raw sharded chunk outputs."""
    schedule = plan.schedule
    pattern = plan.pattern
    accum_dtype = plan.accum_dtype
    spec_sh = P(plan.axis)
    out_specs = tuple((spec_sh,) * 4 for _ in schedule)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_sh, spec_sh)
        + (spec_sh,) * (len(plan.aligned_cols) + len(plan.aligned_vals)),
        out_specs=out_specs,
        check_vma=False,
    )
    def run_numeric(rows_sorted, sc_tab, *blocks):
        rows_sorted, sc_tab = rows_sorted[0], sc_tab[0]
        ncols = len(schedule)
        cols_b = blocks[:ncols]
        vals_b = blocks[ncols:]
        outs = []
        for i, (L, R_pad) in enumerate(schedule):
            start = sc_tab[0, i]
            r = jax.lax.dynamic_slice(rows_sorted, (start,), (R_pad,))
            col = cols_b[i][0].reshape(R_pad, L)
            val = vals_b[i][0].reshape(R_pad, L) if not pattern else None
            outs.append(
                (r,)
                + _merge_block(
                    col, val, L=L, R_pad=R_pad, accum_dtype=accum_dtype,
                    pattern=pattern,
                )
            )
        return tuple(tuple(x[None] for x in o) for o in outs)

    run_numeric = jax.jit(run_numeric)  # see _make_spmd_run: unjitted = eager
    outs = run_numeric(
        plan.rows_sorted, plan.sc_tab, *plan.aligned_cols, *plan.aligned_vals
    )
    if not as_csr:
        return outs
    rows_l, cols_l, vals_l = _pull_shard_chunks(outs, plan.row_starts, plan.n_shards)
    tr, tc, tv = plan.tail
    rows_l += tr
    cols_l += tc
    vals_l += tv
    return _finish_global_csr(rows_l, cols_l, vals_l, plan.shape)


# ---------------------------------------------------------------------------
# streamed distributed SpGEMM: the >=100M-nnz regime over a device mesh
# (the piece streaming of spgemm_slab_big composed with the row-sharded SPMD execution)
# ---------------------------------------------------------------------------


def _merge_tail_into_triple(triple, trows, tcols, tvals, rows_pad, ncol):
    """Insert heavy-tail products (block-local row ids) into a block's
    compacted CSR triple.  Tail rows are empty in the device-compacted CSR
    (their products never enter the slabs), so this is a disjoint row merge:
    expand, append, counting-sort reassemble."""
    from spmm_tpu.ops.slab_spgemm import _assemble_csr

    data, indices, indptr = triple
    lens = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(rows_pad, dtype=np.int64), lens)
    C = _assemble_csr(
        np.concatenate([rows, trows]),
        np.concatenate([indices.astype(np.int64), tcols]),
        np.concatenate([data, tvals.astype(data.dtype, copy=False)]),
        (rows_pad, ncol),
    )
    return (
        np.asarray(C.data[: C.nnz]),
        np.asarray(C.indices[: C.nnz], np.int32),
        np.asarray(C.indptr, np.int64),
    )


def spgemm_dist_big(
    A: CSR,
    B: CSR,
    mesh: Mesh,
    *,
    axis: str = "rows",
    pieces: int | None = None,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
    b_sharded: bool = False,
) -> CSR:
    """C = A @ B streamed over a device mesh, end to end:
    row-partitioned SpGEMM at the >=100M-nnz scale where neither the plan
    tables nor the output fit one program.

    Composition of the repo's two halves (each previously only solo):

    - the OUTER split is the mesh: A's rows are block-sharded over
      ``mesh[axis]`` (the reference's region split writ large,
      transmat.h:334-376 / SURVEY.md §2.12);
    - the INNER split is streaming: each shard's row block is cut into ``P``
      uniform pieces (``spgemm_slab_big``'s piece loop), and piece ``p`` of
      ALL shards runs concurrently as ONE compiled SPMD program with
      per-shard runtime scalars — ``P`` dispatches total, each compacting
      its per-shard CSR on device (``_compact_to_csr``) so only real
      nonzeros ever leave the mesh.

    Heavy-tail rows (padded expansion past the class ceiling) are computed
    by the host fallback per block and merged in during assembly.
    ``checkpoint_dir`` persists each completed piece (all shards' triples in
    one file) with a sha256-pinned manifest; a re-run resumes after the last
    finished piece.  Returns the assembled global host CSR.

    ``b_sharded=False`` (default): B replicated per device (~8 bytes per
    nnz(B) on every device).  ``b_sharded=True``: B is
    row-BLOCK sharded across the mesh and each piece's per-shard halo
    working set is fetched at runtime by the in-program ``all_to_all``
    (``spgemm_dist_halo_exchange``'s collective) — no device ever holds a
    full B replica, completing the streaming × sharded-B composition
    matrix for config 5.  All pieces still share ONE compiled program: the
    exchange-map paddings (Qe / local-nnz / local-rows) are sized to the
    piece-wise maxima in a cheap first pass."""
    from spmm_tpu.ops import slab_spgemm as _slab
    from spmm_tpu.parallel.partition import partition_rows

    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    nsh = mesh.shape[axis]
    if pattern is None:
        from spmm_tpu.ops.slab_spgemm import _is_pattern

        pattern = (
            isinstance(A.data, np.ndarray)
            and isinstance(B.data, np.ndarray)
            and _is_pattern(A)
            and _is_pattern(B)
        )

    # ---- auto piece count: grow P until every block's padded expansion
    # fits the per-program budget (same loop as spgemm_slab_big, but the
    # unit is a (shard, piece) block of nsh * P total) ----------------------
    P_cnt = pieces or 1
    while True:
        S = partition_rows(A, nsh * P_cnt)
        at_min = S.rows_per_shard <= 1 or nsh * P_cnt >= A.nrow
        try:
            cls, counts, npa_max, nnz_s = _per_shard_sizing(S, B, W, classes)
        except ValueError:
            if at_min:
                raise
            P_cnt *= 2
            continue
        if pieces is not None or npa_max * W <= _slab._MAX_EXP_PAD or at_min:
            break
        P_cnt *= 2

    ncls = len(classes)
    sched, starts, cnts, _ = _uniform_schedule(
        counts=counts[:, : ncls + 1], classes=classes, slot_budget=slot_budget
    )
    tail_per_block = counts[:, ncls]
    schedule = tuple(sched)
    sc_tab_all = np.stack([starts, cnts], axis=1)  # (nsh*P, 2, nchunks)

    Bh = B.host()
    b_iptr64 = np.asarray(Bh.indptr, np.int64)
    s_ind = np.asarray(S.indices)
    s_dat = np.asarray(S.data)
    s_iptr = np.asarray(S.indptr)
    iptr64 = s_iptr.astype(np.int64)
    accum_np = np.dtype(jnp.dtype(accum_dtype).name)
    row_starts_all = np.asarray(S.row_starts, np.int64)

    def _piece_view(blocks):
        import dataclasses as _dc

        return _dc.replace(
            S,
            data=s_dat[blocks],
            indices=s_ind[blocks],
            indptr=s_iptr[blocks],
            row_starts=row_starts_all[blocks].astype(np.int32),
            n_shards=nsh,
        )

    if b_sharded:
        # --- sharded-B streaming: halo structure + exchange-map sizing per
        # piece (cheap pass 1), maps materialized per piece in the loop
        # (pass 2) at the UNIFORM piece-wise-max paddings so every piece
        # runs the same compiled exchange program -------------------------
        b_part = partition_rows(B, nsh)
        qe_max, loc_pad_max, nrow_loc_max, nseg_loc_max = 1, 1, 1, 1
        for p in range(P_cnt):
            blocks = np.arange(nsh) * P_cnt + p
            _, lb_iptr_p, _, _, halo_rows_p, _ = partition_halo(
                _piece_view(blocks), B, structure_only=True
            )
            qe_p, loc_p = _exchange_maps(
                halo_rows_p, b_part, b_iptr64, sizes_only=True
            )
            qe_max = max(qe_max, qe_p)
            loc_pad_max = max(loc_pad_max, loc_p)
            nrow_loc_max = max(nrow_loc_max, lb_iptr_p.shape[1] - 1)
            lens_loc = lb_iptr_p[:, 1:] - lb_iptr_p[:, :-1]
            nseg_loc_max = max(
                nseg_loc_max, int(((lens_loc + W - 1) // W).sum(axis=1).max())
            )
        nsegB = nseg_loc_max
    else:
        lenB = b_iptr64[1:] - b_iptr64[:-1]
        nsegB = int(((lenB + W - 1) // W).sum())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=_nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(Bh.data.dtype), _nseg_pad(nsegB)),
    )
    nnz_pad_piece = _round_up(npa_max * W, 1024)
    # an EMPTY schedule (every row past the class ceiling) means there is no
    # slab program to run at all — each block's whole product goes through
    # the host tail fallback below (tracing the compact program with zero
    # chunks would crash inside _compact_to_csr)
    run = (
        _make_spmd_run(
            mesh, axis, schedule, kw, W, accum_dtype, pattern,
            b_sharded=b_sharded, compact_nnz_pad=nnz_pad_piece,
            exchange=b_sharded,
        )
        if schedule
        else None
    )

    ckpt = (
        _slab._BigCheckpoint(
            checkpoint_dir, A, B, P_cnt, classes, W, slot_budget,
            str(jnp.dtype(accum_dtype).name), pattern,
            extra={"dist_nsh": int(nsh), "b_sharded": bool(b_sharded)},
        )
        if checkpoint_dir is not None
        else None
    )

    sharding = NamedSharding(mesh, P(axis))
    dev = lambda a: jax.device_put(np.ascontiguousarray(a), sharding)
    if b_sharded:
        b_dev = (
            dev(np.asarray(b_part.indptr, np.int32)),
            dev(np.asarray(b_part.indices, np.int32)),
            dev(np.asarray(b_part.data)),
        )
    else:
        b_dev = (
            jnp.asarray(Bh.indptr, jnp.int32),
            jnp.asarray(Bh.indices, jnp.int32),
            jnp.asarray(Bh.data),
        )

    # blocks: b = s * P + p  (shard s's rows are blocks [s*P, (s+1)*P), so
    # global row order == block order; piece p runs blocks {s*P + p})
    piece_results: list = [None] * P_cnt
    for p in range(P_cnt):
        if ckpt is not None:
            got = ckpt.load_multi(p, nsh)
            if got is not None:
                piece_results[p] = got
                continue
        blocks = np.arange(nsh) * P_cnt + p
        if b_sharded:
            # pass 2: relabeled A + exchange maps for THIS piece, padded to
            # the uniform piece-wise maxima (one compiled program)
            A_rel_p, lb_iptr_p, _, _, halo_rows_p, _ = partition_halo(
                _piece_view(blocks), B, structure_only=True
            )
            send_src_p, recv_gather_p, _ = _exchange_maps(
                halo_rows_p, b_part, b_iptr64, qe=qe_max, loc_pad=loc_pad_max
            )
            lbp = np.empty((nsh, nrow_loc_max + 1), np.int32)
            w0 = lb_iptr_p.shape[1]
            lbp[:, :w0] = lb_iptr_p
            lbp[:, w0:] = lb_iptr_p[:, -1:]  # pad rows stay empty (flat)
            a_feed = (
                dev(np.asarray(A_rel_p.indptr, np.int32)),
                dev(np.asarray(A_rel_p.indices, np.int32)),
                dev(np.asarray(A_rel_p.data)),
            )
            extra_feed = (dev(send_src_p), dev(recv_gather_p), dev(lbp))
        else:
            a_feed = (
                dev(s_iptr[blocks].astype(np.int32)),
                dev(s_ind[blocks].astype(np.int32)),
                dev(s_dat[blocks]),
            )
            extra_feed = ()
        if run is not None:
            rows_sorted, (data, indices, indptr, knnz) = run(
                *a_feed,
                dev(cls[blocks]),
                dev(nnz_s[blocks][:, None]),
                dev(sc_tab_all[blocks]),
                *b_dev,
                *extra_feed,
            )
            knnz_h = np.asarray(knnz).reshape(nsh)
        else:
            rows_sorted = data = indices = indptr = None
            knnz_h = np.zeros(nsh, np.int64)
        triples = []
        for s in range(nsh):
            b = int(blocks[s])
            k = int(knnz_h[s])
            if run is not None:
                tri = (
                    np.asarray(jax.device_get(data[s, :k])),
                    np.asarray(jax.device_get(indices[s, :k]), np.int32),
                    np.asarray(jax.device_get(indptr[s]), np.int64),
                )
            else:  # no slab chunks: start from an empty block CSR
                tri = (
                    np.zeros(0, accum_np),
                    np.zeros(0, np.int32),
                    np.zeros(rows_pad + 1, np.int64),
                )
            nt = int(tail_per_block[b])
            if nt:
                # tail rows = this block's rows of the sentinel class, in row
                # order — exactly the device's stable class sort's tail slice,
                # recovered host-side without a rows_sorted D2H
                trows = np.where(cls[b] == ncls)[0].astype(np.int64)
                assert len(trows) == nt, (len(trows), nt)
                sub_full = CSR(
                    data=s_dat[b],
                    indices=np.asarray(s_ind[b], np.int32),
                    indptr=iptr64[b],
                    shape=(rows_pad, A.shape[1]),
                    nnz=int(nnz_s[b]),
                )
                from spmm_tpu.ops.slab_spgemm import _tail_products

                tr, tc, tv = _tail_products(sub_full, trows, Bh, accum_dtype)
                tri = _merge_tail_into_triple(
                    (tri[0].astype(accum_np, copy=False), tri[1], tri[2]),
                    tr, tc, tv, rows_pad, B.ncol,
                )
            triples.append(tri)
        del rows_sorted, data, indices, indptr
        piece_results[p] = triples
        if ckpt is not None:
            ckpt.save_multi(p, triples)

    # ---- stitch: blocks in global row order (b = s*P + p ascending) -------
    datas, inds, iptrs = [], [], []
    off = 0
    first = True
    for b in range(nsh * P_cnt):
        s, p = divmod(b, P_cnt)
        d, i, ip = piece_results[p][s]
        ip = ip + off
        iptrs.append(ip if first else ip[1:])
        first = False
        off = int(ip[-1])
        datas.append(d)
        inds.append(i)
    indptr_full = np.concatenate(iptrs) if iptrs else np.zeros(1, np.int64)
    return CSR(
        data=np.concatenate(datas) if datas else np.zeros(0, accum_np),
        indices=np.concatenate(inds) if inds else np.zeros(0, np.int32),
        indptr=indptr_full[: A.nrow + 1],
        shape=(A.nrow, B.ncol),
        nnz=int(indptr_full[A.nrow]),
    )
