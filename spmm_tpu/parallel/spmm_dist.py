"""Distributed SpMM / SpMV / SpGEMM via shard_map over a device mesh.

Realization of the scaling plan the reference implies but never
ships (SURVEY.md §2.12): row/block-partition the left matrix across devices;
RHS panels are either all-gathered (small B) or ring-shifted with ``ppermute``
so each shard streams remote panels through while computing (the bandwidth-
optimal schedule — each B shard crosses each link exactly once).

All functions work identically on a multi-GPU mesh and on a CPU mesh created
with ``--xla_force_host_platform_device_count`` (SURVEY.md §4.3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spmm_tpu.parallel.partition import ShardedCSR


def _local_spmm(data, indices, indptr, B, accum_dtype=jnp.float32):
    """Dense-RHS SpMM on one shard's padded CSR block (rows_pad, nnz_pad)."""
    from spmm_tpu.ops.segments import boundary_segments

    rows_pad = indptr.shape[0] - 1
    r = boundary_segments(indptr, data.shape[0])
    contrib = jnp.take(B, indices, axis=0).astype(accum_dtype) * data.astype(accum_dtype)[:, None]
    return jax.ops.segment_sum(contrib, r, num_segments=rows_pad, indices_are_sorted=True)


def spmm_dist(S: ShardedCSR, B: jax.Array, mesh: Mesh, *, axis: str = "rows") -> jax.Array:
    """Y = A @ B with A row-sharded and B row-sharded over ``axis``.

    Each shard all-gathers B (one collective) then computes its row block.
    Returns Y as (n_shards, rows_pad, k), row-sharded over ``axis``.
    """
    n = mesh.shape[axis]
    assert S.n_shards == n, f"matrix has {S.n_shards} shards, mesh axis {axis} has {n}"
    k = B.shape[-1]
    Bs = B.reshape(n, -1, k)  # row-sharded layout

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def step(data, indices, indptr, b_local):
        b = jax.lax.all_gather(b_local[0], axis, tiled=True)
        y = _local_spmm(data[0], indices[0], indptr[0], b)
        return y[None]

    # shard_map without jit executes eagerly (see spgemm_spmd._make_spmd_run)
    step = jax.jit(step)
    return step(jnp.asarray(S.data), jnp.asarray(S.indices), jnp.asarray(S.indptr), Bs)


def spmm_dist_ring(S: ShardedCSR, B: jax.Array, mesh: Mesh, *, axis: str = "rows") -> jax.Array:
    """Y = A @ B with B ring-shifted instead of all-gathered.

    Bandwidth-optimal when B is too large to replicate: at step t each shard
    multiplies against the B panel originally owned by shard (me + t) and
    passes its current panel to the left neighbor (``ppermute``),
    overlapping compute with the shift.  Only the nonzeros whose column falls
    inside the current panel contribute at each step (masked accumulate).
    """
    n = mesh.shape[axis]
    assert S.n_shards == n
    k = B.shape[-1]
    panel_rows = B.shape[0] // n
    Bs = B.reshape(n, panel_rows, k)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def step(data, indices, indptr, b_local):
        data, indices, indptr, b_local = data[0], indices[0], indptr[0], b_local[0]
        from spmm_tpu.ops.segments import boundary_segments

        me = jax.lax.axis_index(axis)
        rows_pad = indptr.shape[0] - 1
        r = boundary_segments(indptr, data.shape[0])
        perm = [(i, (i - 1) % n) for i in range(n)]  # pass panels leftwards

        def body(t, carry):
            y, panel = carry
            owner = (me + t) % n  # whose panel we currently hold
            lo = owner * panel_rows
            in_panel = (indices >= lo) & (indices < lo + panel_rows)
            local_idx = jnp.where(in_panel, indices - lo, 0)
            vals = jnp.where(in_panel, data, 0).astype(jnp.float32)
            contrib = jnp.take(panel, local_idx, axis=0) * vals[:, None]
            y = y + jax.ops.segment_sum(
                contrib, r, num_segments=rows_pad, indices_are_sorted=True
            )
            panel = jax.lax.ppermute(panel, axis, perm)
            return (y, panel)

        # mark the fresh accumulator as varying over the mesh axis (ppermute
        # output is varying, and scan carries must type-match)
        y0 = jax.lax.pcast(jnp.zeros((rows_pad, k), jnp.float32), (axis,), to="varying")
        y, _ = jax.lax.fori_loop(0, n, body, (y0, b_local))
        return y[None]

    # shard_map without jit executes eagerly (see spgemm_spmd._make_spmd_run)
    step = jax.jit(step)
    return step(jnp.asarray(S.data), jnp.asarray(S.indices), jnp.asarray(S.indptr), Bs)


def spmv_dist(S: ShardedCSR, x: jax.Array, mesh: Mesh, *, axis: str = "rows") -> jax.Array:
    """y = A @ x, row-sharded; x all-gathered."""
    y = spmm_dist(S, x[:, None], mesh, axis=axis)
    return y[..., 0]


def spmm_dist_colsplit(
    Sc, B: jax.Array, mesh: Mesh, *, axis: str = "rows"
) -> jax.Array:
    """Y = A @ B with the CONTRACTION axis sharded: A column-block sharded
    (``partition_cols``), B row-sharded to match — each shard computes a
    full-height partial product from its K slab with ZERO communication,
    then one ``psum_scatter`` row-shards the reduced Y (the tensor-parallel
    mirror of ``spmm_dist``'s data-parallel row split; bandwidth = exactly
    one Y pass over the interconnect, the collective's lower bound).

    Use when A's rows are few-but-dense or B is too tall to gather: the
    only traffic is the output reduction, never A or B.  Returns Y as
    (n_shards, rows_pad / n_shards, k), row-sharded over ``axis``.
    """
    n = mesh.shape[axis]
    assert Sc.n_shards == n, f"matrix has {Sc.n_shards} col shards, mesh axis {axis} has {n}"
    assert B.shape[0] == Sc.shape[1], (
        f"B has {B.shape[0]} rows but A has {Sc.shape[1]} columns"
    )
    k = B.shape[-1]
    # B rows grouped by the column blocks of A: pad to n * cols_per rows
    pad = Sc.n_shards * Sc.cols_per_shard - B.shape[0]
    if pad:
        B = jnp.concatenate([B, jnp.zeros((pad, k), B.dtype)])
    Bs = B.reshape(n, Sc.cols_per_shard, k)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    def step(data, indices, indptr, b_local):
        y_part = _local_spmm(data[0], indices[0], indptr[0], b_local[0])
        # (rows_pad, k) partials -> row-sharded reduced (rows_pad / n, k)
        y = jax.lax.psum_scatter(y_part, axis, scatter_dimension=0, tiled=True)
        return y[None]

    step = jax.jit(step)  # shard_map without jit executes eagerly
    return step(
        jnp.asarray(Sc.data), jnp.asarray(Sc.indices), jnp.asarray(Sc.indptr), Bs
    )
