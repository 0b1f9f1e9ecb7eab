"""Breadth-first search by frontier SpMV — level-synchronous graph traversal.

The fourth classic workload over the reference's web-graph matrices
(alongside pagerank/CG/triangle counting): BFS distance labeling is repeated
sparse matrix-vector products over the boolean semiring.  Shaped here as
a single compiled ``lax.while_loop`` whose body is one ELL SpMV on the
transposed adjacency (frontier push), a visited-mask update, and a distance
write — no host round-trips between levels; the loop exits on device when
the frontier empties.

Semiring note: over floats, ``(A^T f) > 0`` is exactly the boolean
or-and product for a 0/1 pattern matrix (reference ingest forces values to
1.0 — SURVEY.md §2.1 — so adjacency inputs are already 0/1).

Run:  python examples/bfs.py [--n 100000] [--nnz 600000] [--source 0]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def bfs(A, source: int, *, max_levels: int | None = None):
    """Level-synchronous BFS from ``source`` over the directed graph with
    adjacency CSR ``A`` (rows = src, cols = dst; values ignored, pattern
    semantics).  Returns int32 distances, -1 for unreachable.

    One compiled program: ``while frontier nonempty: frontier = A^T f
    & ~visited`` — the push direction rides the same transposed-adjacency
    SpMV chain as pagerank (examples/pagerank.py)."""
    import jax
    import jax.numpy as jnp

    from spmm_tpu.formats.ell import ell_pack
    from spmm_tpu.ops.ell_spmm import ell_spmv
    from spmm_tpu.ops.transform import transpose

    n = A.shape[0]
    At = transpose(A)
    # binarize so "values ignored" is actually true: with raw values,
    # negative or cancelling edge weights could sum to <= 0 and drop
    # frontier nodes from the `pushed > 0` test (padding stays zero)
    bdata = (np.asarray(At.data) != 0).astype(np.float32)
    At = type(At)(bdata, At.indices, At.indptr, At.shape, At.nnz)
    Et = ell_pack(At).device()
    max_levels = n if max_levels is None else max_levels

    def body(state):
        dist, frontier, level = state
        # next frontier: any in-neighbor in the current frontier, not seen
        pushed = ell_spmv(Et, frontier) > 0
        fresh = pushed & (dist < 0)
        dist = jnp.where(fresh, level + 1, dist)
        return dist, fresh.astype(jnp.float32), level + 1

    def cond(state):
        _, frontier, level = state
        return (jnp.sum(frontier) > 0) & (level < max_levels)

    dist0 = jnp.full((n,), -1, jnp.int32).at[source].set(0)
    f0 = jnp.zeros((n,), jnp.float32).at[source].set(1.0)

    dist, _, levels = jax.lax.while_loop(cond, body, (dist0, f0, jnp.int32(0)))
    # the loop runs one final iteration that discovers nothing; levels - 1 is
    # the eccentricity of ``source`` (the largest finite distance)
    return dist, max(int(levels) - 1, 0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=600_000)
    ap.add_argument("--source", type=int, default=0)
    args = ap.parse_args()

    from spmm_tpu.formats.synthetic import webgraph_like

    A = webgraph_like(args.n, args.nnz, seed=0)
    t0 = time.perf_counter()
    dist, levels = bfs(A, args.source)
    dist = np.asarray(dist)
    dt = time.perf_counter() - t0
    reached = int((dist >= 0).sum())
    print(
        f"bfs: n={args.n} nnz={A.nnz} source={args.source}: "
        f"{reached} reached in {levels} levels, "
        f"{dt*1e3:.1f} ms (incl. compile)"
    )


if __name__ == "__main__":
    main()
