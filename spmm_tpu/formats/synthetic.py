"""Deterministic synthetic sparse matrices.

The reference evaluates on SuiteSparse web graphs (web-Stanford, web-Google,
sx-askubuntu — reference README.md:12-18, matrix.txt:1).  This environment has
no network egress, so benchmarks and tests use structurally similar synthetic
graphs: square, power-law degree distribution, mixed local/global column
targets (web graphs have strong host-locality — runs of nearby columns — which
is exactly what the bitmap dominant-section reorder exploits).
"""

from __future__ import annotations

import numpy as np

from spmm_tpu.formats.containers import COO, CSR, to_csr


def webgraph_like(
    n: int,
    nnz: int,
    *,
    seed: int = 0,
    locality: float = 0.6,
    zipf_a: float = 2.72,
    empty_frac: float = 0.044,
    dtype=np.float32,
    match_nnz: bool = True,
) -> CSR:
    """Square web-graph-like matrix: power-law row degrees; a ``locality``
    fraction of each row's targets are near the diagonal (same 2048-column
    section), the rest hit popular global columns (zipf).

    Parameters are calibrated against published web-graph statistics
    (benchmarks/validate_synthetic.py):
    ``zipf_a=2.72`` is the web out-degree power-law exponent (Broder et al.
    2000) — multiplicative rescaling to the target density preserves it;
    ``empty_frac=0.044`` is the SuiteSparse web-Google id-space gap
    (916,428 ids vs 875,713 connected nodes — absent ids are all-zero rows);
    the in-degree tail (zipf 1.3 popularity mix) lands at Hill α≈2.0-2.3,
    matching the published 2.1.  ``match_nnz``: duplicate synthetic edges
    collapse on dedup, so edge generation is topped up until the simple
    graph's nnz is within 0.5% of the request — the synthetic then carries
    the same edge count as the real graph it stands in for."""
    rng = np.random.default_rng(seed)
    # power-law out-degrees normalized to hit ~nnz (scale-free: multiplying
    # preserves the tail exponent); cap near web-Google's max out-degree 456
    deg = rng.zipf(zipf_a, size=n).astype(np.int64)
    deg = np.minimum(deg, 512)
    scale = nnz / max(1, deg.sum())
    deg = np.maximum(1, (deg * scale)).astype(np.int64)
    deg = np.minimum(deg, 512)
    if empty_frac > 0.0:  # dangling/absent pages: all-zero rows
        deg[rng.random(n) < empty_frac] = 0
        nz = max(1, int(deg.sum()))
        deg = np.maximum((deg * (nnz / nz)), deg.astype(bool)).astype(np.int64)
    total = int(deg.sum())
    row = np.repeat(np.arange(n, dtype=np.int64), deg)

    def targets(row, rng):
        total = len(row)
        local = rng.random(total) < locality
        # local targets: same section as the row (web-host locality)
        sect = (row // 2048) * 2048
        local_col = sect + rng.integers(0, 2048, size=total)
        # global targets: popular columns (zipf rank → column id, hashed spread)
        rank = np.minimum(rng.zipf(1.3, size=total), n).astype(np.int64) - 1
        glob_col = (rank * 2654435761) % n
        col = np.where(local, local_col, glob_col)
        return np.minimum(col, n - 1)

    col = targets(row, rng)
    # real web graphs are simple (no multi-edges): duplicate synthetic edges
    # collapse to a single unit entry, matching the reference ingest's
    # forced-1.0 pattern semantics (serial_newblock_clock.cpp:84,96)
    for _ in range(4):
        key = row * n + col
        uniq = len(np.unique(key))
        missing = nnz - uniq
        if not match_nnz or missing <= max(2, nnz // 200):
            break
        # top-up: extra edges from rows sampled ∝ degree (tail stays put)
        extra_row = row[rng.integers(0, len(row), size=int(missing * 1.15))]
        extra_col = targets(extra_row, rng)
        row = np.concatenate([row, extra_row])
        col = np.concatenate([col, extra_col])

    dat = np.ones(len(row), dtype=dtype)
    coo = COO(
        row=row.astype(np.int32), col=col.astype(np.int32), data=dat,
        shape=(n, n), nnz=len(row),
    )
    A = to_csr(coo, sort_within_row=True, sum_duplicates=True)
    A.data[: A.nnz] = 1
    return A


def rmat_matrix(
    scale: int, edge_factor: int = 16, *, seed: int = 0, a=0.57, b=0.19, c=0.19, dtype=np.float32
) -> CSR:
    """Graph500-style RMAT generator (vectorized bit-recursion)."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    row = np.zeros(m, dtype=np.int64)
    col = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for bit in range(scale):
        r_bit = rng.random(m) > ab
        c_bit = np.where(r_bit, rng.random(m) > c_norm, rng.random(m) > a_norm)
        row |= r_bit.astype(np.int64) << bit
        col |= c_bit.astype(np.int64) << bit
    dat = np.ones(m, dtype=dtype)
    coo = COO(row=row.astype(np.int32), col=col.astype(np.int32), data=dat, shape=(n, n), nnz=m)
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)


def banded_random(n: int, band: int, density: float, *, seed: int = 0, dtype=np.float32) -> CSR:
    """Random matrix with nonzeros confined to a diagonal band — exercises the
    region splitter and panelizer with a bounded working set."""
    rng = np.random.default_rng(seed)
    per_row = max(1, int(band * density))
    row = np.repeat(np.arange(n, dtype=np.int64), per_row)
    off = rng.integers(-band // 2, band // 2 + 1, size=n * per_row)
    col = np.clip(row + off, 0, n - 1)
    dat = rng.standard_normal(n * per_row).astype(dtype)
    coo = COO(row=row.astype(np.int32), col=col.astype(np.int32), data=dat, shape=(n, n), nnz=len(row))
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)


def random_csr(nrow: int, ncol: int, density: float, *, seed: int = 0, dtype=np.float32) -> CSR:
    """Uniform random sparse matrix with real values (general, non-square OK)."""
    rng = np.random.default_rng(seed)
    nnz = max(1, int(nrow * ncol * density))
    row = rng.integers(0, nrow, size=nnz).astype(np.int32)
    col = rng.integers(0, ncol, size=nnz).astype(np.int32)
    dat = rng.standard_normal(nnz).astype(dtype)
    coo = COO(row=row, col=col, data=dat, shape=(nrow, ncol), nnz=nnz)
    return to_csr(coo, sort_within_row=True, sum_duplicates=True)
