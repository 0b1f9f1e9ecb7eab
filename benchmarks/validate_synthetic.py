#!/usr/bin/env python
"""Workload validation for the synthetic stand-ins.

The benchmarks run without network access, so they use
``formats/synthetic.py:webgraph_like``.  This script measures the statistics
of the synthetic that DRIVE each benchmarked kernel and prints them next to
the published numbers of the real graphs they stand in for, so the proxy's
fidelity (and its known biases) are quantified rather than assumed.

Usage: python benchmarks/validate_synthetic.py [--full]
(--full also computes nnz(A^2) by scipy on the 916k-node graph: ~1 min)
"""
from __future__ import annotations

import argparse
import json

import numpy as np

# Published statistics (sources cached offline; SNAP dataset pages /
# SuiteSparse collection metadata as of training data):
#   web-Google : 916,428 node-id space (875,713 connected), 5,105,039 edges
#   web-Stanford: 281,903 nodes, 2,312,497 edges
#   sx-askubuntu: 159,316 nodes, 964,437 edges
# Web-graph degree power laws (Broder et al. 2000, "Graph structure in the
# web"): out-degree exponent ~2.72, in-degree ~2.1.
PUBLISHED = {
    "web-Google": dict(n=916_428, nnz=5_105_039, alpha_out=(2.5, 2.9), alpha_in=(2.0, 2.3)),
    "web-Stanford": dict(n=281_903, nnz=2_312_497, alpha_out=(2.5, 2.9), alpha_in=(2.0, 2.3)),
    "sx-askubuntu": dict(n=159_316, nnz=964_437, alpha_out=None, alpha_in=None),
}


def hill_alpha(deg: np.ndarray, k_frac: float = 0.01) -> float:
    """Hill estimator of the degree-distribution tail exponent alpha
    (P[deg >= d] ~ d^-(alpha-1)); uses the top k_frac order statistics."""
    d = np.sort(deg[deg > 0])[::-1].astype(np.float64)
    k = max(int(len(d) * k_frac), 10)
    k = min(k, len(d) - 1)
    xk = d[k]
    h = np.mean(np.log(d[:k] / xk))
    return 1.0 + 1.0 / max(h, 1e-12)


def stats(A, name, full=False):
    import scipy.sparse as sp

    iptr = np.asarray(A.indptr, np.int64)
    ind = np.asarray(A.indices, np.int64)[: A.nnz]
    out_deg = iptr[1:] - iptr[:-1]
    in_deg = np.bincount(ind, minlength=A.shape[1])
    expansion = int(out_deg[ind].sum())  # A x A partial products
    row = {
        "name": name,
        "n": A.shape[0],
        "nnz": int(A.nnz),
        "avg_deg": round(A.nnz / A.shape[0], 2),
        "max_out_deg": int(out_deg.max()),
        "max_in_deg": int(in_deg.max()),
        "empty_rows_frac": round(float((out_deg == 0).mean()), 4),
        "alpha_out_hill": round(hill_alpha(out_deg), 2),
        "alpha_in_hill": round(hill_alpha(in_deg), 2),
        "axa_expansion": expansion,
        "expansion_per_nnz": round(expansion / A.nnz, 2),
    }
    if full:
        S = sp.csr_matrix(
            (np.ones(A.nnz, np.float32), ind.astype(np.int32), iptr), shape=A.shape
        )
        C = S @ S
        row["axa_nnz"] = int(C.nnz)
        row["axa_compression"] = round(expansion / max(C.nnz, 1), 2)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    args = ap.parse_args()

    from spmm_tpu.formats.synthetic import webgraph_like

    for name, pub in PUBLISHED.items():
        A = webgraph_like(pub["n"], pub["nnz"], seed=0 if name == "web-Google" else 1)
        row = stats(A, name, full=args.full)
        row["nnz_vs_published"] = round(row["nnz"] / pub["nnz"], 4)
        row["published_alpha_out"] = pub["alpha_out"]
        row["published_alpha_in"] = pub["alpha_in"]
        print(json.dumps(row))


if __name__ == "__main__":
    main()
