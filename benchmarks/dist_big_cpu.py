"""End-to-end >=100M-nnz row-partitioned SpGEMM over the
8-device CPU mesh (SURVEY.md §4.3's distributed-without-a-cluster rig).

Composes the two halves that were previously only demonstrated separately:
the piece streaming of ``spgemm_slab_big`` and the
row-sharded SPMD execution of ``spgemm_spmd`` — via
:func:`spmm_tpu.parallel.spgemm_dist_big`.  Asserts EXACT scipy parity
(nnz, indptr, indices) of the stitched result.

The 8 virtual devices share the host's cores, so wall-clock measures
program-overhead and memory behavior, not speedup — the scaling story lives
in ``scaling_cpu.py`` / ``bench.py``'s shard-balance projection.

Run (background; takes tens of minutes at the full 10M/104M config):
  python benchmarks/dist_big_cpu.py --n 10000000 --nnz 104600000 --pieces 4
"""

import argparse
import json
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
from jax.sharding import Mesh


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--nnz", type=int, default=104_600_000)
    ap.add_argument("--pieces", type=int, default=4)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--skip-scipy", action="store_true")
    args = ap.parse_args()

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big

    t0 = time.perf_counter()
    A = webgraph_like(args.n, args.nnz, seed=args.seed)
    t_gen = time.perf_counter() - t0
    print(f"generated: n={A.shape[0]} nnz={A.nnz} ({t_gen:.1f}s)", flush=True)

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("rows",))
    t0 = time.perf_counter()
    C = spgemm_dist_big(A, A, mesh, pieces=args.pieces)
    t_mult = time.perf_counter() - t0
    print(
        f"dist_big: out_nnz={C.nnz} over {len(jax.devices())} shards x "
        f"{args.pieces} pieces in {t_mult:.1f}s",
        flush=True,
    )

    result = {
        "n": A.shape[0],
        "nnz_in": A.nnz,
        "nnz_out": C.nnz,
        "n_shards": len(jax.devices()),
        "pieces": args.pieces,
        "dist_big_s": round(t_mult, 1),
        "mnnz_out_per_s": round(C.nnz / t_mult / 1e6, 1),
    }
    if not args.skip_scipy:
        t0 = time.perf_counter()
        sA = A.to_scipy()
        sC = (sA @ sA).tocsr()
        sC.sum_duplicates()
        sC.sort_indices()
        t_ref = time.perf_counter() - t0
        assert C.nnz == sC.nnz, (C.nnz, sC.nnz)
        assert np.array_equal(np.asarray(C.indptr), sC.indptr.astype(np.int64))
        assert np.array_equal(np.asarray(C.indices[: C.nnz]), sC.indices)
        result["scipy_s"] = round(t_ref, 1)
        result["parity"] = "exact"
        print(f"scipy parity EXACT (nnz/indptr/indices) in {t_ref:.1f}s", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
