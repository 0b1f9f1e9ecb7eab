#!/usr/bin/env python
"""Executed SPMD SpGEMM scaling curve on a virtual CPU mesh.

The shard-balance number (bench.py ``spgemm_shard_balance_8``) is a
host-side projection; this script EXECUTES the SPMD SpGEMM program
(parallel/spgemm_spmd.py) at 1/2/4/8 virtual CPU devices on the SAME total
matrix and reports wall-clock per device count.

The N virtual shards share the host's cores, so perfect SPMD scaling shows
up as *constant* wall time (same total work, no added collectives in the
replicated-B path); the efficiency column is t(1)/t(N).  This curve
validates the program's overhead, not an interconnect.

Prints one JSON line; bench.py runs this as a subprocess (it must live in
its own process: the CPU device count flag is process-global).  The process
is pinned to the CPU before JAX is imported, so it never opens a GPU.
"""
from __future__ import annotations

import os
import sys

# run as `python benchmarks/scaling_cpu.py`: sys.path[0] is benchmarks/, not
# the repo root — put the package on the path regardless of invocation dir
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import argparse
import json
import time

import jax
import numpy as np

from spmm_tpu.utils.compile_cache import enable_compile_cache

# the 4 SPMD programs cost minutes of CPU compile; the persistent cache makes
# repeat runs ~free
enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    # sized so the CPU backend finishes all 4 device counts in a few
    # minutes INCLUDING compiles (compiles are the budget driver)
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--nnz", type=int, default=360_000)
    ap.add_argument("--iters", type=int, default=2)
    ap.add_argument("--budget", type=float, default=330.0,
                    help="soft wall-time budget (s): remaining device counts "
                    "are skipped once exceeded, partial curve still printed")
    args = ap.parse_args()
    t_start = time.monotonic()

    # coarse classes: the production ~1.25x grid inlines ~30 chunk bodies per
    # SPMD program — minutes of XLA CPU compile for a
    # measurement whose point is RELATIVE wall time across device counts.
    # The same (coarse) config is used at every count, so the curve stands.
    CLASSES = (16, 64, 256, 1024, 4096, 16384)

    import jax

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel.mesh import make_mesh
    from spmm_tpu.parallel.partition import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_spmd

    A = webgraph_like(args.n, args.nnz, seed=0)
    out = {"scaling_n": args.n, "scaling_nnz": int(A.nnz)}
    ref_nnz = None
    t1 = None
    for nd in (1, 2, 4, 8):
        if time.monotonic() - t_start > args.budget:
            out["scaling_truncated_at"] = nd
            break
        mesh = make_mesh(nd)
        S = partition_rows(A, nd)
        C = spgemm_dist_spmd(S, A, mesh, classes=CLASSES)  # warm/compile
        if ref_nnz is None:
            ref_nnz = C.nnz
        assert C.nnz == ref_nnz, (nd, C.nnz, ref_nnz)
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            spgemm_dist_spmd(S, A, mesh, classes=CLASSES)
            times.append((time.perf_counter() - t0) * 1e3)
        ms = min(times)
        if t1 is None:
            t1 = ms
        out[f"spgemm_scaling_cpu_{nd}"] = round(ms, 1)
        # t(1)/t(N) on shared host cores: this measures program-OVERHEAD
        # FLATNESS (same total work serialized; >1.0 just means the N-shard
        # program dispatches leaner than the 1-shard one), NOT parallel
        # efficiency — named accordingly.  Multi-device scaling is projected
        # by bench.py's spgemm_shard_balance_8.
        out[f"spgemm_overhead_flatness_{nd}"] = round(t1 / ms, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
