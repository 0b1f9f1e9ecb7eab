#!/usr/bin/env python
"""Per-stage device profile of the fused slab SpGEMM (web-Google synthetic).

Aggregates device time per source line of ops/slab_spgemm.py, so each stage
can be compared against its primitive rate.  Usage: python benchmarks/profile_spgemm.py [--n N] [--nnz NNZ]
[--seg-w W]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=916_428)
    ap.add_argument("--nnz", type=int, default=5_105_039)
    ap.add_argument("--seg-w", type=int, default=None)
    ap.add_argument("--pattern", action="store_true", default=None)
    ap.add_argument("--plan", action="store_true",
                    help="profile the PLAN BUILD program (_plan_aligned_device"
                    ": plan stages + class-aligned expansion) instead of the "
                    "fused cold multiply")
    args = ap.parse_args()

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops import slab_spgemm as ss
    from spmm_tpu.utils.profiling import profile_fn

    t0 = time.perf_counter()
    A = webgraph_like(args.n, args.nnz, seed=0)
    print(f"synthetic: {A.shape} nnz={A.nnz} ({time.perf_counter()-t0:.1f}s)")

    W = args.seg_w or ss.DEFAULT_SEG_W
    classes = tuple(sorted({ss._round_up(c, W) for c in ss.DEFAULT_CLASSES}))
    t0 = time.perf_counter()
    sizing = ss._sizing(A, A, W, classes)
    t_sizing = (time.perf_counter() - t0) * 1e3
    npa, nsegB, cls, counts = sizing
    print(f"sizing: {t_sizing:.1f} ms host; npa={npa/1e6:.2f}M nsegB={nsegB/1e6:.2f}M "
          f"slots={npa*W/1e6:.1f}M counts={counts}")

    Ad = A.device()
    sched, tail_start = ss._chunk_schedule(classes, counts, ss.DEFAULT_SLOT_BUDGET)
    print("schedule:", sched)

    max_chunk = ss._bucket_pow2(max(ss.DEFAULT_SLOT_BUDGET // classes[0], 8))
    nsegB_pad = ss._round_up(nsegB, 1024)
    npa_pad = ss._round_up(npa, 1024)
    kw = dict(
        W=W,
        npa_pad=npa_pad,
        nsegB_pad=nsegB_pad,
        nrow=A.nrow,
        nrow_pad=A.nrow + max_chunk,
        nnz=A.nnz,
        schedule=tuple(sched),
        accum_dtype=jnp.float32,
        pattern=True,
        b2_ws=ss._pick_b2_ws(W, True, np.dtype(np.float32), nsegB_pad),
        classes_n=classes,
        remap=sizing.remap,
    )
    print("b2_ws:", kw["b2_ws"], "mode: device-self (no host order upload)")
    dev_args = (
        jnp.asarray(Ad.indptr, jnp.int32), jnp.asarray(Ad.indices, jnp.int32),
        jnp.asarray(Ad.data), jnp.asarray(Ad.indptr, jnp.int32),
        jnp.asarray(Ad.indices, jnp.int32), jnp.asarray(Ad.data),
        None,
    )

    if args.plan:
        # the plan-build program: plan stages (B2 scatter, pa step function,
        # class sort) + the class-aligned cache expansion, one dispatch
        plan_kw = dict(kw)
        plan_kw.pop("schedule")
        plan_kw.pop("accum_dtype")
        sched2 = tuple(sched)
        fn = lambda *a, **k: ss._plan_aligned_device(
            *a, schedule=sched2, a_dtype="float32", b_dtype="float32",
            accum_dtype=jnp.float32, presorted=False, **k,
        )
        kw = plan_kw

        def run():
            outs = fn(*dev_args, **kw)
            jax.block_until_ready(outs)
            return outs

        run()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append((time.perf_counter() - t0) * 1e3)
        print(f"plan build wall: {min(times):.1f} ms  (+ sizing {t_sizing:.1f})")
        from spmm_tpu.utils.profiling import profile_fn

        prof = profile_fn(fn, *dev_args, **kw)
        print(prof.top(25))
        print("\n--- by source ---")
        for src, ms in prof.by_source().items():
            if ms > 1.0:
                print(f"{ms:9.2f} ms  {src}")
        return

    fn = ss._fused_exec
    # wall timing (3 runs, min), each ended by block_until_ready
    def run():
        rows_sorted, outs = fn(*dev_args, **kw)
        jax.block_until_ready(outs)
        return outs

    run()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"wall (device-resident): {min(times):.1f} ms  (+ sizing {t_sizing:.1f} + cls upload)")

    prof = profile_fn(fn, *dev_args, **kw)
    print(prof.top(25))
    print("\n--- by source ---")
    for src, ms in prof.by_source().items():
        if ms > 1.0:
            print(f"{ms:9.2f} ms  {src}")


if __name__ == "__main__":
    main()
