#!/usr/bin/env python
"""Microbenchmarks: primitive candidates for the SpGEMM plan/chunk
restructure.  Sizes match web-Google A x A: nnzA=4.77M,
npa=9M (17M padded), nsegB=1.8M, gathered chunk rows ~16M.

Run: python benchmarks/micro_r2.py [--case NAME]
"""
from __future__ import annotations

import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from spmm_tpu.utils.timing import measure_device_loop

NNZ = 4_767_302
NPA = 9_043_482
NPA_PAD = 17_000_448  # class-padded pa stream estimate
NSEGB = 1_810_432
S_GATHER = 4_000_000  # one large chunk's worth of segment fetches


def rep(name, t, n, unit="elem"):
    rate = n / (t.median_ms * 1e-3)
    print(f"{name:28s} {t.median_ms:9.3f} ms   {rate/1e6:10.1f} M{unit}/s")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="all")
    args = ap.parse_args()
    rng = np.random.default_rng(0)

    want = lambda c: args.case in ("all", c)

    # ---- scatters: 4.77M random idx -> 9M dest -------------------------------
    if want("scatter"):
        idx = jnp.asarray(rng.integers(0, NPA, NNZ), jnp.int32)
        vals = jnp.asarray(rng.integers(0, 1 << 20, NNZ), jnp.int32)
        sidx = jnp.sort(idx)

        def sc_add(c, idx, vals):
            out = jnp.zeros((NPA + 1,), jnp.int32).at[idx].add(vals + c, mode="drop")
            return out[0]

        def sc_set(c, idx, vals):
            out = jnp.full((NPA + 1,), -1, jnp.int32).at[idx].set(vals + c, mode="drop")
            return out[0]

        def sc_max(c, idx, vals):
            out = jnp.full((NPA + 1,), -1, jnp.int32).at[idx].max(vals + c, mode="drop")
            return out[0]

        z = jnp.int32(0)
        rep("scatter_add rand", measure_device_loop(sc_add, z, (idx, vals), iters=8), NNZ)
        rep("scatter_set rand", measure_device_loop(sc_set, z, (idx, vals), iters=8), NNZ)
        rep("scatter_max rand", measure_device_loop(sc_max, z, (idx, vals), iters=8), NNZ)
        rep("scatter_add sorted", measure_device_loop(sc_add, z, (sidx, vals), iters=8), NNZ)
        rep("scatter_set sorted", measure_device_loop(sc_set, z, (sidx, vals), iters=8), NNZ)

    # ---- cumsum / cummax over the padded pa stream ---------------------------
    if want("cum"):
        x = jnp.asarray(rng.integers(0, 1 << 20, NPA_PAD), jnp.int32)

        def cmax(c, x):
            return jax.lax.cummax(x + c)[-1]

        def csum(c, x):
            return jnp.cumsum(x + c, dtype=jnp.int32)[-1]

        rep("cummax 17M", measure_device_loop(cmax, jnp.int32(0), (x,), iters=8), NPA_PAD)
        rep("cumsum 17M", measure_device_loop(csum, jnp.int32(0), (x,), iters=8), NPA_PAD)

    # ---- associative_scan fill-forward (flag, val) over 17M ------------------
    if want("ffwd"):
        hit = jnp.asarray(rng.random(NPA_PAD) < 0.5, jnp.int32)
        val = jnp.asarray(rng.integers(0, 1 << 20, NPA_PAD), jnp.int32)

        def ff(c, hit, val):
            def comb(a, b):
                return (a[0] | b[0], jnp.where(b[0] > 0, b[1], a[1]))

            f, v = jax.lax.associative_scan(comb, (hit, val + c))
            return v[-1]

        rep("assoc_ffwd 17M", measure_device_loop(ff, jnp.int32(0), (hit, val), iters=4), NPA_PAD)

    # ---- sorts ---------------------------------------------------------------
    if want("sort"):
        key = jnp.asarray(rng.integers(0, 1 << 27, NNZ), jnp.int32)
        p1 = jnp.asarray(rng.integers(0, 1 << 20, NNZ), jnp.int32)
        p2 = p1 + 1
        p3 = p1 + 2

        def s1(c, key):
            return jax.lax.sort((key + c,), num_keys=1)[0][-1]

        def s4(c, key, p1, p2, p3):
            o = jax.lax.sort((key + c, p1, p2, p3), num_keys=1)
            return o[0][-1] + o[3][-1]

        rep("sort 1key 4.77M", measure_device_loop(s1, jnp.int32(0), (key,), iters=4), NNZ)
        rep("sort key+3pay 4.77M", measure_device_loop(s4, jnp.int32(0), (key, p1, p2, p3), iters=4), NNZ)

    # ---- counting-sort-by-11-classes alternative -----------------------------
    if want("csort"):
        cls = jnp.asarray(rng.integers(0, 11, NNZ), jnp.int32)
        p1 = jnp.asarray(rng.integers(0, 1 << 20, NNZ), jnp.int32)

        def csort(c, cls, p1):
            pos = jnp.zeros((NNZ,), jnp.int32)
            base = jnp.int32(0)
            for cc in range(11):
                m = cls == cc
                r = jnp.cumsum(m.astype(jnp.int32)) - 1
                pos = jnp.where(m, base + r, pos)
                base = base + r[-1] + 1
            out = jnp.zeros((NNZ,), jnp.int32).at[pos].set(p1 + c)
            return out[-1]

        rep("countsort 11cls 4.77M", measure_device_loop(csort, jnp.int32(0), (cls, p1), iters=4), NNZ)

    # ---- aligned row gather (B2 shape) --------------------------------------
    if want("gather"):
        tab = jnp.asarray(rng.integers(0, 1 << 20, (NSEGB // 4 * 4, 128)), jnp.int32)
        gi = jnp.asarray(rng.integers(0, tab.shape[0], S_GATHER), jnp.int32)

        def g(c, tab, gi):
            out = jnp.take(tab, jnp.clip(gi + c, 0, tab.shape[0] - 1), axis=0)
            return out[0, 0]

        rep("row_gather 128w 4M", measure_device_loop(g, jnp.int32(0), (tab, gi), iters=8), S_GATHER, "row")

    # ---- pick: current vs a one-hot dot ---------------------------------------
    if want("pick"):
        from spmm_tpu.ops.slab_spgemm import _pick_group

        g = jnp.asarray(rng.integers(0, 1 << 20, (S_GATHER, 128)), jnp.int32)
        grp = jnp.asarray(rng.integers(0, 32, S_GATHER), jnp.int32)
        R_pad, L = S_GATHER // 4, 16  # reshape target like class-16 chunk

        def pick_cur(c, g, grp):
            out = _pick_group(g + c, grp, 4)[:, :4].reshape(R_pad, L)
            return out[0, 0]

        P = (jax.lax.broadcasted_iota(jnp.int32, (128, 4), 0) % 4
             == jax.lax.broadcasted_iota(jnp.int32, (128, 4), 1)).astype(jnp.float32)

        def pick_dot(c, g, grp):
            io = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1) // 4
            masked = jnp.where(io == grp[:, None], g + c, 0).astype(jnp.float32)
            out = jnp.dot(masked, P).astype(jnp.int32).reshape(R_pad, L)
            return out[0, 0]

        rep("pick current 4Mx128", measure_device_loop(pick_cur, jnp.int32(0), (g, grp), iters=8), S_GATHER, "row")
        rep("pick dot 4Mx128", measure_device_loop(pick_dot, jnp.int32(0), (g, grp), iters=8), S_GATHER, "row")

    # ---- end-to-end ELL k=32 pick impl A/B -----------------------------------
    if want("ellk32"):
        from spmm_tpu.formats.ell import ell_pack
        from spmm_tpu.formats.synthetic import webgraph_like
        from spmm_tpu.ops.ell_spmm import ell_spmm
        from spmm_tpu.utils.timing import measure_device_loop as mdl

        A = webgraph_like(916_428, 5_105_039, seed=0)
        E = ell_pack(A).device()
        B32 = jnp.asarray(rng.standard_normal((916_428, 32)).astype(np.float32))
        B128 = jnp.asarray(rng.standard_normal((916_428, 128)).astype(np.float32))

        def norm(y):
            return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-9)

        for impl in ("select", "einsum"):
            t = mdl(lambda c, E: norm(ell_spmm(E, c, pick_impl=impl)), B32, (E,),
                    name=f"k32_{impl}", iters=8)
            print(f"ell k32 pick={impl:7s} {t.median_ms:9.3f} ms")
        t = mdl(lambda c, E: norm(ell_spmm(E, c)), B128, (E,), name="k128", iters=8)
        print(f"ell k128 (reference)   {t.median_ms:9.3f} ms")

    # ---- BlockedCSR consumers A/B: full-B gather vs two-stage panel ---------
    if want("panel"):
        from spmm_tpu.config import Config
        from spmm_tpu.formats.synthetic import webgraph_like
        from spmm_tpu.ops.blocked import (
            blocked_exec_view, blocked_panel_view, blocked_slab_view,
            blocked_spmm_panel, blocked_spmm_slab, blocked_spmm_xla,
        )
        from spmm_tpu.preprocess import preprocess
        from spmm_tpu.utils.timing import measure_device_loop as mdl

        A = webgraph_like(916_428, 5_105_039, seed=0)
        P = preprocess(A, Config()).device()
        Bk = jnp.asarray(rng.standard_normal((916_428, 128)).astype(np.float32))

        def norm(y):
            return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-9)

        v_g = blocked_exec_view(P)
        t = mdl(lambda c, P, v: norm(blocked_spmm_xla(P, c, view=v)), Bk, (P, v_g),
                name="blk_gather", iters=8)
        print(f"blocked gather (full B)  {t.median_ms:9.3f} ms")
        v_p = blocked_panel_view(P)
        t = mdl(lambda c, P, v: norm(blocked_spmm_panel(P, c, view=v)), Bk, (P, v_p),
                name="blk_panel", iters=8)
        print(f"blocked two-stage panel  {t.median_ms:9.3f} ms (ndistinct={P.ndistinct})")
        v_s = blocked_slab_view(P)
        t = mdl(lambda c, P, v: norm(blocked_spmm_slab(P, c, v)), Bk, (P, v_s),
                name="blk_slab", iters=8)
        print(f"blocked v8-slab (full B) {t.median_ms:9.3f} ms")
        v_sp = blocked_slab_view(P, panel=True)
        t = mdl(lambda c, P, v: norm(blocked_spmm_slab(P, c, v)), Bk, (P, v_sp),
                name="blk_slab_panel", iters=8)
        print(f"blocked v8-slab (panel)  {t.median_ms:9.3f} ms")

    # ---- H2D upload ----------------------------------------------------------
    if want("h2d"):
        for mb, n in ((3.7, 916_429), (19.1, NNZ)):
            a = rng.integers(0, 1 << 20, n).astype(np.int32)
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                d = jnp.asarray(a)
                d.block_until_ready()
                np.asarray(d[:1])
                ts.append((time.perf_counter() - t0) * 1e3)
                del d
            ts.sort()
            print(f"h2d {mb:5.1f} MB: {ts[len(ts)//2]:.1f} ms median (min {ts[0]:.1f})")


if __name__ == "__main__":
    main()
