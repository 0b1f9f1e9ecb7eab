#!/usr/bin/env python
"""Microbench: B2 segment-table gather variants at web-Google A x A shapes.

The chunk phase fetches one B2 segment per pa (8.3M gathers from a 1.5M-segment
table).  The shipped layout widens each segment to a full 128-lane row (768 MB
table, no pick); alternatives store segments at narrow stride (24 MB at ws=4)
and pay a lane-pick.  Gathers from small tables may run far faster (cache-
resident), so the trade is measured here, not assumed.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from spmm_tpu.ops.slab_spgemm import _pick_group
from spmm_tpu.utils.timing import measure_device_loop

NSEG = 1_500_000
NPA = 8_300_544  # ~npa, multiple of 128
W = 4

rng = np.random.default_rng(0)
b2r = jnp.asarray(rng.integers(0, NSEG, NPA).astype(np.int32))
b2r_sorted = jnp.asarray(np.sort(np.asarray(b2r)))


def report(name, ms):
    print(f"{name:<46} {ms:8.2f} ms   {NPA/(ms*1e-3)/1e6:7.0f} M segs/s")


def run(name, fn, args):
    t = measure_device_loop(fn, jnp.zeros((), jnp.int32), args, name=name, iters=3)
    report(name, t.median_ms)


# A: wide rows, one segment per 128-lane row (the shipped layout)
tabA = jnp.asarray(rng.integers(0, 1 << 20, (NSEG, 128)).astype(np.int32))

def gA(c, tab, idx):
    g = jnp.take(tab, idx + c, axis=0)
    return g[:, :W].sum()

run("ws=128 wide rows (768 MB, no pick)", gA, (tabA, b2r))
run("ws=128 wide rows, sorted idx", gA, (tabA, b2r_sorted))

# narrow folded variants: ws lanes per segment, pick from 128//ws groups
for ws in (4, 8, 16, 32):
    G = 128 // ws
    tab = jnp.asarray(
        rng.integers(0, 1 << 20, (NSEG * ws // 128, 128)).astype(np.int32)
    )

    def gP(c, tab, idx, G=G, ws=ws):
        g = jnp.take(tab, (idx + c) // G, axis=0)
        seg = _pick_group(g, (idx + c) % G, ws)
        return seg[:, :W].sum()

    run(f"ws={ws} folded ({NSEG*ws*4//(1<<20)} MB) + one-hot pick", gP, (tab, b2r))

# narrow 2-D logical table (physical rows still tile-padded to 128 lanes)
tabN = jnp.asarray(rng.integers(0, 1 << 20, (NSEG, W)).astype(np.int32))

def gN(c, tab, idx):
    return jnp.take(tab, idx + c, axis=0).sum()

run(f"logical (NSEG,{W}) narrow table", gN, (tabN, b2r))

# barrel-shift extraction from the ws=4 fold: fetch the covering row, then
# 5 masked shift stages align the 4-lane window (no crossing: 16B-aligned)
tabF = jnp.asarray(rng.integers(0, 1 << 20, (NSEG * 4 // 128, 128)).astype(np.int32))

def gS(c, tab, idx):
    off = ((idx + c) % 32) * 4
    g = jnp.take(tab, (idx + c) // 32, axis=0)
    flat = g
    rem = 124
    for k in (64, 32, 16, 8, 4):
        rem -= k
        keep = min(W + rem, flat.shape[1] - k)
        src = flat[:, : keep + k]
        flat = jnp.where((off[:, None] & k) != 0, src[:, k:], src[:, :keep])
    return flat[:, :W].sum()

run("ws=4 folded + barrel shift", gS, (tabF, b2r))
