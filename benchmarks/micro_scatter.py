#!/usr/bin/env python
"""Microbench: the plan-phase scatter variants at web-Google shapes.

step_fn (slab_spgemm.py:313) materializes an npa-scale step function with ONE
nnz-element scatter.  Measures .at[].add vs .at[].set (sorted unique indices)
vs segment_sum at the exact (nnz=5.1M -> npa_pad=8.4M) shapes to decide
whether pre-filtering dead A-nonzeros (making indices unique so .set works)
pays on device.
"""
from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from spmm_tpu.utils.timing import measure_device_loop

NNZ = 5_120_000
NPA = 8_388_608  # npa_pad

rng = np.random.default_rng(0)
# sorted strictly-increasing positions, like seg_off over live nonzeros
pos = np.sort(rng.choice(NPA - 1, size=NNZ, replace=False)).astype(np.int32)
vals = rng.integers(-1000, 1000, NNZ).astype(np.int32)
pos_d = jnp.asarray(pos)
vals_d = jnp.asarray(vals)


def report(name, ms):
    print(f"{name:<44} {ms:8.2f} ms   {NNZ/(ms*1e-3)/1e6:8.0f} M writes/s")


def sc_add(c, pos_d, vals_d):
    d = jnp.zeros((NPA + 1,), jnp.int32).at[pos_d].add(vals_d + c, mode="drop")
    return jnp.cumsum(d)[:NPA][-1]


def sc_set(c, pos_d, vals_d):
    d = jnp.zeros((NPA + 1,), jnp.int32).at[pos_d].set(vals_d + c, mode="drop")
    return jnp.cumsum(d)[:NPA][-1]


def sc_set_unsorted(c, pos_u, vals_d):
    d = jnp.zeros((NPA + 1,), jnp.int32).at[pos_u].set(vals_d + c, mode="drop")
    return jnp.cumsum(d)[:NPA][-1]


def sc_add_sortedflag(c, pos_d, vals_d):
    d = jnp.zeros((NPA + 1,), jnp.int32)
    d = jax.lax.scatter_add(
        d, pos_d[:, None], vals_d + c,
        jax.lax.ScatterDimensionNumbers(
            update_window_dims=(), inserted_window_dims=(0,),
            scatter_dims_to_operand_dims=(0,)),
        indices_are_sorted=True, unique_indices=True, mode="drop",
    )
    return jnp.cumsum(d)[:NPA][-1]


pos_u = jnp.asarray(rng.permutation(pos))

z = jnp.zeros((), jnp.int32)
for name, fn, a in [
    ("scatter-ADD sorted idx (step_fn today)", sc_add, (pos_d, vals_d)),
    ("scatter-SET sorted unique idx", sc_set, (pos_d, vals_d)),
    ("scatter-SET random unique idx", sc_set_unsorted, (pos_u, vals_d)),
    ("scatter-ADD sorted+unique flags", sc_add_sortedflag, (pos_d, vals_d)),
]:
    t = measure_device_loop(fn, z, a, name=name, iters=3)
    report(name, t.median_ms)
