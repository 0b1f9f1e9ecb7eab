#!/usr/bin/env python
"""A/B the k=32 ELL SpMM strategies on the web-Google synthetic.

Candidates:
- widen: zero-pad B to 128 lanes behind an optimization_barrier (the current default)
- direct: gather straight from the (m, 32) logical array, skipping the
  (m, 128) pad materialization (470 MB at web-Google scale) and computing
  on 32 lanes.
"""
import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from spmm_tpu.formats.ell import ell_pack
from spmm_tpu.formats.synthetic import webgraph_like
from spmm_tpu.ops.ell_spmm import ell_spmm, _slab_loop
from spmm_tpu.utils.timing import measure_device_loop

K = int(sys.argv[1]) if len(sys.argv) > 1 else 32
n, nnz = 916_428, 5_105_039
A = webgraph_like(n, nnz, seed=0)
E = ell_pack(A).device()
B = jnp.asarray(np.random.default_rng(0).standard_normal((n, K)).astype(np.float32))

def norm(y):
    return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-9)

def direct(E, B):
    def pick(c):
        return jnp.take(B, c, axis=0).astype(jnp.float32)
    return _slab_loop(E, B, pick, K, jnp.float32, True)

if os.environ.get("NARROWK_AB"):
    # parity check (jitted: one dispatch instead of one per op)
    y_w = np.asarray(jax.jit(lambda E, B: ell_spmm(E, B, pick_impl="widen"))(E, B))
    y_d = np.asarray(jax.jit(direct)(E, B))
    print("parity widen vs direct:", np.allclose(y_w, y_d, rtol=1e-5, atol=1e-5))

    for name, fn in [
        ("widen", lambda c, E: norm(ell_spmm(E, c, pick_impl="widen"))),
        ("direct", lambda c, E: norm(direct(E, c))),
    ]:
        t = measure_device_loop(fn, B, (E,), name=f"{K}_{name}", iters=8)
        print(t)

# bf16-gather experiment: halve the B table bytes (gather rate scales with
# table size) and cast back to f32 after the pick — opt-in precision trade
B128 = jnp.asarray(np.random.default_rng(0).standard_normal((n, 128)).astype(np.float32))
Bh = B128.astype(jnp.bfloat16)

def wide_f32(c, E):
    return norm(ell_spmm(E, c))

def wide_bf16(c, E):
    # carry must keep its dtype through the device loop
    return norm(ell_spmm(E, c)).astype(c.dtype)

t = measure_device_loop(wide_f32, B128, (E,), name="wide_k128_f32", iters=8)
print(t)
t = measure_device_loop(wide_bf16, Bh, (E,), name="wide_k128_bf16table", iters=8)
print(t)
