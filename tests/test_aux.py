"""Auxiliary-subsystem contracts (SURVEY.md §5).

The reference's only 'validation' is timing output; the build mandates
deterministic reductions, NaN hygiene, and observability.  Race detection is
structural: the compute path is pure-functional JAX, so the reference's
unsafe-if-enabled OpenMP loop (SURVEY §2.9) has no analog here — determinism
tests below pin the equivalent guarantee.
"""

import numpy as np

from spmm_tpu.formats.synthetic import webgraph_like


def test_spgemm_bitwise_deterministic():
    """Two runs produce bit-identical results (no atomics / unordered
    reductions anywhere in the kernel)."""
    from spmm_tpu.ops.slab_spgemm import spgemm_slab

    A = webgraph_like(1500, 9000, seed=4)
    C1 = spgemm_slab(A, A)
    C2 = spgemm_slab(A, A)
    assert np.array_equal(np.asarray(C1.data), np.asarray(C2.data))
    assert np.array_equal(np.asarray(C1.indices), np.asarray(C2.indices))


def test_spmm_bitwise_deterministic():
    import jax.numpy as jnp

    from spmm_tpu.formats.ell import ell_pack
    from spmm_tpu.ops.ell_spmm import ell_spmm

    A = webgraph_like(1000, 6000, seed=5)
    E = ell_pack(A).device()
    B = jnp.asarray(np.random.default_rng(0).standard_normal((1000, 16)).astype(np.float32))
    y1 = np.asarray(ell_spmm(E, B))
    y2 = np.asarray(ell_spmm(E, B))
    assert np.array_equal(y1, y2)


def test_nan_propagation_not_masked():
    """NaN values in A propagate to outputs (padding masks must never be
    implemented by value-dependent filtering that would hide NaNs)."""
    import dataclasses

    import jax.numpy as jnp

    from spmm_tpu.ops import spmm_xla

    A = webgraph_like(64, 400, seed=6)
    data = np.asarray(A.data).copy()
    data[0] = np.nan
    A2 = dataclasses.replace(A, data=data)
    B = jnp.ones((64, 4), jnp.float32)
    y = np.asarray(spmm_xla(A2.pad(8).device(), B))
    assert np.isnan(y).any()


def test_profiling_smoke():
    """profile_fn runs and returns a Profile with the device's op rows (on
    the CPU backend: the XLA op events of the host plane)."""
    import jax
    import jax.numpy as jnp

    from spmm_tpu.utils.profiling import Profile, profile_fn

    f = jax.jit(lambda x: (x @ x.T).sum())
    x = jnp.ones((64, 64), jnp.float32)
    p = profile_fn(f, x)
    assert isinstance(p, Profile)
    assert p.ops and p.total_device_ms > 0
    assert isinstance(p.top(3), str)
    assert isinstance(p.by_source(), dict)
