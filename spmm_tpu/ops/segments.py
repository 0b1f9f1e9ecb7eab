"""Segment-id expansion primitives.

``jnp.searchsorted`` lowers to ~log2(n) dependent gather passes, which was
measured to be slow at scale on the accelerator this was first built on.
Expanding sorted boundaries into per-element segment ids is instead one
scatter-add plus one cumsum — O(n) streaming ops.
"""

from __future__ import annotations

import jax.numpy as jnp


def boundary_segments(boundaries, out_size: int, *, dtype=jnp.int32):
    """For sorted ``boundaries`` with ``boundaries[0] == 0``, returns
    ``seg[e] = searchsorted(boundaries, e, side="right") - 1`` for
    ``e in [0, out_size)``, except positions at/after ``boundaries[-1]``
    saturate at ``len(boundaries) - 2`` (the last valid segment) — callers pad
    with zeros past the true length and mask anyway.

    Equivalent to CSR indptr → per-nonzero row ids when called as
    ``boundary_segments(indptr, nnz_pad)``.
    """
    b = jnp.asarray(boundaries)
    z = jnp.zeros((out_size,), dtype).at[b[1:-1]].add(1, mode="drop")
    return jnp.cumsum(z, dtype=dtype)
