"""SpMM / SpMV — sparse × dense products.

The reference ships no compute kernels at all (SURVEY.md §0); these are the
kernels its preprocessing exists to feed.  Two tiers:

- ``*_xla``: pure-XLA gather + segment-sum formulations.  Correct for any CSR
  (padded or tight), differentiable, shardable; these are also the oracle for
  the format-specific kernels.
- ``spmm`` / ``spmv``: dispatchers that pick the path for the input format
  (ELL slabs, BSR block products, the preprocessed BlockedCSR, raw CSR).

Numeric convention: accumulate in float32 (``preferred_element_type``
semantics); values may be stored bf16/fp32/fp64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spmm_tpu.formats.containers import CSR


def _row_ids(A: CSR) -> jax.Array:
    from spmm_tpu.ops.segments import boundary_segments

    return boundary_segments(jnp.asarray(A.indptr), A.nnz_pad)


def spmm_xla(A: CSR, B: jax.Array, *, accum_dtype=jnp.float32) -> jax.Array:
    """Y[m, k] = A[m, n] @ B[n, k] via gather + segment-sum.

    Padded nonzeros (data == 0) contribute nothing regardless of their index,
    so no masking is needed.  HBM traffic ≈ nnz·(4+4) for A, nnz·4k gather
    from B, m·4k for Y — the preprocessed/blocked kernel beats this by staging
    compacted B panels (SURVEY.md §3.3).
    """
    rows = _row_ids(A)
    gathered = jnp.take(B, jnp.asarray(A.indices), axis=0).astype(accum_dtype)
    contrib = gathered * jnp.asarray(A.data).astype(accum_dtype)[:, None]
    return jax.ops.segment_sum(
        contrib, rows, num_segments=A.shape[0], indices_are_sorted=True
    )


def spmv_xla(A: CSR, x: jax.Array, *, accum_dtype=jnp.float32) -> jax.Array:
    """y[m] = A[m, n] @ x[n]."""
    rows = _row_ids(A)
    contrib = (jnp.take(x, jnp.asarray(A.indices)) * jnp.asarray(A.data)).astype(accum_dtype)
    return jax.ops.segment_sum(
        contrib, rows, num_segments=A.shape[0], indices_are_sorted=True
    )


#: above this nnz the CSR dispatchers auto-pack to ELL (pack once, memoized
#: per CSR instance).  Raw CSR gather+segment-sum pays a scalar gather AND a
#: scatter per nonzero; the ELL slabs cost one host pack (~nnz sort) and
#: every subsequent multiply runs scatter-free.  Below the threshold the
#: pack isn't worth the host pass.
AUTO_ELL_THRESHOLD = 1 << 18

_ELL_CACHE: dict = {}  # id(CSR) -> (weakref, device ELL)


def _ell_of(A: CSR):
    """Memoized ELL pack of a CSR (weakly keyed by instance).  Host CSRs
    pack on host; device CSRs (e.g. chained SpGEMM outputs) pack via
    ell_pack_device — nnz-scale data never crosses the host boundary."""
    import weakref

    import numpy as np

    key = id(A)
    ent = _ELL_CACHE.get(key)
    if ent is not None and ent[0]() is A:
        return ent[1]
    from spmm_tpu.formats.ell import ell_pack, ell_pack_device

    if isinstance(A.data, np.ndarray):
        E = ell_pack(A).device()
    else:
        E = ell_pack_device(A)
    _ELL_CACHE[key] = (weakref.ref(A, lambda r, k=key: _ELL_CACHE.pop(k, None)), E)
    return E


def _auto_ell(A) -> bool:
    return isinstance(A, CSR) and A.nnz >= AUTO_ELL_THRESHOLD


def spmm(A, B: jax.Array, **kw) -> jax.Array:
    """Dispatch SpMM on the input format: ELL (fastest unstructured path,
    scatter-free), BSR (dense block products), BlockedCSR (reference-parity
    packed format), CSR (gather + segment-sum; large host CSRs auto-pack to
    ELL once and reuse the pack across calls)."""
    from spmm_tpu.formats.bsr import BSR
    from spmm_tpu.formats.containers import BlockedCSR
    from spmm_tpu.formats.ell import ELL

    if isinstance(A, ELL):
        from spmm_tpu.ops.ell_spmm import ell_spmm

        return ell_spmm(A, B, **kw)
    if isinstance(A, BSR):
        from spmm_tpu.ops.pallas_bsr import bsr_spmm

        return bsr_spmm(A, B, **kw)
    if isinstance(A, BlockedCSR):
        from spmm_tpu.ops.blocked import blocked_spmm

        return blocked_spmm(A, B, **kw)
    if _auto_ell(A):
        from spmm_tpu.ops.ell_spmm import ell_spmm

        return ell_spmm(_ell_of(A), B, **kw)
    return spmm_xla(A, B, **kw)


def spmv(A, x: jax.Array, **kw) -> jax.Array:
    from spmm_tpu.formats.containers import BlockedCSR
    from spmm_tpu.formats.ell import ELL

    if isinstance(A, ELL):
        from spmm_tpu.ops.ell_spmm import ell_spmv

        return ell_spmv(A, x, **kw)
    if isinstance(A, BlockedCSR):
        from spmm_tpu.ops.blocked import blocked_spmm

        return blocked_spmm(A, x[:, None], **kw)[:, 0]
    if _auto_ell(A):
        from spmm_tpu.ops.ell_spmm import ell_spmv

        return ell_spmv(_ell_of(A), x, **kw)
    return spmv_xla(A, x, **kw)
