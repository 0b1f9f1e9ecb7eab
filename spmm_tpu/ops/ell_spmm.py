"""Scatter-free SpMM/SpMV over the ELL format.

Per length-class slab (R, L): gather B rows for all slab columns, multiply by
the slab values, reduce densely over L (no scatter); concatenate slabs in
sorted-row order; one gather un-permutes to the original row order.  The
leftover long rows use the segment-sum path (they are few).

The length-class slabs recast the reference's per-panel
row-length sort (reference: PreProcessing/v8sort.h:152-232, which groups
equal-length rows for SIMD-8 processing; here equal-length rows batch into
dense (R, L) tiles, SURVEY.md §2.6).

HBM traffic ≈ padded_nnz·(k+2)·4 + 2·m·k·4 — within ~1.3x of the gather-bound
speed of light for unstructured SpMM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spmm_tpu.formats.ell import ELL


def _next_pow2(k: int) -> int:
    p = 1
    while p < k:
        p <<= 1
    return p


def _slab_loop(E: ELL, B, pick, k, accum_dtype, permute_back):
    """Shared ELL-SpMM scaffolding: per-slab accumulate with ``pick(cols) ->
    (n, k) picked B rows``, leftover-CSR fallback, concatenate, un-permute."""
    hi = jax.lax.Precision.HIGHEST
    parts = [jnp.zeros((E.n_empty, k), accum_dtype)]
    for slab_d, slab_c in zip(E.data, E.cols):
        R, L = slab_d.shape
        if L <= 8:
            # unrolled accumulate: each pick fuses into the multiply-add, no
            # (R, L, k) intermediate in HBM
            y = jnp.zeros((R, k), accum_dtype)
            for e in range(L):
                y = y + slab_d[:, e : e + 1].astype(accum_dtype) * pick(slab_c[:, e])
        else:
            picked = pick(slab_c.reshape(-1)).reshape(R, L, k)
            # full fp32: a default-precision einsum may run reduced-precision
            # passes (bf16/TF32, ~1e-3 relative error on long rows)
            y = jnp.einsum(
                "rl,rlk->rk", slab_d.astype(accum_dtype), picked, precision=hi
            )
        parts.append(y)
    if E.n_rest_rows:
        from spmm_tpu.ops.spmm import spmm_xla

        parts.append(spmm_xla(E.rest, B, accum_dtype=accum_dtype)[: E.n_rest_rows])
    y_sorted = jnp.concatenate(parts, axis=0)
    if not permute_back:
        return y_sorted
    return jnp.take(y_sorted, jnp.asarray(E.inv_perm), axis=0)


#: narrow-k strategy: "widen" (zero-pad B to 128 lanes, run the wide path,
#: slice the output), "einsum" (one-hot dot pick of the k-lane group), or
#: "select" (log2(G) masked selects).  "widen" was chosen on the premise
#: that row gathers cost the same at any width, so the wide fetch is free
#: while every pick variant adds a per-slot pass.  Whether that still holds
#: on a GPU, where gathers move 32 B sectors, is open (ROADMAP S6).
PICK_IMPL = "widen"


def ell_spmm(
    E: ELL, B: jax.Array, *, accum_dtype=jnp.float32, permute_back: bool = True,
    pick_impl: str | None = None,
):
    """Y[m, k] = A @ B for A in ELL form."""
    k = B.shape[-1]
    if k < 128:
        impl0 = pick_impl or PICK_IMPL
        if impl0 == "widen":
            # zero-pad the RHS to full lane width and run the wide path
            # (see PICK_IMPL).  The barrier MATERIALIZES the padded B:
            # without it XLA fuses the concat into every slab gather (a
            # per-row select).  The un-permute gather runs on the SLICED
            # (m, k) output, not the padded width.
            Bp = jnp.concatenate(
                [B, jnp.zeros((B.shape[0], 128 - k), B.dtype)], axis=1
            )
            Bp = jax.lax.optimization_barrier(Bp)
            ys = ell_spmm(
                E, Bp, accum_dtype=accum_dtype, permute_back=False,
                pick_impl=pick_impl,
            )[:, :k]
            if not permute_back:
                return ys
            return jnp.take(ys, jnp.asarray(E.inv_perm), axis=0)
        kp = k if 128 % k == 0 else _next_pow2(k)
        if kp != k:
            Bp = jnp.concatenate([B, jnp.zeros((B.shape[0], kp - k), B.dtype)], axis=1)
            return ell_spmm(
                E, Bp, accum_dtype=accum_dtype, permute_back=permute_back,
                pick_impl=pick_impl,
            )[:, :k]
        # fold G = 128//k consecutive B rows into one 128-lane row, gather at
        # full lane width, then pick the k-lane group (HIGHEST precision /
        # exact selects: f32 values pass through exactly).  Same gather-row
        # count as the wide path but no (m, 128) widen/slice round-trip of B
        # and Y through HBM.
        G = 128 // k
        mb = B.shape[0]
        pad = (-mb) % G
        B4 = B if pad == 0 else jnp.concatenate([B, jnp.zeros((pad, k), B.dtype)])
        B4 = B4.reshape((mb + pad) // G, 128)
        eye = jnp.eye(G, dtype=accum_dtype)
        hi = jax.lax.Precision.HIGHEST
        impl = pick_impl or PICK_IMPL

        def pick_folded(c):
            g = jnp.take(B4, c // G, axis=0).astype(accum_dtype)  # (S, 128)
            grp = c % G
            if impl == "select":
                # binary-reduction select: log2(G) masked (S, k) merges
                g3 = g.reshape(-1, G, k)
                parts = [g3[:, i, :] for i in range(G)]
                bit = 1
                while len(parts) > 1:
                    sel = ((grp & bit) != 0)[:, None]
                    parts = [
                        jnp.where(sel, parts[i + 1], parts[i])
                        for i in range(0, len(parts), 2)
                    ]
                    bit <<= 1
                return parts[0]
            sel = jnp.take(eye, grp, axis=0)
            return jnp.einsum("sg,sgk->sk", sel, g.reshape(-1, G, k), precision=hi)

        return _slab_loop(E, B, pick_folded, k, accum_dtype, permute_back)

    def pick_wide(c):
        return jnp.take(B, c, axis=0).astype(accum_dtype)

    return _slab_loop(E, B, pick_wide, k, accum_dtype, permute_back)


def ell_spmv(E: ELL, x: jax.Array, *, accum_dtype=jnp.float32, permute_back: bool = True):
    """y[m] = A @ x for A in ELL form (dense per-slab reductions, no scatter)."""
    parts = [jnp.zeros((E.n_empty,), accum_dtype)]
    for slab_d, slab_c in zip(E.data, E.cols):
        gathered = jnp.take(x, slab_c, axis=0)
        parts.append(jnp.sum(slab_d.astype(accum_dtype) * gathered.astype(accum_dtype), axis=1))
    if E.n_rest_rows:
        from spmm_tpu.ops.spmm import spmv_xla

        parts.append(spmv_xla(E.rest, x, accum_dtype=accum_dtype)[: E.n_rest_rows])
    y_sorted = jnp.concatenate(parts, axis=0)
    if not permute_back:
        return y_sorted
    return jnp.take(y_sorted, jnp.asarray(E.inv_perm), axis=0)
