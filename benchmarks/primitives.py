"""Primitive-rate micro-benchmarks — the measurements the kernels' design
rests on (design rationale in ops/slab_spgemm.py).

The sparse kernels here were designed around one ordering of primitive
rates: batched minor-axis sorts and wide row gathers fast; scatters, global
sorts, scalar/window gathers, and take_along_axis slow.  Run on the target
device to re-derive the table:

    python benchmarks/primitives.py [--size 23] [--json]   # 2^size elements

Measurements use device-side loops (utils/timing.py: measure_device_loop).
The script refuses a device that has no row in the peak table
(spmm_tpu.ops.roofline.PEAKS).
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=23, help="log2 element count")
    ap.add_argument(
        "--json",
        action="store_true",
        help="write spmm_tpu/primitive_rates.json, the calibration "
        "MeasuredRates.load() reads (checked against the device kind)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from spmm_tpu.ops.roofline import detect_chip
    from spmm_tpu.utils.compile_cache import enable_compile_cache
    from spmm_tpu.utils.timing import measure_device_loop

    print(f"device: {detect_chip().name}")  # raises for a device not in PEAKS
    enable_compile_cache()

    E = 1 << args.size
    rng = np.random.default_rng(0)
    rows = []

    def report(name, ms, elems=E):
        rate = elems / (ms * 1e-3)
        rows.append((name, ms, rate))
        print(f"{name:<38} {ms:9.2f} ms   {rate/1e6:10.0f} M elem/s")
        return rate

    # --- batched minor-axis sort --------------------------------------------
    # the rate falls with width, so the curve feeds width-aware sort terms
    # in the warm/chain attainable bounds
    bsort_best = 0.0
    bsort_curve = []
    for L in (16, 64, 128, 512):
        R = E // L
        c2 = jnp.asarray(rng.integers(0, 1 << 20, (R, L)).astype(np.int32))
        v2 = jnp.asarray(rng.standard_normal((R, L)).astype(np.float32))

        def s(c, c2, v2):
            cs, vs = jax.lax.sort((c2, v2 + c), dimension=1, num_keys=1)
            return vs[:, 0].sum() + cs[:, 0].sum().astype(jnp.float32)

        t = measure_device_loop(s, jnp.zeros(()), (c2, v2), name=f"bsort{L}", iters=33)
        r = report(f"batched minor-axis sort L={L}", t.median_ms)
        bsort_best = max(bsort_best, r)
        bsort_curve.append((int(L), r))

    # --- global 1-D sort -----------------------------------------------------
    k = jnp.asarray(rng.integers(0, 1 << 30, E).astype(np.int32))
    p1 = jnp.asarray(rng.integers(0, 1 << 20, E).astype(np.int32))
    p2 = jnp.asarray(rng.standard_normal(E).astype(np.float32))

    def gs(c, k, p1, p2):
        a, b, v = jax.lax.sort((k, p1, p2 + c), num_keys=1)
        return v[-1] + a[-1].astype(jnp.float32)

    t = measure_device_loop(gs, jnp.zeros(()), (k, p1, p2), name="gsort", iters=9)
    gsort_rate = report("global 1-D sort (1 key + 2 payloads)", t.median_ms)

    # --- gathers by row width ------------------------------------------------
    NTAB = 1 << 20
    grow_best = 0.0
    g1_rate = 0.0
    for W in (1, 4, 16, 128):
        N = E // W
        table = jnp.asarray(rng.standard_normal((NTAB, W)).astype(np.float32))
        idx = jnp.asarray(rng.integers(0, NTAB, N).astype(np.int32))

        def g(c, table, idx):
            return jnp.take(table, idx + c.astype(jnp.int32), axis=0).sum()

        t = measure_device_loop(g, jnp.zeros(()), (table, idx), name=f"gW{W}", iters=9)
        r = report(f"row gather width={W} ({N/1e6:.1f}M rows)", t.median_ms, elems=N)
        grow_best = max(grow_best, r)
        if W == 1:
            g1_rate = r

    # --- row gather vs TABLE SIZE (the size-matched attainable rate) ---------
    # the per-row gather charge grows with the table it reads from
    # (micro_b2gather.py first measured a 3x spread across sizes), so the
    # calibration captures the curve and MeasuredRates.row_gather_rate()
    # interpolates by table bytes
    gather_curve = []
    Wc = 128
    for ntab_log2 in (15, 17, 19, 21):  # 16 MB, 64 MB, 256 MB, 1 GB tables
        NTABc = 1 << ntab_log2
        table_bytes = NTABc * Wc * 4
        Nc = 1 << 21  # 2M gathered rows per measurement
        tbl = jnp.asarray(rng.standard_normal((NTABc, Wc)).astype(np.float32))
        idxc = jnp.asarray(rng.integers(0, NTABc, Nc).astype(np.int32))

        def gc(c, tbl, idxc):
            return jnp.take(tbl, idxc + c.astype(jnp.int32), axis=0).sum()

        t = measure_device_loop(
            gc, jnp.zeros(()), (tbl, idxc), name=f"gcurve{ntab_log2}", iters=9
        )
        r = report(
            f"row gather, {table_bytes/2**20:.0f} MB table", t.median_ms, elems=Nc
        )
        gather_curve.append((int(table_bytes), r))
        del tbl, idxc

    # --- NARROW-row gather vs table size -------------------------------------
    # per-row cost depends on row width too (on the first target narrow
    # rows were slower than 512 B rows from large tables, faster from small);
    # bounds on genuinely narrow tables — the (nrowB, 2) geometry lookup —
    # use this curve.  The B2 fold gathers full (X, 128) physical rows and
    # is bounded by the wide curve above.
    narrow_curve = []
    Wn = 8  # 32 B rows — the B2 fold granule
    for ntab_log2 in (19, 21, 23, 24):  # 16 MB, 64 MB, 256 MB, 512 MB
        NTABn = 1 << ntab_log2
        table_bytes = NTABn * Wn * 4
        Nn = 1 << 21
        tbl = jnp.asarray(rng.standard_normal((NTABn, Wn)).astype(np.float32))
        idxn = jnp.asarray(rng.integers(0, NTABn, Nn).astype(np.int32))

        def gn(c, tbl, idxn):
            return jnp.take(tbl, idxn + c.astype(jnp.int32), axis=0).sum()

        t = measure_device_loop(
            gn, jnp.zeros(()), (tbl, idxn), name=f"gnarrow{ntab_log2}", iters=9
        )
        r = report(
            f"narrow-row gather, {table_bytes/2**20:.0f} MB table", t.median_ms,
            elems=Nn,
        )
        narrow_curve.append((int(table_bytes), r))
        del tbl, idxn

    # --- scatter-add ----------------------------------------------------------
    vals = jnp.asarray(rng.standard_normal(E).astype(np.float32))
    seg = jnp.asarray(np.sort(rng.integers(0, E // 16, E)).astype(np.int32))

    def sc(c, vals, seg):
        s = jax.ops.segment_sum(vals + c, seg, num_segments=E // 16,
                                indices_are_sorted=True)
        return s[0]

    t = measure_device_loop(sc, jnp.zeros(()), (vals, seg), name="scatter", iters=9)
    scatter_rate = report("scatter-add (segment_sum)", t.median_ms)

    # --- unique set-scatter with flags (the plan scatters' form) -------------
    # sorted+unique claims delete XLA's dedup sort from the lowering —
    # the fastest scatter the hardware offers, hence the bound's denominator
    ES = E // 2
    posu = jnp.asarray(
        np.sort(rng.choice(E - 1, size=ES, replace=False)).astype(np.int32)
    )
    valu = jnp.asarray(rng.integers(-1000, 1000, ES).astype(np.int32))

    def scs(c, posu, valu):
        d = jax.lax.scatter(
            jnp.zeros((E,), jnp.int32), posu[:, None],
            valu + c.astype(jnp.int32),
            jax.lax.ScatterDimensionNumbers((), (0,), (0,)),
            indices_are_sorted=True, unique_indices=True,
            mode=jax.lax.GatherScatterMode.FILL_OR_DROP,
        )
        return d[0]

    t = measure_device_loop(
        scs, jnp.zeros((), jnp.int32), (posu, valu), name="scset", iters=9
    )
    set_rate = report("set-scatter sorted+unique flags", t.median_ms, elems=ES)
    scatter_best = max(scatter_rate, set_rate)

    # --- take_along_axis -------------------------------------------------------
    L = 128
    R = E // L
    v2 = jnp.asarray(rng.standard_normal((R, L)).astype(np.float32))
    i2 = jnp.asarray(rng.integers(0, L, (R, L)).astype(np.int32))

    def taa(c, i2, v2):
        return jnp.take_along_axis(v2 + c, i2, axis=1)[:, 0].sum()

    t = measure_device_loop(taa, jnp.zeros(()), (i2, v2), name="taa", iters=33)
    report("take_along_axis (row-local gather)", t.median_ms)

    # --- cumsum (the cheap primitive everything leans on) ----------------------
    def cs(c, v2):
        return jnp.cumsum(v2 + c, axis=1)[:, -1].sum()

    t = measure_device_loop(cs, jnp.zeros(()), (v2,), name="cumsum", iters=33)
    cumsum_rate = report("batched cumsum", t.median_ms)

    if args.json:
        import datetime
        import json

        from spmm_tpu.ops.roofline import MeasuredRates

        # BEST rates per primitive class: the attainable model is a lower
        # bound on kernel time only if its denominators are unbeatable
        out = {
            "row_gather_rows_s": grow_best,
            "row_gather_curve": gather_curve,
            "row_gather_narrow_curve": narrow_curve,
            "scalar_gather_s": g1_rate,
            "scatter_elems_s": scatter_best,
            "sort_batched_s": bsort_best,
            "sort_batched_curve": bsort_curve,
            "sort_global_s": gsort_rate,
            # cumsum reads+writes 8 B/elem — the fused-elementwise byte rate
            "elementwise_gbs": cumsum_rate * 8,
            "_captured": datetime.datetime.now().isoformat(timespec="seconds"),
            "_device": jax.devices()[0].device_kind,
            "_size_log2": args.size,
        }
        p = MeasuredRates.calibration_path()
        with open(p, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {p}")


if __name__ == "__main__":
    main()
