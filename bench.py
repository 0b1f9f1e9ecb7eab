#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...extras}

Headline: host preprocessing time on a web-Google-sized synthetic graph
(916,428^2, ~5.1M nnz).  Extras report kernel throughput on the device:
SpGEMM A×A (cold, plan reuse, chained), SpMM (k=128/k=32), SpMV, BSR SpMM
(the Triton kernel and the XLA formulation), each SpMM/SpMV against its
speed-of-light roofline from the device's published peaks
(spmm_tpu.ops.roofline.PEAKS — a device not in that table is an error).

Every section is gated on a deadline (BENCH_BUDGET_S, default 1500 s) and a
failed section records ``<section>_error``.  The JSON line is printed in
every exit path; the exit code is non-zero when any section failed.

Usage: python bench.py [--quick] [--full] [--no-kernels] [--no-spgemm]
                       [--no-suite] [--no-scaling] [--matrix PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time

import numpy as np

WEBGOOGLE_N = 916_428
WEBGOOGLE_NNZ = 5_105_039

# ---------------------------------------------------------------- deadline
T0 = time.monotonic()
BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1500"))

RESULT: dict = {
    "metric": "preprocess_ms_webgoogle_synthetic",
    "value": None,
    "unit": "ms",
}
_emitted = False


def time_left() -> float:
    return BUDGET_S - (time.monotonic() - T0)


def errors() -> list:
    return sorted(k for k in RESULT if k == "error" or k.endswith("_error"))


def emit():
    """Print the JSON line once, whatever state the run reached."""
    global _emitted
    if _emitted:
        return
    _emitted = True
    RESULT["bench_wall_s"] = round(time.monotonic() - T0, 1)
    print(json.dumps(RESULT, default=str), flush=True)


def _on_signal(signum, frame):
    RESULT["error"] = f"interrupted by {signal.Signals(signum).name}"
    emit()
    os._exit(1)


signal.signal(signal.SIGTERM, _on_signal)


def gate(section: str, need_s: float) -> bool:
    """True if there's budget to start `section` (estimated cost need_s)."""
    if time_left() >= need_s:
        return True
    log(f"SKIP {section}: {time_left():.0f}s left < {need_s:.0f}s needed")
    RESULT.setdefault("skipped", []).append(section)
    return False


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- sections
def bench_preprocess(A, cfg, iters=9):  # min-of-9: host timings are noisy
    from spmm_tpu.preprocess import preprocess

    times = []
    P = None
    for _ in range(iters):
        t0 = time.perf_counter()
        P = preprocess(A, cfg)
        times.append((time.perf_counter() - t0) * 1e3)
    return min(times), P


def bench_kernels(A, P, k, chip, full=False):
    """Kernel timings via device-side loops (utils/timing.py:
    measure_device_loop — per-iteration device time with dispatch cancelled
    out), except BSR SpMM, which is timed end to end.  Ordered by value;
    each measurement is deadline-gated."""
    import jax
    import jax.numpy as jnp

    from spmm_tpu.formats.ell import ell_pack
    from spmm_tpu.ops import spmm_xla, spmv_xla, spmm_roofline, spmv_roofline
    from spmm_tpu.ops.ell_spmm import ell_spmm, ell_spmv
    from spmm_tpu.utils.timing import measure, measure_device_loop, measure_host

    extras = RESULT  # write-through: a signal-time emit sees partial sections
    m, n = A.shape
    B0 = jnp.asarray(np.random.default_rng(0).standard_normal((m, k)).astype(np.float32))
    x0 = jnp.asarray(np.random.default_rng(1).standard_normal(m).astype(np.float32))

    def norm(y):
        return y / jnp.maximum(jnp.max(jnp.abs(y)), 1e-9)

    flops = 2.0 * A.nnz * k
    rl = spmm_roofline(A.nnz, m, n, k, chip=chip)
    rlv = spmv_roofline(A.nnz, m, n, chip=chip)

    def record(prefix, t, fl=flops, sol=rl):
        log(t)
        extras[f"{prefix}_ms"] = round(t.median_ms, 3)
        if fl:
            extras[f"{prefix}_gflops"] = round(fl / (t.median_ms * 1e-3) / 1e9, 1)
        if sol:
            extras[f"{prefix}_sol_frac"] = round(sol.efficiency(t.median_ms * 1e-3), 3)

    # --- the production ELL slabs ------------------------------------------
    E = ell_pack(A).device()
    extras["ell_padding_factor"] = round(E.padded_nnz / max(A.nnz, 1), 3)
    if gate("spmm_ell_k128", 90):
        t = measure_device_loop(
            lambda c, E: norm(ell_spmm(E, c)), B0, (E,), name="spmm_ell_k128", iters=8
        )
        record("spmm_ell_k128", t)
    if gate("spmv_ell", 60):
        t = measure_device_loop(
            lambda c, E: norm(ell_spmv(E, c)), x0, (E,), name="spmv_ell", iters=8
        )
        record("spmv_ell", t, fl=2.0 * A.nnz, sol=rlv)
    # --- BSR SpMM: the dispatcher's path (the Triton kernel on a GPU) and
    # the XLA formulation, both end to end --------------------------------
    if gate("bsr", 60):
        try:
            from spmm_tpu.formats.bsr import csr_to_bsr
            from spmm_tpu.formats.synthetic import banded_random
            from spmm_tpu.ops.pallas_bsr import bsr_spmm, bsr_spmm_xla, bsr_spmv

            nb = 65536
            Ab = banded_random(nb, 512, 0.25, seed=3)
            Bs = csr_to_bsr(Ab).device()
            bm, bn = Bs.block_shape
            Bd = jnp.asarray(
                np.random.default_rng(2).standard_normal((nb, 128)).astype(np.float32)
            )
            fl = 2.0 * Bs.nblocks * bm * bn * 128
            extras["bsr_nblocks"] = int(Bs.nblocks)
            for key, f in (("bsr_spmm_k128", bsr_spmm), ("bsr_spmm_xla_k128", bsr_spmm_xla)):
                t = measure(jax.jit(f), Bs, Bd, name=key, iters=20)
                log(t)
                extras[f"{key}_ms"] = round(t.median_ms, 4)
                extras[f"{key}_gflops"] = round(fl / (t.median_ms * 1e-3) / 1e9, 1)

            xb = Bd[:, 0]
            t = measure_device_loop(
                lambda c, Bs: norm(bsr_spmv(Bs, c)), xb, (Bs,), name="bsr_spmv", iters=8
            )
            flv = 2.0 * Bs.nblocks * bm * bn
            extras["bsr_spmv_ms"] = round(t.median_ms, 3)
            extras["bsr_spmv_gflops"] = round(flv / (t.median_ms * 1e-3) / 1e9, 1)
            log(t)
        except Exception as e:
            log("bsr bench failed:", repr(e))
            extras["bsr_error"] = repr(e)[:200]

    # tall-skinny k=32
    if gate("spmm_ell_k32", 60):
        B32 = B0[:, :32]
        t = measure_device_loop(
            lambda c, E: norm(ell_spmm(E, c)), B32, (E,), name="spmm_ell_k32", iters=8
        )
        record("spmm_ell_k32", t, fl=2.0 * A.nnz * 32,
               sol=spmm_roofline(A.nnz, m, n, 32, chip=chip))

    # --- user-facing dispatchers on a raw CSR (auto-pack to ELL once) ------
    # spmv_csr/spmm_csr_k128 report the steady state after the dispatcher's
    # memoized pack (ops/spmm.py:_ell_of); the one-time pack cost is
    # spmv_csr_pack_ms
    from spmm_tpu.ops.spmm import _ell_of

    tp = measure_host(lambda: ell_pack(A), name="ell_pack", iters=3)
    extras["spmv_csr_pack_ms"] = round(tp.min_ms, 1)
    Ed = _ell_of(A)  # the dispatcher's own cached pack
    if gate("spmv_csr", 60):
        t = measure_device_loop(
            lambda c, Ed: norm(ell_spmv(Ed, c)), x0, (Ed,), name="spmv_csr", iters=8
        )
        record("spmv_csr", t, fl=2.0 * A.nnz, sol=rlv)
        extras["spmv_csr_gnnz_per_s"] = round(A.nnz / (t.median_ms * 1e-3) / 1e9, 3)
    # spmm_csr_k128 is the dispatcher running the SAME cached ELL pack
    # through the SAME kernel as spmm_ell_k128, so it is diagnostic-only
    if full and gate("spmm_csr_k128", 60):
        t = measure_device_loop(
            lambda c, Ed: norm(ell_spmm(Ed, c)), B0, (Ed,), name="spmm_csr_k128", iters=8
        )
        record("spmm_csr_k128", t)

    # --- preprocessed BlockedCSR (v8 slabs) ---------------------------------
    if P is not None and gate("spmm_blocked_k128", 80):
        from spmm_tpu.ops.blocked import blocked_slab_view, blocked_spmm_slab

        Pd = P.device()
        view = blocked_slab_view(Pd)  # pack-once / multiply-many (v8 slabs)
        t = measure_device_loop(
            lambda c, Pd, v: norm(blocked_spmm_slab(Pd, c, v)),
            B0,
            (Pd, view),
            name="spmm_blocked_k128",
            iters=8,
        )
        record("spmm_blocked_k128", t)

    # --- raw-CSR scatter path (diagnostic; --full only: 2 extra compiles) ---
    if full and gate("raw_csr", 120):
        Ad = A.pad(128).device()
        t = measure_device_loop(
            lambda c, Ad: norm(spmm_xla(Ad, c)), B0, (Ad,), name="spmm_csr_raw_k128", iters=8
        )
        record("spmm_csr_raw_k128", t)
        t = measure_device_loop(
            lambda c, Ad: norm(spmv_xla(Ad, c)), x0, (Ad,), name="spmv_csr_raw", iters=8
        )
        record("spmv_csr_raw", t, fl=2.0 * A.nnz, sol=rlv)
    return extras


def bench_spgemm(A, chip, start_scaling=None):
    """Slab-kernel SpGEMM timing: full multiply (sizing + plan + stream +
    numeric), device-resident output, each call ended by
    ``block_until_ready``."""
    import time as _time

    import jax

    from spmm_tpu.ops import spgemm_expand_bound, spgemm_roofline
    from spmm_tpu.ops.slab_spgemm import (
        DEFAULT_CLASSES, DEFAULT_SEG_W, _round_up, spgemm_chain_device,
        spgemm_plan, spgemm_slab_device,
    )

    extras = RESULT  # write-through: a signal-time emit sees partial sections
    expand = spgemm_expand_bound(A, A)
    log(f"spgemm expansion: {expand/1e6:.1f} M partial products")
    Ad = A.device()  # matrix resident on device, as in steady-state use

    def run():
        # fused path: sizing (native host pass) + ONE device dispatch
        outs, tails, _ = spgemm_slab_device(A, A, A_dev=Ad, B_dev=Ad)
        return jax.block_until_ready(outs)

    outs = run()  # warm/compile
    times = []
    for _ in range(5):
        t0 = _time.perf_counter()
        outs = run()
        times.append((_time.perf_counter() - t0) * 1e3)
    ms = min(times)
    if start_scaling is not None:
        # the CPU-mesh scaling subprocess competes for host cores with the
        # cold timing's host sizing pass — launch it only after the cold loop
        start_scaling()
    out_nnz = int(sum(int(np.asarray(o[3]).sum()) for o in outs))
    rl = spgemm_roofline(expand, A.nnz, A.nnz, out_nnz, chip=chip)
    log(f"spgemm_slab: {ms:.1f} ms, out_nnz={out_nnz}")
    extras["spgemm_ms"] = round(ms, 1)
    extras["spgemm_gflops"] = round(2.0 * expand / (ms * 1e-3) / 1e9, 2)
    extras["spgemm_mnnz_out_per_s"] = round(out_nnz / (ms * 1e-3) / 1e6, 1)
    extras["spgemm_sol_frac"] = round(rl.efficiency(ms * 1e-3), 3)
    extras["spgemm_out_nnz"] = out_nnz
    W = DEFAULT_SEG_W
    cl = tuple(sorted({_round_up(c, W) for c in DEFAULT_CLASSES}))

    # two-phase (symbolic/numeric) steady state: build the plan once, then
    # re-execute only the numeric chunks — the reference's whole premise is
    # preprocess-once / multiply-many (SURVEY.md §0), and this is the SpGEMM
    # analog (cuSPARSE-style reuse: same structure, repeated products)
    if gate("spgemm_warm_run", 200):
        try:
            pts = []
            for _ in range(2):
                t0 = _time.perf_counter()
                plan = jax.block_until_ready(spgemm_plan(A, A, A_dev=Ad, B_dev=Ad))
                pts.append((_time.perf_counter() - t0) * 1e3)
            extras["spgemm_plan_ms"] = round(min(pts), 1)

            def run_warm():
                outs, _, _ = spgemm_slab_device(A, A, plan=plan)
                return jax.block_until_ready(outs)

            outs_w = run_warm()  # compiles _fused_numeric_aligned
            wnnz = int(sum(int(np.asarray(o[3]).sum()) for o in outs_w))
            assert wnnz == out_nnz, (wnnz, out_nnz)
            times = []
            for _ in range(5):
                t0 = _time.perf_counter()
                run_warm()
                times.append((_time.perf_counter() - t0) * 1e3)
            wms = min(times)
            log(f"spgemm_warm (plan reuse): {wms:.1f} ms")
            extras["spgemm_warm_ms"] = round(wms, 1)
            extras["spgemm_warm_mnnz_out_per_s"] = round(out_nnz / (wms * 1e-3) / 1e6, 1)

            # chained execution: N products queued back to back, one wait
            NCHAIN = 8
            jax.block_until_ready(spgemm_chain_device(plan, 2))  # warm
            times = []
            for _ in range(3):
                t0 = _time.perf_counter()
                jax.block_until_ready(spgemm_chain_device(plan, NCHAIN))
                times.append((_time.perf_counter() - t0) * 1e3)
            cms = min(times) / NCHAIN
            log(f"spgemm_chain ({NCHAIN} products, one wait): {cms:.1f} ms/product")
            extras["spgemm_chain_ms"] = round(cms, 1)
        except Exception as e:  # keep the cold extras on warm-path failure
            log("spgemm warm bench failed:", repr(e))
            extras["spgemm_warm_error"] = repr(e)[:200]

    # projected N=8 scaling-efficiency cap: SPMD SpGEMM (config 5) has no
    # inter-shard communication, so efficiency = mean/max per-shard expansion
    # (the uniform schedule waits for the heaviest shard).  The preprocessing
    # reorder + uniform row split is what controls this balance.
    try:
        from spmm_tpu.parallel.partition import partition_rows
        from spmm_tpu.parallel.spgemm_spmd import _per_shard_sizing

        S8 = partition_rows(A, 8)
        _, counts8, _, _ = _per_shard_sizing(S8, A, W, cl)
        # per-shard padded expansion = sum over classes of count * class size
        exp8 = (counts8[:, : len(cl)] * np.asarray(cl)[None, :]).sum(axis=1)
        extras["spgemm_shard_balance_8"] = round(float(exp8.mean() / exp8.max()), 3)
    except Exception as e:
        log("shard balance failed:", repr(e))
    return extras


def bench_scaling_start(*, quick: bool = False):
    """Launch the 1/2/4/8-virtual-device SPMD SpGEMM scaling run as a
    subprocess pinned to the CPU (benchmarks/scaling_cpu.py sets
    JAX_PLATFORMS=cpu before importing JAX, so it never opens the GPU): its
    minutes of XLA CPU compile overlap the device sections."""
    import subprocess

    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "benchmarks", "scaling_cpu.py")
    sub_budget = max(45.0, min(500.0, time_left() - 90.0))
    cmd = [sys.executable, script, "--budget", str(sub_budget)]
    if quick:
        cmd += ["--n", "12000", "--nnz", "72000", "--iters", "1"]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env, cwd=root,
    )


def bench_scaling_collect(proc):
    try:
        out_s, _ = proc.communicate(timeout=max(20.0, time_left() - 20.0))
    except Exception:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"scaling_cpu exited {proc.returncode}")
    line = [l for l in out_s.strip().splitlines() if l.startswith("{")][-1]
    out = json.loads(line)
    log("scaling:", out)
    return out


def bench_dist_big(chip):
    """Streamed distributed SpGEMM (spgemm_dist_big) on a 1-device mesh with
    forced multi-piece streaming: the code path of the >=100M-nnz product
    (benchmarks/dist_big_cpu.py runs that scale on a CPU mesh) at a
    budget-sized scale, with its streaming throughput."""
    import time as _time

    import jax
    from jax.sharding import Mesh

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel.spgemm_spmd import spgemm_dist_big

    extras = RESULT
    G = webgraph_like(1_000_000, 8_000_000, seed=5)
    mesh = Mesh(np.array(jax.devices()[:1]), ("rows",))
    t0 = _time.perf_counter()
    spgemm_dist_big(G, G, mesh, pieces=4)  # compiles the piece program
    extras["spgemm_dist_big_first_call_ms"] = round((_time.perf_counter() - t0) * 1e3, 1)
    t0 = _time.perf_counter()
    C = spgemm_dist_big(G, G, mesh, pieces=4)
    ms = (_time.perf_counter() - t0) * 1e3
    extras["spgemm_dist_big_ms"] = round(ms, 1)
    extras["spgemm_dist_big_nnz_out"] = int(C.nnz)
    extras["spgemm_dist_big_mnnz_out_per_s"] = round(C.nnz / (ms * 1e-3) / 1e6, 1)
    extras["spgemm_dist_big_pieces"] = 4
    log(f"spgemm_dist_big (1M rows / {G.nnz/1e6:.1f}M nnz, 4 pieces): "
        f"{ms:.0f} ms -> {C.nnz/1e6:.1f}M out")
    return extras


# the reference's evaluation suite (README.md:12-18) as synthetic analogs
# (SuiteSparse is unreachable without egress; shapes/nnz match the originals)
SUITE = {
    "web-Stanford": (281_903, 2_312_497),
    "web-Google": (916_428, 5_105_039),
    "sx-askubuntu": (159_316, 964_437),
}


def bench_suite(cfg):
    """Preprocessing + SpGEMM A x A across the reference's matrix suite
    (web-Google's own numbers come from the main sections; here the other
    two)."""
    import jax

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.slab_spgemm import spgemm_slab_device

    extras = RESULT  # write-through: a signal-time emit sees partial sections
    for name, (n, nnz) in SUITE.items():
        if name == "web-Google":
            continue
        if not gate(f"suite:{name}", 55):
            break
        A = webgraph_like(n, nnz, seed=1)
        pre_ms, _ = bench_preprocess(A, cfg, iters=3)
        extras[f"{name}_preprocess_ms"] = round(pre_ms, 1)
        Ad = A.device()
        import time as _t

        def run():
            outs, _, _ = spgemm_slab_device(A, A, A_dev=Ad, B_dev=Ad)
            return jax.block_until_ready(outs)

        run()
        ts = []
        for _ in range(2):
            t0 = _t.perf_counter()
            run()
            ts.append((_t.perf_counter() - t0) * 1e3)
        extras[f"{name}_spgemm_ms"] = round(min(ts), 1)
        log(f"suite {name}: preprocess {pre_ms:.1f} ms, spgemm {min(ts):.1f} ms")
    return extras


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="small matrix, fast run")
    ap.add_argument("--full", action="store_true",
                    help="include diagnostic raw-CSR scatter-path measurements")
    ap.add_argument("--no-kernels", action="store_true")
    ap.add_argument("--no-spgemm", action="store_true")
    ap.add_argument("--no-suite", action="store_true")
    ap.add_argument("--no-scaling", action="store_true")
    ap.add_argument("--matrix", default=None, metavar="PATH",
                    help="bench a real .mtx (pattern-ingested, reference "
                    "contract) instead of the synthetic web graph")
    args = ap.parse_args()

    import jax

    from spmm_tpu.config import Config
    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.ops.roofline import detect_chip
    from spmm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    d = jax.devices()[0]
    RESULT["device"] = {"platform": d.platform, "kind": d.device_kind,
                        "count": len(jax.devices())}
    chip = detect_chip()  # raises for a device without published peaks

    if args.quick:
        n, nnz = 50_000, 300_000
    else:
        n, nnz = WEBGOOGLE_N, WEBGOOGLE_NNZ

    t0 = time.perf_counter()
    if args.matrix:
        # real matrix: the reference ingest contract (values forced to 1.0,
        # SURVEY.md §2.1) — when a SuiteSparse .mtx is available it drops in
        # here and every number below is on the real workload
        from spmm_tpu.formats.mtx import read_mtx
        from spmm_tpu.formats.containers import to_csr

        A = to_csr(read_mtx(args.matrix))
        n, nnz = A.shape[0], A.nnz
        log(f"matrix {args.matrix}: {A.shape} nnz={A.nnz} "
            f"({time.perf_counter()-t0:.1f}s)")
    else:
        A = webgraph_like(n, nnz, seed=0)
        log(f"synthetic web graph: {A.shape} nnz={A.nnz} ({time.perf_counter()-t0:.1f}s)")

    cfg = Config()
    pre_ms, P = bench_preprocess(A, cfg)
    mnnz_s = A.nnz / (pre_ms * 1e-3) / 1e6
    log(f"preprocess: {pre_ms:.1f} ms ({mnnz_s:.1f} M nnz/s)")
    RESULT["value"] = round(pre_ms, 1)
    RESULT.update(
        nnz=int(A.nnz),
        n=int(n),
        preprocess_mnnz_per_s=round(mnnz_s, 2),
        regions=P.nregions,
        v8_groups=P.ngroups,
    )

    scaling_state: dict = {"proc": None}

    def start_scaling():
        if scaling_state["proc"] is not None or args.no_scaling:
            return
        if not gate("scaling", 90):
            return
        try:
            scaling_state["proc"] = bench_scaling_start(quick=args.quick)
        except Exception as e:
            log("scaling launch failed:", repr(e))
            RESULT["scaling_error"] = repr(e)[:200]

    if not args.no_spgemm and gate("spgemm", 150):
        try:
            RESULT.update(bench_spgemm(A, chip, start_scaling=start_scaling))
        except Exception as e:
            log("spgemm bench failed:", repr(e))
            RESULT["spgemm_error"] = repr(e)[:200]
    start_scaling()  # if the spgemm section was skipped or died early
    if not args.no_kernels and gate("kernels", 120):
        try:
            RESULT.update(bench_kernels(A, P, k=128, chip=chip, full=args.full))
        except Exception as e:  # keep the headline alive on kernel failure
            log("kernel bench failed:", repr(e))
            RESULT["kernel_error"] = repr(e)[:200]

    def collect_scaling(*, only_if_done: bool = False):
        proc = scaling_state["proc"]
        if proc is None or scaling_state.get("collected"):
            return
        if only_if_done and proc.poll() is None:
            return
        try:
            RESULT.update(bench_scaling_collect(proc))
        except Exception as e:
            log("scaling bench failed:", repr(e))
            RESULT["scaling_error"] = repr(e)[:200]
        scaling_state["collected"] = True

    # harvest a finished scaling subprocess BEFORE the suite
    collect_scaling(only_if_done=True)
    if not args.no_suite and not args.quick and gate("suite", 110):
        try:
            RESULT.update(bench_suite(cfg))
        except Exception as e:
            log("suite bench failed:", repr(e))
            RESULT["suite_error"] = repr(e)[:200]
    if not args.no_spgemm and not args.quick and gate("dist_big", 120):
        try:
            RESULT.update(bench_dist_big(chip))
        except Exception as e:
            log("dist_big bench failed:", repr(e))
            RESULT["dist_big_error"] = repr(e)[:200]
    collect_scaling()

    emit()
    if errors():
        log("failed sections:", ", ".join(errors()))
        return 1
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception as e:  # the JSON line is emitted in EVERY exit path
        RESULT["error"] = repr(e)[:300]
        emit()
        raise
    sys.exit(rc)
