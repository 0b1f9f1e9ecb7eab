#!/usr/bin/env python
"""Smoke run of spmm_tpu on a GPU: the main paths once, at full size.

    python chip_smoke.py               # every single-card phase on one GPU
    python chip_smoke.py --chips 4     # the distributed phase on four GPUs

Data is generated from ``--seed``.  The workload is the reference's: a
web-Google-sized synthetic graph (916,428 rows, ~5.1M nonzeros).  Each phase
drives the library through its public entry points and compares the result
with scipy/numpy on the host: pattern SpGEMM exactly (path counts stay below
2^24, so fp32 values are exact), float products to
max |err| <= 1e-4 * max |ref| against a float64 reference.  Every product on
these paths asks for full fp32 precision, so TF32 would fail that bound.

Per-phase compile and steady times are printed as smoke timings: one call
each, not benchmark numbers.  The last line of standard output is one JSON
object naming the device; it is printed only when every phase passed.  The
script exits non-zero when JAX finds no GPU or any phase fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

WEBGOOGLE_N = 916_428
WEBGOOGLE_NNZ = 5_105_039
REL_TOL = 1e-4  # max |err| / max |ref| for float products (fp32 vs float64)
ROOT = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------- checks
def require(cond, msg) -> None:
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    require(got.shape == ref.shape, (got.shape, ref.shape))
    require(np.isfinite(got).all(), "non-finite values")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def check_close(name: str, got, ref) -> str:
    e = rel_err(got, ref)
    require(e <= REL_TOL, f"{name}: max|err|/max|ref| = {e:.3e} > {REL_TOL}")
    return f"{name} rel_err={e:.2e}"


def scipy_product(A, B=None):
    a = A.to_scipy().astype(np.float64)
    b = a if B is None else B.to_scipy().astype(np.float64)
    C = (a @ b).tocsr()
    C.sum_duplicates()
    C.sort_indices()
    return C


def check_csr_exact(name: str, C, ref, *, values: bool = True) -> str:
    """Structure (nnz, indptr, indices) equal to scipy's; values equal too
    when ``values`` (pattern products), else within REL_TOL."""
    nnz = int(C.nnz)
    require(nnz == ref.nnz, f"{name}: nnz {nnz} != scipy {ref.nnz}")
    np.testing.assert_array_equal(
        np.asarray(C.indptr, np.int64)[: C.shape[0] + 1], ref.indptr, err_msg=name
    )
    np.testing.assert_array_equal(
        np.asarray(C.indices)[:nnz], ref.indices, err_msg=name
    )
    data = np.asarray(C.data)[:nnz]
    if values:
        np.testing.assert_array_equal(data.astype(np.float64), ref.data, err_msg=name)
        return f"{name} exact nnz={nnz}"
    return f"{name} exact structure nnz={nnz}; " + check_close("values", data, ref.data)


def slab_outputs_to_csr(A, B, outs, tail_rows):
    """Assemble ``spgemm_slab_device``-style chunk outputs (plus the host
    fallback's heavy-tail rows) into one host CSR."""
    from spmm_tpu.ops import slab_spgemm as ss

    rows, cols, vals = ss._pull_chunks(outs)
    if len(tail_rows):
        tr, tc, tv = ss._tail_products(
            A.host(), np.asarray(tail_rows, np.int64), B.host(), np.float32
        )
        rows, cols, vals = rows + [tr], cols + [tc], vals + [tv]
    return ss._assemble_csr(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        (A.nrow, B.ncol),
    )


def ready(x):
    import jax

    return jax.block_until_ready(x)


def twice(fn):
    """Call ``fn`` twice: (result, first-call seconds, second-call seconds).
    The first call includes compilation."""
    t0 = time.perf_counter()
    ready(fn())
    t1 = time.perf_counter()
    out = ready(fn())
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


# ---------------------------------------------------------------- phases
# Each phase returns a list of (check line, compile s, steady s).


def phase_cli(A, workdir: str):
    """Reference-compatible entry point: pattern .mtx -> spmm_tpu.cli."""
    from spmm_tpu import cli
    from spmm_tpu.formats.containers import to_coo
    from spmm_tpu.formats.mtx import write_mtx

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "graph.mtx")
    write_mtx(path, to_coo(A), pattern=True)
    t0 = time.perf_counter()
    (r,) = cli.run(["--matrix", path, "--spgemm", "--spmm", "128", "--check"])
    wall = time.perf_counter() - t0
    require(r["nnz"] == A.nnz, (r["nnz"], A.nnz))
    require(r["spmm_rel_err"] <= REL_TOL, r["spmm_rel_err"])
    require(r["spgemm_exact"], "cli SpGEMM differs from scipy")
    return [(
        f"cli preprocess_ms={r['preprocess_ms']:.1f} spmm_k128 "
        f"rel_err={r['spmm_rel_err']:.2e} spgemm exact nnz={r['spgemm_out_nnz']}",
        wall, r["spmm_ms"] * 1e-3,
    )]


def phase_blocked(A, seed: int):
    """Preprocess -> BlockedCSR -> blocked_spmm_slab (k=128)."""
    import jax.numpy as jnp

    from spmm_tpu.config import Config
    from spmm_tpu.ops.blocked import blocked_slab_view, blocked_spmm_slab
    from spmm_tpu.preprocess import preprocess

    P = preprocess(A, Config()).device()
    view = blocked_slab_view(P)
    B = np.random.default_rng(seed).standard_normal((A.shape[1], 128)).astype(np.float32)
    Bd = jnp.asarray(B)
    Y, c, s = twice(lambda: blocked_spmm_slab(P, Bd, view))
    ref = A.to_scipy().astype(np.float64) @ B.astype(np.float64)
    return [(check_close("blocked_spmm_slab k=128", Y, ref), c, s)]


def phase_ell(A, seed: int):
    """ELL SpMM (k=128, k=32) and SpMV through the CSR dispatchers."""
    import jax.numpy as jnp

    from spmm_tpu import ops

    S = A.to_scipy().astype(np.float64)
    rng = np.random.default_rng(seed)
    out = []
    for k in (128, 32):
        B = rng.standard_normal((A.shape[1], k)).astype(np.float32)
        Bd = jnp.asarray(B)
        Y, c, s = twice(lambda: ops.spmm(A, Bd))
        out.append((check_close(f"spmm k={k}", Y, S @ B.astype(np.float64)), c, s))
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    xd = jnp.asarray(x)
    y, c, s = twice(lambda: ops.spmv(A, xd))
    out.append((check_close("spmv", y, S @ x.astype(np.float64)), c, s))
    return out


def phase_spgemm(A):
    """SpGEMM A x A: cold, plan reuse, chained — exact scipy parity."""
    from spmm_tpu import ops
    from spmm_tpu.ops.slab_spgemm import (
        spgemm_chain_device, spgemm_plan, spgemm_slab_device,
    )

    ref = scipy_product(A)
    out = []
    # a fresh operand object per call: repeated products over the SAME
    # objects switch spgemm to its cached plan, which is the next check
    C, c, s = twice(lambda: ops.spgemm(dataclasses.replace(A), dataclasses.replace(A)))
    out.append((check_csr_exact("spgemm cold", C, ref), c, s))

    t0 = time.perf_counter()
    plan = ready(spgemm_plan(A, A))
    plan_s = time.perf_counter() - t0
    (outs, tails, _), c, s = twice(lambda: spgemm_slab_device(A, A, plan=plan))
    C = slab_outputs_to_csr(A, A, outs, tails)
    out.append((check_csr_exact("spgemm plan reuse", C, ref)
                + f" (plan build {plan_s:.2f}s)", c, s))

    nchain = 4
    outs, c, s = twice(lambda: spgemm_chain_device(plan, nchain))
    C = slab_outputs_to_csr(A, A, outs, tails)
    out.append((check_csr_exact(f"spgemm chained x{nchain}", C, ref), c, s / nchain))
    return out


def phase_stream(n: int, nnz: int, seed: int, pieces: int = 4):
    """Streamed product spgemm_dist_big on a one-device mesh."""
    import jax
    from jax.sharding import Mesh

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import spgemm_dist_big

    G = webgraph_like(n, nnz, seed=seed)
    mesh = Mesh(np.array(jax.devices()[:1]), ("rows",))
    C, c, s = twice(lambda: spgemm_dist_big(G, G, mesh, pieces=pieces))
    ref = scipy_product(G)
    return [(check_csr_exact(f"spgemm_dist_big {pieces} pieces", C, ref), c, s)]


def phase_bsr(n: int, band: int, density: float, seed: int, k: int = 128):
    """BSR SpMM through the dispatcher and the XLA formulation, and SpMV."""
    import jax.numpy as jnp

    from spmm_tpu import ops
    from spmm_tpu.formats.bsr import csr_to_bsr
    from spmm_tpu.formats.synthetic import banded_random
    from spmm_tpu.ops.pallas_bsr import bsr_spmm_xla, bsr_spmv

    Ab = banded_random(n, band, density, seed=seed)
    Bs = csr_to_bsr(Ab).device()
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, k)).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    Bd, xd = jnp.asarray(B), jnp.asarray(x)
    S = Ab.to_scipy().astype(np.float64)
    ref = S @ B.astype(np.float64)
    out = []
    Y, c, s = twice(lambda: ops.spmm(Bs, Bd))
    out.append((check_close(f"bsr spmm k={k} nblocks={Bs.nblocks}", Y, ref), c, s))
    Yx, c, s = twice(lambda: bsr_spmm_xla(Bs, Bd))
    out.append((check_close("bsr_spmm_xla", Yx, ref), c, s))
    y, c, s = twice(lambda: bsr_spmv(Bs, xd))
    out.append((check_close("bsr_spmv", y, S @ x.astype(np.float64)), c, s))
    return out


def phase_multichip(n_devices: int, n: int, nnz: int, seed: int, *,
                    k: int = 128, pieces: int = 2, **spgemm_kw):
    """The distributed strategies of spmm_tpu.parallel on an
    ``n_devices``-way mesh, each against scipy.  ``spgemm_kw`` (classes,
    slot_budget) shrinks the SpGEMM schedules for tiny test sizes."""
    import jax
    import jax.numpy as jnp

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel import (
        make_mesh, partition_cols, partition_rows, spgemm_dist_big,
        spgemm_dist_exec, spgemm_dist_plan, spgemm_dist_revalue,
        spgemm_dist_spmd, spmm_dist_colsplit, spmm_dist_ring, unshard_rows,
    )

    require(len(jax.devices()) >= n_devices, (len(jax.devices()), n_devices))
    mesh = make_mesh((n_devices,), ("rows",), devices=jax.devices()[:n_devices])
    A = webgraph_like(n, nnz, seed=seed)
    S = partition_rows(A, n_devices)
    Sp = A.to_scipy().astype(np.float64)
    rng = np.random.default_rng(seed)
    out = []

    B = rng.standard_normal((A.shape[1], k)).astype(np.float32)
    ref = Sp @ B.astype(np.float64)
    Bpad = np.zeros((S.rows_per_shard * n_devices, k), np.float32)
    Bpad[: A.shape[1]] = B
    Bpd = jnp.asarray(Bpad)
    Y, c, s = twice(lambda: spmm_dist_ring(S, Bpd, mesh))
    out.append((check_close(f"spmm_dist_ring k={k}", unshard_rows(np.asarray(Y), S), ref),
                c, s))
    Sc = partition_cols(A, n_devices)
    Bd = jnp.asarray(B)
    Y, c, s = twice(lambda: spmm_dist_colsplit(Sc, Bd, mesh))
    out.append((check_close(f"spmm_dist_colsplit k={k}",
                            np.asarray(Y).reshape(-1, k)[: A.shape[0]], ref), c, s))

    refC = scipy_product(A)
    C, c, s = twice(lambda: spgemm_dist_spmd(S, A, mesh, **spgemm_kw))
    out.append((check_csr_exact("spgemm_dist_spmd", C, refC), c, s))

    t0 = time.perf_counter()
    plan = spgemm_dist_plan(S, A, mesh, b_sharded=True, **spgemm_kw)
    plan_s = time.perf_counter() - t0
    C, c, s = twice(lambda: spgemm_dist_exec(plan, mesh))
    out.append((check_csr_exact("spgemm_dist_plan/exec b_sharded", C, refC)
                + f" (plan {plan_s:.2f}s)", c, s))
    del plan

    def valued(vseed):
        shape = np.asarray(A.data).shape
        data = np.random.default_rng(vseed).standard_normal(shape).astype(np.float32)
        return dataclasses.replace(A, data=data)

    Av1, Av2 = valued(seed + 1), valued(seed + 2)
    plan_v = spgemm_dist_plan(partition_rows(Av1, n_devices), Av1, mesh, **spgemm_kw)
    S2 = partition_rows(Av2, n_devices)
    t0 = time.perf_counter()
    plan_v2 = spgemm_dist_revalue(plan_v, S2, Av2, mesh)
    rev_s = time.perf_counter() - t0
    C, c, s = twice(lambda: spgemm_dist_exec(plan_v2, mesh))
    out.append((check_csr_exact("spgemm_dist_revalue", C, scipy_product(Av2),
                                values=False) + f" (revalue {rev_s:.2f}s)", c, s))
    del plan_v, plan_v2

    C, c, s = twice(lambda: spgemm_dist_big(A, A, mesh, pieces=pieces, b_sharded=True,
                                            **spgemm_kw))
    out.append((check_csr_exact(f"spgemm_dist_big b_sharded {pieces} pieces", C, refC),
                c, s))
    return out


# ---------------------------------------------------------------- driver
def device_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e!r}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the distributed phase on four GPUs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    from spmm_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}", file=sys.stderr)
        return 1
    if len(devs) < args.chips:
        print(f"chip_smoke: --chips {args.chips} needs {args.chips} GPUs, "
              f"found {len(devs)}", file=sys.stderr)
        return 1
    enable_compile_cache()
    print(f"device: {device_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}", flush=True)
    print("timings below are smoke timings (one call each), not benchmark numbers",
          flush=True)

    seed = args.seed
    if args.chips == 4:
        phases = [("multichip x4", lambda: phase_multichip(
            4, WEBGOOGLE_N, WEBGOOGLE_NNZ, seed))]
    else:
        from spmm_tpu.formats.synthetic import webgraph_like

        A = webgraph_like(WEBGOOGLE_N, WEBGOOGLE_NNZ, seed=seed)
        print(f"graph: {A.shape[0]} rows, {A.nnz} nnz (seed {seed})", flush=True)
        phases = [
            ("ingest+cli", lambda: phase_cli(A, os.path.join(ROOT, ".smoke_tmp"))),
            ("blocked", lambda: phase_blocked(A, seed)),
            ("ell", lambda: phase_ell(A, seed)),
            ("spgemm", lambda: phase_spgemm(A)),
            ("stream", lambda: phase_stream(1_000_000, 8_000_000, seed + 5)),
            ("bsr", lambda: phase_bsr(65536, 512, 0.25, seed + 3)),
        ]

    failed = []
    t_all = time.perf_counter()
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            lines = run()
        except Exception:
            failed.append(name)
            print(f"phase {name}: FAIL after {time.perf_counter() - t0:.1f}s", flush=True)
            traceback.print_exc()
            continue
        for check, c, s in lines:
            print(f"phase {name}: ok  {check}  [smoke: first call {c:.2f}s, "
                  f"steady {s * 1e3:.1f} ms]", flush=True)
        print(f"phase {name}: done in {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"total {time.perf_counter() - t_all:.1f}s", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    d = devs[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
