"""CLI driver — reference-compatible batch preprocessing + compute.

Mirrors the reference's driver contract (reference:
serial_newblock_clock.cpp:501-599, README.md:11-24): run in a directory
containing ``matrix.txt`` (one matrix name per line) and
``mat/mtx/<name>/<name>.mtx``; writes ``<name> <preprocess_ms>ms`` lines to
``result.txt`` and a per-phase breakdown to stdout.  Extensions over the
reference: ``--spgemm`` / ``--spmm K`` actually run the compute kernels (with
scipy parity checking via --check), ``--save-format`` persists the packed
format, and a ``--matrix`` flag bypasses the matrix.txt convention.

Usage:
  python -m spmm_tpu.cli [--dir DIR] [--spgemm] [--spmm K] [--check] [...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def process_matrix(path: str, args) -> dict:
    import numpy as np

    from spmm_tpu.config import Config
    from spmm_tpu.formats.mtx import read_mtx
    from spmm_tpu.formats.containers import to_csr
    from spmm_tpu.preprocess import preprocess

    out = {"matrix": os.path.basename(path)}
    t0 = time.perf_counter()
    coo = read_mtx(path, values="pattern" if args.pattern else "native")
    A = to_csr(coo, sort_within_row=True, sum_duplicates=args.dedup)
    out["read_ms"] = (time.perf_counter() - t0) * 1e3
    out["shape"] = A.shape
    out["nnz"] = A.nnz

    cfg = Config(region_budget=args.region_budget, section_size=args.section_size)
    t0 = time.perf_counter()
    P = preprocess(A, cfg)
    out["preprocess_ms"] = (time.perf_counter() - t0) * 1e3
    out["regions"] = P.nregions
    out["v8_groups"] = P.ngroups

    if args.save_format:
        from spmm_tpu.utils.serialize import save

        fmt_path = os.path.splitext(path)[0] + ".blocked.npz"
        save(fmt_path, P)
        out["saved"] = fmt_path

    if args.spmm:
        import jax.numpy as jnp

        from spmm_tpu.formats.ell import ell_pack
        from spmm_tpu.ops.ell_spmm import ell_spmm

        k = args.spmm
        E = ell_pack(A).device()
        B = jnp.asarray(
            np.random.default_rng(0).standard_normal((A.shape[1], k)).astype(np.float32)
        )
        import jax

        f = jax.jit(ell_spmm)
        t0 = time.perf_counter()
        Y = np.asarray(f(E, B))  # includes compile
        out["spmm_compile_ms"] = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        Y = np.asarray(f(E, B))
        out["spmm_ms"] = (time.perf_counter() - t0) * 1e3
        if args.check:
            ref = A.to_scipy().astype(np.float64) @ np.asarray(B, np.float64)
            out["spmm_max_err"] = float(np.abs(Y - ref).max())
            out["spmm_rel_err"] = out["spmm_max_err"] / max(float(np.abs(ref).max()), 1e-30)

    if args.spgemm:
        from spmm_tpu.ops import spgemm

        t0 = time.perf_counter()
        C = spgemm(A, A, checkpoint_dir=args.checkpoint_dir)
        out["spgemm_ms"] = (time.perf_counter() - t0) * 1e3
        out["spgemm_out_nnz"] = C.nnz
        if args.check:
            S = A.to_scipy().astype(np.float64)
            ref = (S @ S).tocsr()
            ref.sum_duplicates()
            ref.sort_indices()
            d = abs(C.to_scipy() - ref)
            out["spgemm_max_err"] = float(d.max()) if d.nnz else 0.0
            # same nnz, row pointers and column order as scipy
            out["spgemm_exact"] = bool(
                C.nnz == ref.nnz
                and np.array_equal(np.asarray(C.indptr, np.int64), ref.indptr)
                and np.array_equal(np.asarray(C.indices)[: C.nnz], ref.indices)
                and out["spgemm_max_err"] == 0.0
            )
    return out


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir", default=".", help="directory with matrix.txt + mat/mtx/...")
    ap.add_argument("--matrix", help="single .mtx path (bypasses matrix.txt)")
    ap.add_argument("--pattern", action="store_true", default=True,
                    help="force values to 1.0 (reference parity; default)")
    ap.add_argument("--values", dest="pattern", action="store_false",
                    help="read real values from the file")
    ap.add_argument("--dedup", action="store_true", help="sum duplicate entries")
    ap.add_argument("--region-budget", type=int, default=65536)
    ap.add_argument("--section-size", type=int, default=2048)
    ap.add_argument("--spmm", type=int, metavar="K", help="run SpMM with a random (n, K) RHS")
    ap.add_argument("--spgemm", action="store_true", help="run SpGEMM A@A")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="piece-granular checkpoint/resume for huge SpGEMM "
                    "products (killed runs resume at the last finished piece)")
    ap.add_argument("--check", action="store_true", help="verify against scipy")
    ap.add_argument("--save-format", action="store_true", help="persist the packed format")
    return ap


def run(argv=None) -> list:
    """Process every matrix ``argv`` names; returns one result dict each
    and prints the reference's per-matrix report.  Raises FileNotFoundError
    when neither ``--matrix`` nor ``DIR/matrix.txt`` exists."""
    args = _parser().parse_args(argv)
    if args.matrix:
        paths = [args.matrix]
    else:
        mlist = os.path.join(args.dir, "matrix.txt")
        if not os.path.exists(mlist):
            raise FileNotFoundError(f"no {mlist}; pass --matrix or --dir")
        with open(mlist) as f:
            names = [ln.split(".")[0].strip() for ln in f if ln.strip()]
        paths = [os.path.join(args.dir, "mat", "mtx", n, f"{n}.mtx") for n in names]

    results = []
    for p in paths:
        r = process_matrix(p, args)
        results.append(r)
        print("----name:%s----" % r["matrix"])  # reference stdout marker (:567)
        for k, v in r.items():
            print(f"  {k}: {v}")

    # result.txt: "<name> <time>ms" per matrix (reference :565)
    if not args.matrix:
        with open(os.path.join(args.dir, "result.txt"), "w") as f:
            for r in results:
                name = os.path.splitext(r["matrix"])[0]
                f.write(f"{name} {r['preprocess_ms']:.3f}ms\n")
    return results


def main(argv=None) -> int:
    try:
        run(argv)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
