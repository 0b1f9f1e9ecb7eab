"""HLO schedule evidence for halo-exchange / compute overlap.

SURVEY.md §2.12 mandates the halo exchange be "overlapped with block-product
compute"; DESIGN §5 argued overlap-by-dataflow (the A-side plan stages carry
no data dependence on the collective).  This script replaces the argument
with the compiler's own schedule: it compiles the runtime-halo-exchange SPMD
program (``spgemm_dist_halo_exchange``'s ``_make_spmd_run(exchange=True)``)
on the 8-device CPU mesh, walks the optimized HLO, and reports where the
``all-to-all`` sits relative to the A-side plan computation.

What to look for: the A-side plan stages (the pa step-function scatter,
cumsums, and the class sort — all functions of A's indptr/indices only)
appearing BEFORE or BETWEEN the all-to-all instructions in the schedule
order means XLA is free to run them while the collective is in flight
(async collective start/done pairs make this explicit when present).

Run:  python benchmarks/halo_overlap_hlo.py
"""

from __future__ import annotations

import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

from spmm_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import numpy as np


def main():
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from spmm_tpu.formats.synthetic import webgraph_like
    from spmm_tpu.parallel.partition import partition_rows
    from spmm_tpu.parallel import spgemm_spmd as spmd

    mesh = Mesh(np.array(jax.devices()).reshape(-1), ("rows",))
    nsh = 8
    A = webgraph_like(2048, 12000, seed=13)
    S = partition_rows(A, nsh)

    # Build exactly the program spgemm_dist_halo_exchange runs, but stop at
    # the lowered/compiled module instead of executing it.
    W = spmd.DEFAULT_SEG_W
    classes = tuple(sorted({spmd._round_up(c, W) for c in (16, 64, 256)}))
    A_rel, lb_iptr, _li, _ld, halo_rows, _hc = spmd.partition_halo(S, A)
    cls, counts, npa_max, nnz_s = spmd._per_shard_sizing(
        A_rel, A, W, classes, b_iptr_per_shard=lb_iptr
    )
    sched, starts, cnts, _ = spmd._uniform_schedule(
        counts=counts[:, : len(classes) + 1], classes=classes, slot_budget=1 << 14
    )
    b_part = partition_rows(A, nsh)
    b_iptr_g = np.asarray(A.indptr, np.int64)
    send_src, recv_gather, _ = spmd._exchange_maps(halo_rows, b_part, b_iptr_g)
    lenB_loc = lb_iptr[:, 1:] - lb_iptr[:, :-1]
    nsegB = int(((lenB_loc + W - 1) // W).sum(axis=1).max())
    max_chunk = spmd._bucket_pow2(max((1 << 14) // classes[0], 8))
    rows_pad = S.rows_per_shard
    kw = dict(
        W=W,
        npa_pad=spmd._round_up(npa_max, 1024),
        nsegB_pad=spmd._nseg_pad(nsegB),
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        b2_ws=spmd._pick_b2_ws(W, True, np.dtype(np.float32), spmd._nseg_pad(nsegB)),
    )
    import jax.numpy as jnp

    run = spmd._make_spmd_run(
        mesh, "rows", tuple(sched), kw, W, jnp.float32, True,
        b_sharded=True, exchange=True,
    )

    sharding = NamedSharding(mesh, P("rows"))
    dev = lambda a: jax.device_put(np.asarray(a), sharding)
    sc_tab = np.stack([starts, cnts], axis=1)
    args = (
        dev(np.asarray(A_rel.indptr, np.int32)),
        dev(np.asarray(A_rel.indices, np.int32)),
        dev(np.asarray(A_rel.data)),
        dev(cls),
        dev(nnz_s[:, None]),
        dev(sc_tab),
        dev(np.asarray(b_part.indptr, np.int32)),
        dev(np.asarray(b_part.indices, np.int32)),
        dev(np.asarray(b_part.data)),
        dev(send_src),
        dev(recv_gather),
        dev(lb_iptr.astype(np.int32)),
    )
    compiled = run.lower(*args).compile()
    hlo = compiled.as_text()

    # The CPU backend lowers collectives SYNCHRONOUSLY (no start/done pair),
    # so the printed order cannot demonstrate overlap directly.  What it CAN
    # demonstrate — and what an async scheduler (XLA's latency-hiding
    # scheduler on GPUs) needs — is SCHEDULABILITY: the fraction of the program's
    # compute that carries no data dependence on the collective.  Parse the
    # entry computation's def-use graph and split the heavy ops (fusions /
    # sorts / scatters / gathers) into collective-dependent vs independent.
    lines = hlo.splitlines()
    # entry computation = last computation block in the dump
    entry_start = max(
        i for i, l in enumerate(lines) if l.startswith("ENTRY ")
    )
    entry = lines[entry_start:]
    defs = {}  # name -> (line_idx, full line)
    order = []
    for i, l in enumerate(entry):
        m = re.match(r"\s+(%[\w.\-]+)\s*=\s*", l)
        if m:
            defs[m.group(1)] = (i, l)
            order.append(m.group(1))
    a2a_names = [n for n in order if re.search(r"\ball-to-all\(", defs[n][1])]
    if not a2a_names:
        print("NO all-to-all found — did the exchange path compile?")
        sys.exit(1)
    # forward closure: everything that (transitively) consumes the collective
    dependent = set(a2a_names)
    for n in order:  # single pass suffices: defs appear before uses
        _, l = defs[n]
        ops = set(re.findall(r"%[\w.\-]+", l.split("=", 1)[1]))
        if ops & dependent:
            dependent.add(n)
    heavy = [
        n for n in order
        if re.search(r"\b(fusion|sort|scatter|gather|reduce-window)\(",
                     defs[n][1])
    ]
    heavy = [n for n in heavy if n not in a2a_names]
    dep_h = [n for n in heavy if n in dependent]
    ind_h = [n for n in heavy if n not in dependent]
    print(f"entry instructions: {len(order)}; all-to-all ops: {len(a2a_names)}")
    print(f"heavy compute ops (fusion/sort/scatter/gather): {len(heavy)}")
    print(f"  dependent on the collective (must wait):      {len(dep_h)}")
    print(f"  INDEPENDENT (schedulable alongside it):       {len(ind_h)} "
          f"({100.0 * len(ind_h) / max(len(heavy), 1):.0f}%)")
    has_async = any("all-to-all-start" in l for l in lines)
    print(f"async collective pair in this (CPU) lowering: {has_async} "
          "(GPU backends lower collectives async; independence above is "
          "what their latency-hiding scheduler overlaps)")

    # positional excerpt: the sync CPU schedule around the first all-to-all
    first_idx = defs[a2a_names[0]][0]
    print("\n--- entry-computation excerpt around the all-to-all ---")
    for i in range(max(first_idx - 4, 0), min(first_idx + 5, len(entry))):
        print(f"{i:5d}  {entry[i].strip()[:140]}")
    # name a few independent heavy ops for the DESIGN note
    print("\nfirst 8 collective-independent heavy ops (A-side plan work an "
          "async schedule may run during the exchange):")
    for n in ind_h[:8]:
        print("  ", defs[n][1].strip()[:140])


if __name__ == "__main__":
    main()
