"""Slab-sorted ESC SpGEMM — the production sparse×sparse kernel.

The classic ESC (expand/sort/compress) SpGEMM needs a global sort of all E
partial products by (row, col) plus per-element gathers and scatters.  On
the accelerator this kernel was first built for, a global 1-D ``lax.sort``
and the scatters ran at a few hundred M elements/s, while batched
minor-axis sorts of 16-512 wide slabs and aligned 2-D row gathers ran one
to two orders of magnitude faster, and cumsum/elementwise passes faster
still.  Whether that ordering holds on a GPU is open (ROADMAP S7).

So the O(E) path here uses **only aligned 2-D row gathers, batched minor-axis
sorts, and cumsum/cummax** — no scatters, no global sorts, no scalar/window
gathers:

1. **plan** (per A,B pair): pad every B row to a multiple of W into an
   aligned (nsegB, W) table "B2" (built by an nnz(B)-element scatter, not a
   per-slot gather); enumerate the kept (A-nonzero × B-segment) pairs
   ("pa"s).  The partial-product stream in pa order is grouped by output row
   *by construction* — ESC's global sort exists only to recover this
   grouping, which the enumeration order gives for free.
2. **slabs**: rows bucketed into power-of-two padded-expansion classes (the
   ELL slab trick, formats/ell.py — the slab recast of the reference's panel
   length sort, v8sort.h:152-232); each class chunk gathers its (R, L) slab
   DIRECTLY from B2 (pa indirection + one aligned row gather per array —
   no intermediate stream layer).
3. **sort+merge**: one batched minor-axis sort orders every row's columns at
   once; duplicates merge scatter-free — run sums are differences of
   compacted inclusive prefix sums (compaction itself is another batched
   sort).  Output: slab-compressed C (per-row sorted unique columns + counts).

Static shapes throughout (XLA's rule), sized by O(nnz+nrow) host numpy — the
reference's own trick of converting a dynamic working set into a static
budget (transmat.h:339).  Rows whose padded expansion exceeds the largest
class go through the global-sort fallback (ops/spgemm.py); on power-law
graphs they are a tiny fraction.

Reference contract: SpGEMM A×A on pattern matrices is the workload the
reference's preprocessing exists to feed but never ships
(SURVEY.md §3.3-3.4); ground truth is scipy ``A @ A``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spmm_tpu.formats.containers import COO, CSR, to_csr

_INT_MAX = np.int32(np.iinfo(np.int32).max)

#: row-chunking threshold: the device kernel's int32 cumsums require the
#: padded expansion below 2^31, and device memory requires far less — a
#: 2^28-slot piece bounds the plan tables + slab temps to a few GB (a
#: 1G-slot program ran out of memory in practice).  Deriving it from the
#: device's memory is open work (ROADMAP S4).  spgemm_slab splits A's rows when
#: a piece would exceed this (patchable in tests).
_MAX_EXP_PAD = 2**28

#: padded-expansion classes (~1.25x steps); rows above the last use the
#: fallback.  Finer-than-pow2 classes cut total padded slots ~25% on
#: web-Google (68M -> 51M at the 16K row granule) and every per-slot stage
#: (gather, pick, sort, merge) pays proportionally; the fused single-dispatch
#: program makes many small chunks free at runtime (one dispatch regardless)
DEFAULT_CLASSES = (
    4, 8, 12, 16, 20, 24, 32, 40, 48, 64, 80, 96, 128, 160, 192, 256, 320,
    384, 512, 640, 768, 1024, 1280, 1536, 2048, 2560, 3072, 4096, 5120, 6144,
    8192,
)

#: B-segment width: row-gather granule.  Wider segments halve the pa count
#: but inflate the padded slab on power-law graphs, where most B rows are
#: short; every pass downstream pays per slot.  W=8 won end to end on
#: web-Google A×A against W=4 and W=16 on the accelerator this was first
#: built on (not re-measured on a GPU).  W=8 also makes the picked segment
#: exactly the 8-lane fold granule (no dead lanes in the (S, 8) pick output).
DEFAULT_SEG_W = 8

#: slab slot budget per numeric call (slots = R_pad * L).  Large on purpose:
#: fewer, bigger chunks mean fewer programs to dispatch, and a 16M-slot chunk
#: is ~380 MB of working set.  Tuning it to the device is open work
#: (ROADMAP D5).
DEFAULT_SLOT_BUDGET = 1 << 24

#: classes with fewer rows than this fold into the next class up.  Small —
#: the fused path dispatches ONE program regardless of chunk count, so a
#: tiny chunk costs only compiled-program size; folding aggressively (the old
#: 4096) cascaded fine classes into the 8192 ceiling and re-inflated padding
FOLD_THRESHOLD = 256


def _bucket_pow2(x: int, floor: int = 8) -> int:
    b = floor
    while b < x:
        b <<= 1
    return b


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _nseg_pad(nsegB: int) -> int:
    """Padded B2 segment count, guaranteeing >= 1 never-written pad segment:
    the LAST segment is the all-_INT_MAX sentinel that masked chunk blocks
    and non-live pa entries gather (their columns then read as pad and need
    no downstream select)."""
    return _round_up(nsegB + 1, 1024)


def _shift_right(x):
    return jnp.concatenate([x[:, :1], x[:, :-1]], axis=1)


def _fold_ws(w: int) -> int:
    """Smallest divisor of 128 >= w — the per-segment lane stride when a
    logical width-w table is folded into physical (X, 128) rows.

    Tables here are stored as FLAT 1-D linear arrays (no padding) and
    reshaped — free for linear layouts — to (X, 128) full-lane rows of
    128//ws segments each; consumers gather whole rows and one-hot-pick the
    segment (same fold trick as ops/ell_spmm.py narrow-k).  The fold was
    introduced because the first target padded every row of a narrow
    (n, w) table to 128 lanes; whether it pays on a GPU is open (ROADMAP D2)."""
    for d in (1, 2, 4, 8, 16, 32, 64, 128):
        if d >= w:
            return d
    raise ValueError(
        f"folded segment width {w} exceeds one 128-lane row: with value "
        "channels the limit is seg_w <= 128 // (1 + value_words) "
        "(64 for fp32, 42 for fp64); pattern mode allows seg_w up to 128"
    )


def _scatter1d_set(operand, idx, val, *, sorted_: bool, unique: bool):
    """1-D SET scatter with explicit sortedness/uniqueness claims.

    XLA's generic lowering sorts the updates to resolve duplicates; the
    sortedness and uniqueness flags let it skip that sort.  Out-of-range
    indices drop (FILL_OR_DROP) — callers route dead/pad writes to DISTINCT
    out-of-range slots so the uniqueness claim stays true."""
    return jax.lax.scatter(
        operand,
        idx[:, None],
        val,
        jax.lax.ScatterDimensionNumbers(
            update_window_dims=(),
            inserted_window_dims=(0,),
            scatter_dims_to_operand_dims=(0,),
        ),
        indices_are_sorted=sorted_,
        unique_indices=unique,
        mode=jax.lax.GatherScatterMode.FILL_OR_DROP,
    )


def _pick_group(g, grp, ws):
    """(S, 128) gathered rows, (S,) group index -> (S, ws) picked segment."""
    S = g.shape[0]
    g3 = g.reshape(S, 128 // ws, ws)
    io = jax.lax.broadcasted_iota(jnp.int32, g3.shape[:2], 1)
    # dtype pinned: under enable_x64 jnp.sum promotes int32 to int64, which
    # silently doubles the element size the downstream bitcast relies on
    return jnp.sum(
        jnp.where((io == grp[:, None])[:, :, None], g3, 0), axis=1, dtype=g.dtype
    )


def _pick_b2_ws(W: int, pattern: bool, b_dtype, nsegB_pad: int) -> int:
    """B2 per-segment stride: the FOLD width rounded up to >= 8 lanes.

    A compact folded table with a one-hot pick over <= 16 groups gathered
    ~3x faster than full-width 128-lane rows on the accelerator this was
    first built on (benchmarks/micro_b2gather.py); not re-measured on a
    GPU."""
    nvb = 0 if pattern else np.dtype(b_dtype).itemsize // 4
    ws = _fold_ws(W if pattern else (1 + nvb) * W)
    return max(ws, 8)


def _extract_window(table128, start, nwin):
    """``table128``: folded (X, 128) view of a flat array; ``start``: (R,)
    absolute element indices; returns (R, nwin) = flat[start : start+nwin]
    per row.

    A chunk row's pa indices are CONSECUTIVE (base..base+nblk), so instead of
    one row gather per pa this fetches the ceil(nwin/128)+1 covering lane
    rows per output row and barrel-shifts (7 masked shift stages —
    elementwise) to align each row's window — up to 64x fewer gather rows for the
    large classes.  The shift stages SHRINK: after consuming shift bit k the
    live window is only ``nwin + (remaining bits)`` lanes, so stage widths
    telescope nwin+127 → nwin — for small-nblk classes this is ~7x less
    elementwise traffic than full-width rotates (the covering fetch is 256 lanes even
    when nwin is 1)."""
    R = start.shape[0]
    r0 = start // 128
    off = start % 128
    nfr = (nwin + 127) // 128 + 1
    rows = r0[:, None] + jnp.arange(nfr, dtype=jnp.int32)[None, :]
    rows = jnp.clip(rows, 0, table128.shape[0] - 1)
    flat = jnp.take(table128, rows.reshape(-1), axis=0).reshape(R, nfr * 128)
    rem = 127  # sum of all shift bits
    for k in (64, 32, 16, 8, 4, 2, 1):  # shift-left by off, bit by bit
        rem -= k
        keep = min(nwin + rem, flat.shape[1] - k)
        src = flat[:, : keep + k]
        flat = jnp.where((off[:, None] & k) != 0, src[:, k:], src[:, :keep])
    return flat[:, :nwin]


# ---------------------------------------------------------------------------
# plan
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpgemmPlan:
    """Device-resident expansion layout.  pa = (A-nonzero, B-segment) pair."""

    #: folded (nsegB_pad*ws/128, 128) B table, ws lanes per segment
    #: ([cols | value bits | dead], see _fold_ws) — flat linear storage, so
    #: no layout pads it
    b2_packed: jax.Array
    #: tuple of 1-D (npa_pad,) channels: (b2row[, A-value bits...])
    pa_packed: tuple
    #: (nrow_pad, 2) [first pa, pa count] per row IN rows_sorted ORDER — the
    #: chunks dynamic_slice their row range instead of gathering per row
    rowmeta: jax.Array
    rows_sorted: jax.Array  #: (nrow_pad,) row ids ordered by class
    # host-side (static metadata)
    classes: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    class_counts: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    seg_w: int = dataclasses.field(metadata=dict(static=True))
    npa: int = dataclasses.field(metadata=dict(static=True))
    nrow: int = dataclasses.field(metadata=dict(static=True))
    #: the budget the plan's paddings were sized with — the plan-based
    #: execution path must reuse it (a larger budget would schedule chunks
    #: past rows_sorted's padding)
    slot_budget: int = dataclasses.field(metadata=dict(static=True))
    a_dtype: str = dataclasses.field(metadata=dict(static=True))
    b_dtype: str = dataclasses.field(metadata=dict(static=True))
    #: all values known to be 1.0 (the reference's forced-pattern semantics,
    #: serial_newblock_clock.cpp:84,96): value channels are omitted from the
    #: plan tables and partials are synthesized as 1 in the chunks
    pattern: bool = dataclasses.field(metadata=dict(static=True), default=False)
    #: B2 per-segment stride the plan was built with (chunks must match)
    b2_ws: int | None = dataclasses.field(metadata=dict(static=True), default=None)
    #: class-aligned pre-expanded partials (one FLAT (R_pad*L,) block per
    #: schedule entry; 1-D linear storage so no layout pads it): the
    #: numeric phase then runs ZERO gathers — just reshape, sort, merge.
    #: Empty tuple = not prebuilt (fetch runs inside the chunks).
    aligned_cols: tuple = ()
    #: value-mode companion blocks (empty in pattern mode or when not built)
    aligned_vals: tuple = ()
    #: accum dtype the aligned value blocks were materialized in
    aligned_accum: str | None = dataclasses.field(
        metadata=dict(static=True), default=None
    )


def _b2_build_body(
    b_indptr, b_ind, b_dat, bseg_off=None, *, W, nsegB_pad, pattern=False,
    b2_ws=None,
):
    """Aligned padded B table (one-time per B): pad rows to W multiples.

    Built by SCATTER (per-nonzero destination = position + pads inserted
    before it), not by per-slot gather: the scatter moves only nnz(B)
    elements, the gather nsegB*W.
    The per-position pad offset is a per-row step function: materialized as
    the cumsum of TELESCOPING deltas scattered at row starts (collisions at
    empty rows sum correctly), avoiding any per-nonzero row gathers.
    FOLDED storage (see _fold_ws): one flat int32 array, ws lanes per
    segment ([cols | value bits | dead]), reshaped to full (X, 128) rows —
    never a narrow (nsegB, w) physical table."""
    if bseg_off is None:
        lenB = b_indptr[1:] - b_indptr[:-1]
        nsegB_row = (lenB + W - 1) // W
        bseg_off = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(nsegB_row)]
        )
    nnzB_pad = b_ind.shape[0]
    posb = jnp.arange(nnzB_pad, dtype=jnp.int32)
    c_row = bseg_off[:-1] * W - b_indptr[:-1]  # (nrowB,) pad offset per row
    c_prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), c_row[:-1]])
    # rows sharing a start position (a run of empty rows + the next row) have
    # delta EXACTLY 0 except the run's leader (empty rows advance neither
    # bseg_off nor b_indptr, so c_row is constant across them): route the
    # zero-delta non-leaders to distinct dropped slots and the scatter's
    # indices become genuinely unique — the set form then applies
    iptr0 = b_indptr[:-1]
    iprev = jnp.concatenate([jnp.full((1,), -1, iptr0.dtype), iptr0[:-1]])
    leader = iptr0 != iprev
    rpos = jnp.arange(iptr0.shape[0], dtype=iptr0.dtype)
    dd = _scatter1d_set(
        jnp.zeros((nnzB_pad + 1,), jnp.int32),
        jnp.where(leader, iptr0, iptr0.dtype.type(nnzB_pad + 1) + rpos),
        c_row - c_prev,
        sorted_=False, unique=True,
    )
    dest = posb + jnp.cumsum(dd)[:nnzB_pad]
    # pad entries route to DISTINCT out-of-range slots (dropped): live dest
    # is strictly increasing and unique, so the scatter can claim
    # sorted+unique — 191 M/s vs the generic set's 131 (micro_scatter.py)
    dest = jnp.where(posb < b_indptr[-1], dest, nsegB_pad * W + posb)
    nvb = 0 if pattern else np.dtype(b_dat.dtype).itemsize // 4
    ws_b = b2_ws or _fold_ws(W if pattern else (1 + nvb) * W)
    seg = dest // W
    w_in = dest - seg * W
    flat = _scatter1d_set(
        jnp.full((nsegB_pad * ws_b,), _INT_MAX, jnp.int32),
        seg * ws_b + w_in, b_ind, sorted_=True, unique=True,
    )
    if not pattern:
        bits_b = jax.lax.bitcast_convert_type(b_dat, jnp.int32)
        if bits_b.ndim == 1:
            bits_b = bits_b[:, None]
        for i in range(nvb):
            # idx increases with dest (ws_b >= (1+nvb)*W), stays unique
            flat = _scatter1d_set(
                flat, seg * ws_b + W + w_in * nvb + i, bits_b[:, i],
                sorted_=True, unique=True,
            )
    return flat.reshape(-1, 128)


_b2_build = jax.jit(
    _b2_build_body,
    static_argnames=("W", "nsegB_pad", "pattern", "b2_ws"),
)


def _pre_build_body(
    a_ind, b_indptr, b_ind, b_dat, *, W, nsegB_pad, nnz, pattern=False,
    b2_ws=None,
):
    """Everything the plan can compute WITHOUT the host sizing pass: the B2
    table plus the per-A-nonzero expansion stage (brow gather, seg_off
    cumsum, rebase channel c_a) — only the npa-sized tables and the chunks
    need sizing's static shapes.

    MEASURED NEGATIVE RESULT (web-Google A x A, on the accelerator this was
    first built on): prelaunching this full stage ran ~10% SLOWER end to
    end than prelaunching just the B2 table (_b2_build) — the extra
    cross-program buffers (seg_off, c_a: 40 MB) cost more in materialization
    and program-boundary overhead than the overlap with host sizing buys.
    The fused path therefore prelaunches only _b2_build; this function is
    kept as the documented experiment and for plan-phase reuse."""
    lenB = b_indptr[1:] - b_indptr[:-1]
    nrowB = lenB.shape[0]
    nsegB_row = (lenB + W - 1) // W
    bseg_off = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(nsegB_row)])
    b2_packed = _b2_build_body(
        b_indptr, b_ind, b_dat, bseg_off,
        W=W, nsegB_pad=nsegB_pad, pattern=pattern, b2_ws=b2_ws,
    )
    nnz_pad = a_ind.shape[0]
    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    jj = jnp.clip(a_ind, 0, nrowB - 1)
    brow_tab = jnp.stack([nsegB_row, bseg_off[:-1]], axis=1)
    bg = jnp.take(brow_tab, jj, axis=0)  # (nnz_pad, 2)
    live_a = (pos < nnz) & (bg[:, 0] > 0)
    nseg_a = jnp.where(live_a, bg[:, 0], 0)
    seg_off = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(nseg_a)])
    c_a = jnp.where(live_a, bg[:, 1] - seg_off[:-1], 0)
    return b2_packed, seg_off, c_a


_pre_build = jax.jit(
    _pre_build_body,
    static_argnames=("W", "nsegB_pad", "nnz", "pattern", "b2_ws"),
)


def _plan_body(
    a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, order,
    *, W, npa_pad, nsegB_pad, nrow, nrow_pad, nnz, pattern=False, b2_ws=None,
    presorted=False, patch=None, b2_packed=None, classes_n=None, remap=None,
    pre=None,
):
    """``order``: per-row class ids (device sorts, ``presorted=False``), a
    host-precomputed ``rows_sorted`` of length ``nrow_pad``
    (``presorted=True``), or ``None`` with static ``classes_n`` — the class
    vector is then recomputed ON DEVICE from the pa bounds (``remap`` = the
    static small-class fold table).  The fused path uses the last mode: it
    needs no per-multiply host->device upload of an nrow/nnz-scale array;
    the device sort + classify that replace the upload are cheap.

    ``patch``: optional (dead_pos, dead_val) arrays enabling the set-scatter
    step function (see the step_fn comment); pattern mode only — its values
    correct the b2row channel, and value channels would need their own.
    Only worth it when the arrays are already resident (plan reuse), never
    for a per-multiply upload.  ``b2_packed``: a prebuilt B2 table
    (``_b2_build``).  ``pre``: the (b2_packed, seg_off, c_a) triple from a
    ``_pre_build`` dispatch — the fused host path launches it BEFORE the
    host sizing pass so its device time overlaps host work."""
    assert patch is None or pattern, "dead-run patch is pattern-mode only"
    nnz_pad = a_ind.shape[0]
    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    if pre is not None:
        b2_packed, seg_off, c_a = pre
        live_a = (seg_off[1:] - seg_off[:-1]) > 0
    else:
        lenB = b_indptr[1:] - b_indptr[:-1]
        nrowB = lenB.shape[0]
        nsegB_row = (lenB + W - 1) // W
        bseg_off = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(nsegB_row)]
        )
        if b2_packed is None:
            b2_packed = _b2_build_body(
                b_indptr, b_ind, b_dat, bseg_off,
                W=W, nsegB_pad=nsegB_pad, pattern=pattern, b2_ws=b2_ws,
            )

        # --- pa enumeration (kept A-nonzero x B-segment) ---------------------
        # pa_b2row is a ramp (+1 per pa) with per-a rebasing to bseg_off[j]:
        # a telescoping-delta cumsum (one nnz-sized scatter), and pa_aval
        # is a per-a step function of the A values — same trick on the value
        # BITS (int32 delta sums are exact mod 2^32, so the reconstruction is
        # bit-exact; float deltas would drift).  No npa-scale gathers anywhere.
        jj = jnp.clip(a_ind, 0, nrowB - 1)
        # one (nrowB, 2) table so the two per-B-row lookups ride ONE row gather
        # (gathers charge per row; two scalar gathers cost 2x this)
        brow_tab = jnp.stack([nsegB_row, bseg_off[:-1]], axis=1)
        bg = jnp.take(brow_tab, jj, axis=0)  # (nnz_pad, 2)
        live_a = (pos < nnz) & (bg[:, 0] > 0)
        nseg_a = jnp.where(live_a, bg[:, 0], 0)
        seg_off = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(nseg_a)])
        c_a = jnp.where(live_a, bg[:, 1] - seg_off[:-1], 0)
    pa_idx = jnp.arange(npa_pad, dtype=jnp.int32)
    pa_live = pa_idx < seg_off[-1]

    if patch is not None:
        # SET-scatter step function (~1.6x the add-scatter's rate,
        # benchmarks/micro_scatter.py).  Live entries have strictly
        # increasing seg_off (each owns >= 1 segment) so their writes are
        # unique; dead/pad entries are routed to the dump slot npa_pad
        # (cumsum[:npa_pad] never reads it).  A dead run's missing delta
        # (-chan[previous live]) is restored by the host-precomputed
        # ``patch`` adds — one entry per dead run, O(dead runs) << nnz.
        idx_live = jnp.where(live_a, seg_off[:-1], npa_pad)
        patch_pos, patch_val = patch

        def step_fn(chan):
            prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), chan[:-1]])
            d = jnp.zeros((npa_pad + 1,), jnp.int32).at[idx_live].set(
                chan - prev, mode="drop"
            )
            d = d.at[patch_pos].add(patch_val, mode="drop")
            return jnp.cumsum(d)[:npa_pad]

    else:
        # UNIQUE-index SET-scatter step function, no host patch needed (2x
        # the add-scatter's rate, micro_scatter.py).  The step array is
        # interleaved 2x: live entry q writes its delta (chan[q] - chan[q-1])
        # at EVEN slot 2*seg_off[q]; the missing correction for each dead run
        # (-chan[last live], available as ``prev`` at the run's FIRST dead
        # entry via the shift) goes to ODD slot 2*seg_off[t0] + 1 — the dead
        # entries of a run share the NEXT live's seg_off, so the pairwise sum
        # d2[2i] + d2[2i+1] folds the correction into exactly the slot where
        # it must take effect.  Remaining dead/pad entries route to DISTINCT
        # out-of-range slots (dropped), so every index is genuinely unique.
        # The pairsum runs as a lane-strided add on the (X, 128) view; a
        # stride-2 slice of the cumsum (XLA lowers that as a gather) and a
        # stride-2 reduce_window were an order of magnitude slower on the
        # first target.
        prev_live = jnp.concatenate([jnp.zeros((1,), jnp.bool_), live_a[:-1]])
        run_start = (~live_a) & prev_live
        seg0 = seg_off[:-1]
        n2 = 2 * npa_pad  # divisible by 128 (npa_pad rounds to 1024)
        idx2 = jnp.where(
            live_a, 2 * seg0, jnp.where(run_start, 2 * seg0 + 1, n2 + pos)
        )

        def step_fn(chan):
            prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), chan[:-1]])
            val = jnp.where(
                live_a, chan - prev, jnp.where(run_start, -prev, 0)
            )
            d2 = _scatter1d_set(
                jnp.zeros((n2,), jnp.int32), idx2, val,
                sorted_=False, unique=True,
            )
            r = d2.reshape(-1, 128)
            pair = r[:, ::2] + r[:, 1::2]
            return jnp.cumsum(pair.reshape(-1))

    pa_b2row = jnp.where(pa_live, step_fn(c_a) + pa_idx, nsegB_pad - 1)
    if pattern:
        # A values are all 1.0 — no value channels, no per-channel step scatter
        pa_packed = (pa_b2row,)
    else:
        bits = jax.lax.bitcast_convert_type(a_dat, jnp.int32)
        if bits.ndim == 1:  # fp32: one int32 channel; fp64: two
            bits = bits[:, None]
        nv = bits.shape[1]
        v_a = jnp.where(live_a[:, None], bits, 0)
        # channels stay SEPARATE 1-D linear arrays (a stacked (npa, 1+nv)
        # table would tile-pad 64x, see _fold_ws); chunks fold each to
        # (npa_pad//128, 128) for free and lane-pick
        pa_packed = (pa_b2row,) + tuple(
            jnp.where(pa_live, step_fn(v_a[:, i]), 0) for i in range(nv)
        )

    # ONE (nrow+1,) gather of the row bounds; base and count derive by shift
    # (int32 pinned: under enable_x64 the cumsum behind seg_off promotes,
    # and the rowmeta consumer slices a fixed-int32 (nrow_pad, 2) array)
    bounds = jnp.take(seg_off, a_indptr).astype(jnp.int32)
    pa_row_base = bounds[:-1]
    npa_row = bounds[1:] - bounds[:-1]

    if order is None:
        # device-side class vector (mirrors _sizing's host rule exactly —
        # test_spgemm_slab checks host/device sizing agreement)
        classes_arr = jnp.asarray(np.asarray(classes_n, np.int32))
        exp_pad_row = W * npa_row
        cls_dev = jnp.searchsorted(classes_arr, exp_pad_row, side="left").astype(
            jnp.int32
        )
        cls_dev = jnp.where(exp_pad_row == 0, len(classes_n) + 1, cls_dev)
        if remap is not None:
            cls_dev = jnp.take(jnp.asarray(np.asarray(remap, np.int32)), cls_dev)
        order = cls_dev

    if presorted:
        rows_sorted = order  # host counting-argsort, already nrow_pad long
        # pre-permute (base, count) into class order: ONE nrow_pad row gather
        # replaces two scalar gathers per chunk row downstream
        meta = jnp.stack([pa_row_base, npa_row], axis=1)
        rowmeta = jnp.take(meta, rows_sorted, axis=0)
    else:
        # (base, count) ride the class sort as extra payload operands
        # instead of a random (nrow_pad, 2) re-gather after it, which cost
        # ~20x more on the first target (its 2-wide table padded to 128
        # lanes)
        rows = jnp.arange(nrow, dtype=jnp.int32)
        _, rs, base_s, cnt_s = jax.lax.sort(
            (order, rows, pa_row_base, npa_row), num_keys=1, is_stable=True
        )
        rows_sorted = jnp.concatenate([rs, jnp.zeros((nrow_pad - nrow,), jnp.int32)])
        pad2 = jnp.zeros((nrow_pad - nrow, 2), jnp.int32)
        rowmeta = jnp.concatenate(
            [jnp.stack([base_s, cnt_s], axis=1), pad2], axis=0
        )
    return b2_packed, pa_packed, rowmeta, rows_sorted


class _ExpansionTooLarge(ValueError):
    """Padded expansion exceeds the single-program device budget.
    ``spgemm_slab`` catches this and reroutes through the uniform-piece path
    (``spgemm_slab_big``); from the lower-level entry points
    (``spgemm_slab_csr`` / ``spgemm_slab_device`` / ``spgemm_plan``) it
    propagates as a ValueError with this remedy in the message."""

    def __str__(self):
        return (
            f"padded expansion {self.args[0]} slots exceeds the per-program "
            f"budget ({_MAX_EXP_PAD}); use spgemm_slab() (it pieces the "
            "product through spgemm_slab_big) or shard A first"
        )


@functools.partial(jax.jit, static_argnames=("W",))
def _sizing_dev_body(a_indptr, a_ind, b_indptr, classes_arr, nnz, *, W):
    """Device mirror of the host sizing pass — O(nnz+nrow) segment ops."""
    nclasses = classes_arr.shape[0]
    lenB = b_indptr[1:] - b_indptr[:-1]
    nrowB = lenB.shape[0]
    nsegB_row = (lenB + (W - 1)) // W
    nsegB = jnp.sum(nsegB_row)
    nnz_pad = a_ind.shape[0]
    pos = jnp.arange(nnz_pad, dtype=jnp.int32)
    jj = jnp.clip(a_ind, 0, nrowB - 1)
    nseg_a = jnp.where(pos < nnz, jnp.take(nsegB_row, jj), 0)
    seg_c = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(nseg_a)])
    npa = seg_c[-1]
    # float accumulation detects int32 overflow before the budget check
    npa_f = jnp.sum(nseg_a.astype(jnp.float32))
    iptr = jnp.clip(a_indptr, 0, nnz_pad)
    exp_pad_row = W * (jnp.take(seg_c, iptr[1:]) - jnp.take(seg_c, iptr[:-1]))
    # == host rule: class index = #{c : c < exp_pad_row}; empty rows sentinel
    cls = jnp.searchsorted(classes_arr, exp_pad_row, side="left").astype(jnp.int32)
    cls = jnp.where(exp_pad_row == 0, nclasses + 1, cls)
    counts = jnp.zeros((nclasses + 2,), jnp.int32).at[cls].add(1)
    return npa, npa_f, nsegB, cls, counts


def _sizing_device(A: CSR, B: CSR, W: int, classes):
    """Sizing for DEVICE-resident operands: no nnz-scale D2H — the per-row
    class vector stays on device and only (npa, nsegB, counts) scalars are
    pulled (~35 ints).  This is what makes ``spgemm_slab_csr(C, X)`` on a
    chained device CSR free of host round-trips."""
    npa, npa_f, nsegB, cls, counts = _sizing_dev_body(
        jnp.asarray(A.indptr, jnp.int32),
        jnp.asarray(A.indices, jnp.int32),
        jnp.asarray(B.indptr, jnp.int32),
        jnp.asarray(np.asarray(classes, np.int32)),
        jnp.int32(A.nnz),
        W=W,
    )
    if float(npa_f) * W >= _MAX_EXP_PAD:
        raise _ExpansionTooLarge(int(float(npa_f) * W))
    counts = np.asarray(counts).astype(np.int64)
    remap = np.arange(len(classes) + 2, dtype=np.int32)
    for ci in range(len(classes) - 1):
        if 0 < counts[ci] < FOLD_THRESHOLD:
            counts[ci + 1] += counts[ci]
            counts[ci] = 0
            remap[remap == ci] = ci + 1
    if not np.array_equal(remap, np.arange(len(classes) + 2, dtype=np.int32)):
        cls = jnp.take(jnp.asarray(remap), cls)
    return Sizing(
        npa=int(npa),
        nsegB=int(nsegB),
        cls=cls,
        counts=tuple(int(c) for c in counts[: len(classes) + 1]),
    )


@dataclasses.dataclass
class Sizing:
    """Host-side sizing result.  Iterates as the legacy 4-tuple
    (npa, nsegB, cls, counts).  Host-path extras feed the fused plan:
    ``patch`` — the dead-run scatter corrections that let the plan use
    unique-index set-scatters (pattern mode; see _plan_body) — and
    ``rows_sorted`` — the class permutation as a native counting argsort,
    saving the device-side stable sort."""

    npa: int
    nsegB: int
    cls: object  # (nrow,) per-row class — numpy (host path) or jax.Array
    counts: tuple
    patch: tuple | None = None  # (pos, val) int32 numpy arrays
    rows_sorted: np.ndarray | None = None  # (nrow,) int32, class-stable order
    #: small-class fold table (raw class -> folded class), or None if no
    #: folds happened; the device-side classifier replays it
    remap: tuple | None = None

    def __iter__(self):
        return iter((self.npa, self.nsegB, self.cls, self.counts))


def _sizing(A: CSR, B: CSR, W: int, classes) -> Sizing:
    """O(nnz+nrow) sizing: (npa, nsegB, per-row class, counts) plus the
    host-path extras (dead-run patch, presorted class permutation).  Native
    C++ single pass when available; vectorized numpy fallback.
    Device-resident operands route to :func:`_sizing_device` (no nnz-scale
    D2H; no extras)."""
    if not isinstance(A.data, np.ndarray) or not isinstance(B.data, np.ndarray):
        return _sizing_device(A, B, W, classes)
    Ah, Bh = A.host(), B.host()
    res = None
    try:
        from spmm_tpu import native

        res = native.spgemm_sizing_patch(
            np.asarray(Ah.indptr), np.asarray(Ah.indices[: A.nnz]),
            np.asarray(Bh.indptr), W, np.asarray(classes, np.int64),
        )
    except Exception:
        res = None
    if res is not None:
        npa, nsegB, cls, patch_pos, patch_val = res
    else:
        b_iptr = np.asarray(Bh.indptr, dtype=np.int64)
        lenB = b_iptr[1:] - b_iptr[:-1]
        nsegB = int(((lenB + W - 1) // W).sum())
        a_ind = np.asarray(Ah.indices, dtype=np.int64)[: A.nnz]
        lenB_a = lenB[a_ind]
        live = lenB_a > 0
        nseg_a = np.where(live, (lenB_a + W - 1) // W, 0)
        npa = int(nseg_a.sum())
        segc = np.zeros(A.nnz + 1, dtype=np.int64)
        np.cumsum(nseg_a, out=segc[1:])
        indptr = np.asarray(Ah.indptr, dtype=np.int64)
        exp_pad_row = W * (
            segc[np.minimum(indptr[1:], A.nnz)] - segc[np.minimum(indptr[:-1], A.nnz)]
        )
        cls = np.zeros(A.nrow, dtype=np.int32)
        for c in classes:
            cls += (exp_pad_row > c).astype(np.int32)
        cls[exp_pad_row == 0] = len(classes) + 1
        # dead-run patch (numpy mirror of the native pass): chan = the step
        # channel the device scatters; one correction per live->dead edge
        bseg_off = np.zeros(len(lenB), dtype=np.int64)
        np.cumsum((lenB[:-1] + W - 1) // W, out=bseg_off[1:])
        chan = np.where(live, bseg_off[a_ind] - segc[:-1], 0)
        chan_prev = np.concatenate([np.zeros(1, np.int64), chan[:-1]])
        edge = (~live) & (chan_prev != 0)
        patch_pos = segc[:-1][edge].astype(np.int32)
        patch_val = (-chan_prev[edge]).astype(np.int32)
    if npa * W >= _MAX_EXP_PAD:
        raise _ExpansionTooLarge(npa * W)
    # fold small classes into the next one up: a tiny chunk costs a whole
    # dispatch; the padding increase is bounded by count * L_next
    counts = np.bincount(cls, minlength=len(classes) + 2)
    remap = np.arange(len(classes) + 2, dtype=np.int32)
    for ci in range(len(classes) - 1):
        if 0 < counts[ci] < FOLD_THRESHOLD:
            cls[cls == ci] = ci + 1
            counts[ci + 1] += counts[ci]
            counts[ci] = 0
            remap[remap == ci] = ci + 1
    folded = not np.array_equal(remap, np.arange(len(classes) + 2, dtype=np.int32))
    try:
        from spmm_tpu import native

        rows_sorted = native.counting_argsort_i32(cls, len(classes) + 2)
    except Exception:
        rows_sorted = None
    if rows_sorted is None:
        rows_sorted = np.argsort(cls, kind="stable").astype(np.int32)
    return Sizing(
        npa=npa,
        nsegB=nsegB,
        cls=cls,
        counts=tuple(int(c) for c in counts[: len(classes) + 1]),
        patch=(patch_pos, patch_val),
        rows_sorted=rows_sorted,
        remap=tuple(int(x) for x in remap) if folded else None,
    )


#: dead-run patch arrays are padded to this granule so patch counts that
#: drift between runs reuse the compiled program (pad entries add 0 at the
#: dump slot npa_pad)
_PATCH_GRANULE = 1 << 14


def _plan_order_args(sizing: Sizing, nrow_pad: int, npa_pad: int, pattern: bool):
    """(order, presorted, patch) plan arguments from a Sizing: host sizings
    carry a precomputed class permutation (skip the device sort) and — in
    pattern mode — the dead-run patch enabling set-scatters."""
    if sizing.rows_sorted is not None:
        rs = np.zeros(nrow_pad, np.int32)
        rs[: len(sizing.rows_sorted)] = sizing.rows_sorted
        order = jnp.asarray(rs)
        presorted = True
    else:
        order = jnp.asarray(sizing.cls)
        presorted = False
    patch = None
    if pattern and sizing.patch is not None:
        pos, val = sizing.patch
        k = _round_up(len(pos), _PATCH_GRANULE)
        pp = np.full(k, npa_pad, np.int32)
        pv = np.zeros(k, np.int32)
        pp[: len(pos)] = pos
        pv[: len(val)] = val
        patch = (jnp.asarray(pp), jnp.asarray(pv))
    return order, presorted, patch


def spgemm_plan(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    A_dev: CSR | None = None,
    B_dev: CSR | None = None,
    pattern: bool | None = None,
    upload_order: bool = False,
    expand: bool = True,
    accum_dtype=jnp.float32,
    sizing=None,
) -> SpgemmPlan:
    """Build the expansion layout.  Host side is O(nnz+nrow) (sizing + class
    counts, native C++ when available); all O(E) work stays on device.
    ``pattern=None`` auto-detects all-ones values (value channels omitted).

    ``upload_order=False`` (default) recomputes the class vector and its
    stable sort ON DEVICE (order=None + classes_n/remap, same as the fused
    path), so the plan program consumes no freshly uploaded nrow/nnz-scale
    host array.  ``True`` ships the host sizing's precomputed permutation +
    dead-run patch instead; which is faster on a GPU is not measured.

    ``expand=True`` (default) additionally pre-expands every chunk's
    partials into the class-aligned cache (``aligned_cols``/``aligned_vals``,
    built with ``accum_dtype`` value blocks): the numeric phase then runs
    ZERO gathers — the one-time cost is the same windowed fetch the first
    multiply would have paid anyway, plus ~4 B/slot of device memory."""
    W = seg_w
    # padded expansions are multiples of W, so class bounds must be too
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)
    A_dev, B_dev = (A_dev or A), (B_dev or B)
    if sizing is None:
        sizing = _sizing(A, B, W, classes)
    npa, nsegB, cls, counts = sizing

    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    nrow_pad = A.nrow + max_chunk
    npa_pad = _round_up(npa, 1024)
    nsegB_pad = _nseg_pad(nsegB)
    b2_ws = _pick_b2_ws(W, pattern, np.dtype(B_dev.data.dtype), nsegB_pad)
    device_cls = sizing.rows_sorted is None  # device sizing: cls is resident
    if upload_order or device_cls:
        order, presorted, patch = _plan_order_args(sizing, nrow_pad, npa_pad, pattern)
        classes_n = remap = None
    else:
        order, presorted, patch = None, False, None
        classes_n, remap = classes, sizing.remap
    a_dt = str(np.dtype(A.data.dtype))
    b_dt = str(np.dtype(B.data.dtype))
    dev_args = (
        jnp.asarray(A_dev.indptr, jnp.int32),
        jnp.asarray(A_dev.indices, jnp.int32),
        jnp.asarray(A_dev.data),
        jnp.asarray(B_dev.indptr, jnp.int32),
        jnp.asarray(B_dev.indices, jnp.int32),
        jnp.asarray(B_dev.data),
        order,
    )
    plan_kw = dict(
        W=W, npa_pad=npa_pad, nsegB_pad=nsegB_pad, nrow=A.nrow,
        nrow_pad=nrow_pad, nnz=A.nnz, pattern=pattern, b2_ws=b2_ws,
        presorted=presorted, classes_n=classes_n, remap=remap,
    )
    aligned_cols, aligned_vals, aligned_accum = (), (), None
    if expand and patch is None:
        # plan + aligned expansion as ONE program / ONE dispatch
        sched, _ = _chunk_schedule(classes, counts, slot_budget)
        (b2_packed, pa_packed, rowmeta, rows_sorted, aligned_cols,
         aligned_vals) = _plan_aligned_device(
            *dev_args, schedule=tuple(sched), a_dtype=a_dt, b_dtype=b_dt,
            accum_dtype=accum_dtype, **plan_kw,
        )
        aligned_accum = str(jnp.dtype(accum_dtype).name)
    else:
        (b2_packed, pa_packed, rowmeta, rows_sorted) = _plan_device(
            *dev_args, patch=patch, **plan_kw,
        )
        if expand:
            sched, _ = _chunk_schedule(classes, counts, slot_budget)
            aligned_cols, aligned_vals = _build_aligned(
                b2_packed, pa_packed, rowmeta,
                schedule=tuple(sched), W=W, a_dtype=a_dt, b_dtype=b_dt,
                accum_dtype=accum_dtype, pattern=pattern, b2_ws=b2_ws,
            )
            aligned_accum = str(jnp.dtype(accum_dtype).name)
    plan = SpgemmPlan(
        b2_packed=b2_packed,
        pa_packed=pa_packed,
        rowmeta=rowmeta,
        rows_sorted=rows_sorted,
        classes=classes,
        class_counts=counts,
        seg_w=W,
        npa=npa,
        nrow=A.nrow,
        slot_budget=slot_budget,
        a_dtype=a_dt,
        b_dtype=b_dt,
        pattern=pattern,
        b2_ws=b2_ws,
        aligned_cols=aligned_cols,
        aligned_vals=aligned_vals,
        aligned_accum=aligned_accum,
    )
    # structure-only sizing rides along (NOT a pytree field: invisible to
    # jit, lost across tree flattening) so spgemm_plan_revalue can skip the
    # O(nnz) host pass when only operand VALUES change
    object.__setattr__(plan, "_sizing_cache", (A.nnz, B.nnz, sizing))
    return plan


def spgemm_plan_revalue(
    plan: SpgemmPlan,
    A: CSR,
    B: CSR,
    *,
    A_dev: CSR | None = None,
    B_dev: CSR | None = None,
    pattern: bool | None = None,
    accum_dtype=None,
) -> SpgemmPlan:
    """New plan for NEW VALUES on the SAME sparsity structure — the
    cuSPARSE-spgemm-reuse analog of the reference's preprocess-once /
    multiply-many premise (SURVEY.md §0): iterative workloads re-multiply
    the same structure with updated weights every step.

    The O(nnz) host sizing pass is structure-only, so it is reused from
    ``plan``; everything value-dependent (B2 value bits, pa value channels,
    the aligned value blocks) rebuilds through the SAME already-compiled
    one-dispatch plan program.  The caller guarantees A/B carry exactly the
    sparsity structure ``plan`` was built from (indptr/indices
    element-for-element — only nrow/nnz are validated here, like cuSPARSE's
    reuse contract).  Plans that lost their sizing cache (round-tripped
    through tree flattening/serialization) fall back to a full re-sizing."""
    cache = getattr(plan, "_sizing_cache", None)
    sizing = None
    if cache is not None:
        a_nnz, b_nnz, sizing = cache
        if a_nnz != A.nnz or b_nnz != B.nnz or A.nrow != plan.nrow:
            raise ValueError(
                "operand structure differs from the plan's: "
                f"nnz {A.nnz}/{B.nnz} vs plan {a_nnz}/{b_nnz}, "
                f"nrow {A.nrow} vs {plan.nrow}"
            )
    if accum_dtype is None:
        accum_dtype = jnp.dtype(plan.aligned_accum or "float32")
    return spgemm_plan(
        A,
        B,
        classes=plan.classes,
        seg_w=plan.seg_w,
        slot_budget=plan.slot_budget,
        A_dev=A_dev,
        B_dev=B_dev,
        pattern=pattern,
        expand=bool(plan.aligned_cols),
        accum_dtype=accum_dtype,
        sizing=sizing,
    )


# ---------------------------------------------------------------------------
# numeric per class chunk
# ---------------------------------------------------------------------------


def _chunk_meta(rowmeta, start, count, R_pad: int, nblk: int):
    """(base, nb, bm) for one chunk's contiguous row range: rowmeta slice +
    the in-chunk row mask and foreign/pad block mask.  Shared by the direct
    chunk path, the aligned-cache builder, and the distributed plan builder —
    the masking rule must never diverge between them."""
    ii = jnp.arange(R_pad, dtype=jnp.int32)
    in_chunk = ii < count
    mm = jax.lax.dynamic_slice(
        rowmeta, (start, jnp.zeros((), start.dtype)), (R_pad, 2)
    )
    base = jnp.where(in_chunk, mm[:, 0], 0)
    nb = jnp.where(in_chunk, mm[:, 1], 0)
    bi = jax.lax.broadcasted_iota(jnp.int32, (R_pad, nblk), 1)
    bm = bi < nb[:, None]
    return base, nb, bm


def _chunk_body(
    b2_packed,  # (nsegB_pad, (1+nvb)*W): [cols | B value bits]
    pa_packed,  # (npa_pad, 1+nva): [b2row | A value bits]
    rows_sorted,
    rowmeta,  # (nrow_pad, 2) [first pa, pa count] in rows_sorted order
    start,  # scalar: offset into rows_sorted of this chunk
    count,  # scalar: valid rows in this chunk
    *,
    L: int,
    R_pad: int,
    W: int,
    a_dtype: str = "float32",
    b_dtype: str = "float32",
    accum_dtype=jnp.float32,
    pattern: bool = False,
    b2_ws: int | None = None,
):
    """One (R_pad, L) slab chunk: gather each row's padded partials from the
    FOLDED tables (pa channels and B2 are flat linear arrays viewed as
    (X, 128) full-lane rows — see _fold_ws; gather whole rows, one-hot-pick
    the lane/segment), batched sort by column, scatter-free duplicate merge.
    In ``pattern`` mode every partial's value is 1 (synthesized from column
    validity — no value channels).  Returns (rows, cols_u, vals_u, nuniq)."""
    nblk = L // W
    r = jax.lax.dynamic_slice(rows_sorted, (start,), (R_pad,))
    # (base, count) pre-permuted into class order by the plan: contiguous
    # slices here, no per-row gathers
    base, nb, bm = _chunk_meta(rowmeta, start, count, R_pad, nblk)

    col, val = _chunk_fetch(
        b2_packed, pa_packed, base, nb, bm,
        L=L, R_pad=R_pad, W=W, a_dtype=a_dtype, b_dtype=b_dtype,
        accum_dtype=accum_dtype, pattern=pattern, b2_ws=b2_ws,
    )
    return (r,) + _merge_block(
        col, val, L=L, R_pad=R_pad, accum_dtype=accum_dtype, pattern=pattern
    )


def _chunk_fetch(
    b2_packed, pa_packed, base, nb, bm,
    *, L, R_pad, W, a_dtype, b_dtype, accum_dtype, pattern, b2_ws,
):
    """The gather half of a chunk: windowed pa fetch + B2 segment pick.
    Returns (col, val): (R_pad*L,)-flat sentinel-masked columns and — value
    mode only — the per-partial values (pattern mode returns val=None; run
    sums are recovered from positions downstream).  Split out so the plan
    can PRE-EXPAND these into the class-aligned cache (`_build_aligned`)
    and the warm numeric phase can skip every gather."""
    nblk = L // W
    npa_pad = pa_packed[0].shape[0]
    nvb = 0 if pattern else np.dtype(b_dtype).itemsize // 4
    nva = len(pa_packed) - 1
    ws_b = b2_ws or _fold_ws(W if pattern else (1 + nvb) * W)
    Gb = 128 // ws_b

    # each row's pa indices are consecutive: windowed fetch, not per-pa gather
    base = jnp.clip(base, 0, npa_pad - 1)
    b2r = _extract_window(pa_packed[0].reshape(-1, 128), base, nblk).reshape(-1)
    # blocks belonging to other rows / padding route to the LAST segment,
    # which lies in the table's never-written pad region (nsegB < nsegB_pad)
    # and is therefore all-_INT_MAX: the gather itself masks them, deleting
    # a (slots, W)-wide select downstream (the clip also covers window
    # overrun rows)
    last_seg = b2_packed.shape[0] * Gb - 1
    b2r = jnp.where(bm.reshape(-1), jnp.clip(b2r, 0, last_seg), last_seg)
    if Gb == 1:  # widened table: one segment per 128-lane row, no pick
        g = jnp.take(b2_packed, b2r, axis=0)
    else:
        g = _pick_group(jnp.take(b2_packed, b2r // Gb, axis=0), b2r % Gb, ws_b)
    col = g[:, :W]
    if pattern:
        # every partial's value is 1 (the reference's forced-pattern
        # semantics): no value array is materialized at all — run sums are
        # recovered from POSITIONS after the sorts (a run of c equal columns
        # contributes value c); sentinel routing above already masked
        # foreign/pad blocks
        return col.reshape(R_pad, L), None
    avbits = jnp.stack(
        [
            _extract_window(ch.reshape(-1, 128), base, nblk).reshape(-1)
            for ch in pa_packed[1:]
        ],
        axis=1,
    )
    aval = jax.lax.bitcast_convert_type(
        avbits if nva > 1 else avbits[:, 0], jnp.dtype(a_dtype)
    )
    S = g.shape[0]
    vbits = g[:, W : W + W * nvb]
    val = jax.lax.bitcast_convert_type(
        vbits.reshape(S, W, nvb) if nvb > 1 else vbits, jnp.dtype(b_dtype)
    ).astype(accum_dtype)
    val = val * aval[:, None].astype(accum_dtype)
    valid = bm.reshape(-1)[:, None] & (col != _INT_MAX)  # other rows / B2 row tail
    col = jnp.where(valid, col, _INT_MAX).reshape(R_pad, L)
    val = jnp.where(valid, val, 0).reshape(R_pad, L)
    return col, val


def _merge_block(col, val, *, L, R_pad, accum_dtype, pattern):
    """The sort/merge half of a chunk: (R_pad, L) sentinel-masked columns
    (+ values in value mode) -> (cols_u, vals_u, nuniq) with duplicate
    columns merged scatter-free."""
    if pattern:
        (col_s,) = jax.lax.sort((col,), dimension=1, num_keys=1)
        p = jax.lax.broadcasted_iota(jnp.int32, (R_pad, L), 1)
        firsts = (p == 0) | (col_s != _shift_right(col_s))
        lasts = jnp.concatenate([firsts[:, 1:], jnp.ones((R_pad, 1), bool)], axis=1)
        out_key = jnp.where(lasts & (col_s != _INT_MAX), p, _INT_MAX)
        outk_s, cols_u = jax.lax.sort((out_key, col_s), dimension=1, num_keys=1)
        # run length = this run's last position minus the previous run's
        # (positions of pad slots are INT_MAX: garbage there, masked by nuniq)
        prevk = _shift_right(outk_s)
        vals_u = jnp.where(p == 0, outk_s + 1, outk_s - prevk).astype(accum_dtype)
        nuniq = jnp.sum(lasts & (col_s != _INT_MAX), axis=1).astype(jnp.int32)
        return cols_u, vals_u, nuniq

    # batched per-row sort by column (pads sort to the end)
    col_s, val_s = jax.lax.sort((col, val), dimension=1, num_keys=1)

    # merge adjacent duplicates: compact run-ENDS carrying the inclusive
    # prefix sum; each run's sum = difference of consecutive compacted sums
    p = jax.lax.broadcasted_iota(jnp.int32, (R_pad, L), 1)
    firsts = (p == 0) | (col_s != _shift_right(col_s))
    lasts = jnp.concatenate([firsts[:, 1:], jnp.ones((R_pad, 1), bool)], axis=1)
    csum = jnp.cumsum(val_s, axis=1)
    out_key = jnp.where(lasts & (col_s != _INT_MAX), p, _INT_MAX)
    _, cols_u, csum_u = jax.lax.sort((out_key, col_s, csum), dimension=1, num_keys=1)
    prev = jnp.concatenate([jnp.zeros((R_pad, 1), csum_u.dtype), csum_u[:, :-1]], axis=1)
    vals_u = csum_u - prev
    nuniq = jnp.sum(lasts & (col_s != _INT_MAX), axis=1).astype(jnp.int32)
    return cols_u, vals_u, nuniq


def _build_aligned_body(
    b2_packed, pa_packed, rowmeta,
    *, schedule, W, a_dtype, b_dtype, accum_dtype, pattern, b2_ws,
):
    """Pre-expand every chunk's partials into class-aligned FLAT blocks (the
    gather half of each chunk, run once at plan time).  The expansion depends
    only on the operand STRUCTURES (+ the values the plan already bakes), so
    it is exactly as reusable as the plan itself — and the warm numeric
    phase then contains zero gathers."""
    cols_t, vals_t = [], []
    for (L, R_pad, start, cnt) in schedule:
        nblk = L // W
        base, nb, bm = _chunk_meta(
            rowmeta, jnp.int32(start), jnp.int32(cnt), R_pad, nblk
        )
        col, val = _chunk_fetch(
            b2_packed, pa_packed, base, nb, bm,
            L=L, R_pad=R_pad, W=W, a_dtype=a_dtype, b_dtype=b_dtype,
            accum_dtype=accum_dtype, pattern=pattern, b2_ws=b2_ws,
        )
        cols_t.append(col.reshape(-1))
        if val is not None:
            vals_t.append(val.reshape(-1))
    return tuple(cols_t), tuple(vals_t)


_build_aligned = jax.jit(
    _build_aligned_body,
    static_argnames=(
        "schedule", "W", "a_dtype", "b_dtype", "accum_dtype", "pattern", "b2_ws",
    ),
)


def _plan_aligned_body(
    a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, order,
    *, schedule, a_dtype, b_dtype, accum_dtype, W, npa_pad, nsegB_pad, nrow,
    nrow_pad, nnz, pattern, b2_ws, presorted, classes_n, remap,
):
    """Plan + class-aligned expansion in ONE compiled program (one remote
    compile, one dispatch — vs two of each for _plan_device then
    _build_aligned)."""
    (b2_packed, pa_packed, rowmeta, rows_sorted) = _plan_body(
        a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, order,
        W=W, npa_pad=npa_pad, nsegB_pad=nsegB_pad, nrow=nrow,
        nrow_pad=nrow_pad, nnz=nnz, pattern=pattern, b2_ws=b2_ws,
        presorted=presorted, classes_n=classes_n, remap=remap,
    )
    cols_t, vals_t = _build_aligned_body(
        b2_packed, pa_packed, rowmeta,
        schedule=schedule, W=W, a_dtype=a_dtype, b_dtype=b_dtype,
        accum_dtype=accum_dtype, pattern=pattern, b2_ws=b2_ws,
    )
    return b2_packed, pa_packed, rowmeta, rows_sorted, cols_t, vals_t


_plan_aligned_device = jax.jit(
    _plan_aligned_body,
    static_argnames=(
        "schedule", "a_dtype", "b_dtype", "accum_dtype", "W", "npa_pad",
        "nsegB_pad", "nrow", "nrow_pad", "nnz", "pattern", "b2_ws",
        "presorted", "classes_n", "remap",
    ),
)


def _fused_numeric_aligned_body(
    aligned_cols, aligned_vals, rows_sorted, *, schedule, accum_dtype, pattern,
):
    """Numeric phase over the pre-expanded class-aligned cache: reshape each
    flat block to its (R_pad, L) slab, batched-sort, merge — no gathers at
    all; one compiled program."""
    outs = []
    for i, (L, R_pad, start, cnt) in enumerate(schedule):
        r = jax.lax.dynamic_slice(rows_sorted, (jnp.int32(start),), (R_pad,))
        col = aligned_cols[i].reshape(R_pad, L)
        val = aligned_vals[i].reshape(R_pad, L) if not pattern else None
        outs.append(
            (r,)
            + _merge_block(
                col, val, L=L, R_pad=R_pad, accum_dtype=accum_dtype,
                pattern=pattern,
            )
        )
    return tuple(outs)


_fused_numeric_aligned = jax.jit(
    _fused_numeric_aligned_body,
    static_argnames=("schedule", "accum_dtype", "pattern"),
)


def _fused_numeric_aligned_csr_body(
    aligned_cols, aligned_vals, rows_sorted,
    *, schedule, accum_dtype, pattern, nrow, nnz_pad,
):
    """Aligned numeric phase + in-program CSR compaction: ONE dispatch from
    plan to device-resident (data, indices, indptr, nnz).  The auto-reuse
    path in spgemm_slab rides this (tail-free plans only)."""
    outs = _fused_numeric_aligned_body(
        aligned_cols, aligned_vals, rows_sorted,
        schedule=schedule, accum_dtype=accum_dtype, pattern=pattern,
    )
    return _compact_to_csr(
        tuple(o[0] for o in outs),
        tuple(o[1] for o in outs),
        tuple(o[2] for o in outs),
        tuple(o[3] for o in outs),
        nrow=nrow,
        nnz_pad=nnz_pad,
    )


_fused_numeric_aligned_csr = jax.jit(
    _fused_numeric_aligned_csr_body,
    static_argnames=("schedule", "accum_dtype", "pattern", "nrow", "nnz_pad"),
)


def _fused_numeric_body(
    b2_packed, pa_packed, rows_sorted, rowmeta,
    *, schedule, W, a_dtype, b_dtype, accum_dtype, pattern, b2_ws,
):
    """Every class chunk of a prebuilt plan in ONE compiled program — the
    numeric phase of the two-phase (symbolic/numeric) SpGEMM API.  Re-running
    a plan skips the host sizing pass AND the plan's B2/pa scatter passes:
    only the windowed fetches, batched sorts, and merges execute (~half the
    cold device time at web-Google scale).  Plans carrying the class-aligned
    cache route to :func:`_fused_numeric_aligned` instead (zero gathers)."""
    return tuple(
        _chunk_body(
            b2_packed, pa_packed, rows_sorted, rowmeta,
            jnp.int32(start), jnp.int32(cnt), L=L, R_pad=R_pad, W=W,
            a_dtype=a_dtype, b_dtype=b_dtype, accum_dtype=accum_dtype,
            pattern=pattern, b2_ws=b2_ws,
        )
        for (L, R_pad, start, cnt) in schedule
    )


_fused_numeric = jax.jit(
    _fused_numeric_body,
    static_argnames=(
        "schedule", "W", "a_dtype", "b_dtype", "accum_dtype", "pattern", "b2_ws",
    ),
)


# jitted single-phase entry points (tests / incremental use)
_plan_device = jax.jit(
    _plan_body,
    static_argnames=(
        "W", "npa_pad", "nsegB_pad", "nrow", "nrow_pad", "nnz", "pattern",
        "b2_ws", "presorted", "classes_n", "remap",
    ),
)


def _is_pattern(M: CSR) -> bool:
    """True when every stored value is exactly 1.0 — the reference's forced
    semantics (serial_newblock_clock.cpp:84,96).  O(nnz) host check, ~ms.
    Device-resident values are NOT pulled to host (a D2H of the whole value
    array would dwarf the saving) — auto-detection
    answers False there; callers that know pass ``pattern=True``."""
    d = M.data
    if not isinstance(d, np.ndarray):
        return False
    return bool(np.all(d[: M.nnz] == 1))


@functools.partial(jax.jit, static_argnames=("nrow", "nnz_pad"))
def _compact_to_csr(chunk_rows, chunk_cols, chunk_vals, chunk_nuniq, *, nrow, nnz_pad):
    """Slab-compressed chunk outputs -> device CSR arrays (data, indices,
    indptr, nnz).  Uses only set/max scatters, which need no duplicate
    resolution: per-row counts scatter to build indptr, then each row's uniques
    scatter to its indptr slot.  Enables chaining C into further device ops
    without a host round-trip."""
    counts = jnp.zeros((nrow,), jnp.int32)
    for r, nu in zip(chunk_rows, chunk_nuniq):
        counts = counts.at[r].max(nu, mode="drop")  # rows unique across chunks
    indptr = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)])
    data = jnp.zeros((nnz_pad,), chunk_vals[0].dtype)
    indices = jnp.zeros((nnz_pad,), jnp.int32)
    for r, cols_u, vals_u, nu in zip(chunk_rows, chunk_cols, chunk_vals, chunk_nuniq):
        R_pad, L = cols_u.shape
        base = indptr[r]  # (R_pad,)
        pp = jax.lax.broadcasted_iota(jnp.int32, (R_pad, L), 1)
        dest = base[:, None] + pp
        dest = jnp.where(pp < nu[:, None], dest, nnz_pad)  # drop padding
        data = data.at[dest.reshape(-1)].set(vals_u.reshape(-1), mode="drop")
        indices = indices.at[dest.reshape(-1)].set(cols_u.reshape(-1), mode="drop")
    return data, indices, indptr, indptr[-1]


def spgemm_slab_csr(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    A_dev: CSR | None = None,
    B_dev: CSR | None = None,
    nnz_pad: int | None = None,
    pattern: bool | None = None,
    sizing=None,
):
    """C = A @ B as a DEVICE-RESIDENT padded CSR — chainable into further
    device ops (SpMM, another SpGEMM) without host transfers.  Requires no
    heavy-tail rows (raise the class ceiling or use :func:`spgemm_slab`).
    ``nnz_pad`` defaults to the padded-expansion bound (safe upper bound on
    the output nnz); pass a tighter bound to save memory.  ``sizing``: a
    precomputed ``_sizing`` result to avoid re-running the O(nnz) pass."""
    W = seg_w
    classes_n = tuple(sorted({_round_up(c, W) for c in classes}))
    if sizing is None:
        sizing = _sizing(A, B, W, classes_n)
    elif not isinstance(sizing, Sizing):  # legacy 4-tuple callers
        sizing = Sizing(*sizing)
    outs, tail_rows, _ = spgemm_slab_device(
        A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
        accum_dtype=accum_dtype, A_dev=A_dev, B_dev=B_dev, pattern=pattern,
        sizing=sizing,
    )
    if len(tail_rows):
        raise ValueError(
            f"{len(tail_rows)} rows exceed the largest expansion class; "
            "use spgemm_slab() (host fallback) or raise the class ceiling"
        )
    if nnz_pad is None:
        # padded expansion bound: every output nnz is at least one partial
        nnz_pad = _round_up(sizing.npa * W, 1024)
    data, indices, indptr, knnz = _compact_to_csr(
        tuple(o[0] for o in outs),
        tuple(o[1] for o in outs),
        tuple(o[2] for o in outs),
        tuple(o[3] for o in outs),
        nrow=A.nrow,
        nnz_pad=nnz_pad,
    )
    return CSR(
        data=data, indices=indices, indptr=indptr,
        shape=(A.nrow, B.ncol), nnz=int(knnz),
    )


def _chunk_schedule(classes, counts, slot_budget):
    """(L, R_pad, start, count) per numeric call from host-side class counts.
    R_pad rounds to 1K-row granules (not pow2) to bound slab padding — with
    the ~1.25x class grid this cuts web-Google padded slots 68M -> 42M (38%)
    vs pow2 classes at 16K granules; the persistent compile cache absorbs the
    extra shape variety."""
    sched = []
    offset = 0
    for ci, L in enumerate(classes):
        n = int(counts[ci])
        rows_per_chunk = max(slot_budget // L, 8)
        for lo in range(0, n, rows_per_chunk):
            cnt = min(rows_per_chunk, n - lo)
            R_pad = min(_bucket_pow2(cnt), _round_up(cnt, 1 << 10))
            sched.append((L, R_pad, offset + lo, cnt))
        offset += n
    return sched, offset  # offset = start of tail rows in rows_sorted


@functools.partial(
    jax.jit,
    static_argnames=(
        "W", "npa_pad", "nsegB_pad", "nrow", "nrow_pad", "nnz", "schedule",
        "accum_dtype", "pattern", "b2_ws", "presorted", "classes_n", "remap",
    ),
)
def _fused_exec(
    a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, order,
    *, W, npa_pad, nsegB_pad, nrow, nrow_pad, nnz, schedule, accum_dtype,
    pattern=False, b2_ws=None, presorted=False, patch=None, b2_packed=None,
    classes_n=None, remap=None, pre=None,
):
    """plan + every class chunk in ONE compiled program — a single dispatch
    instead of one per phase and chunk.  ``pre``: the (b2, seg_off, c_a)
    triple from an earlier ``_pre_build`` dispatch (overlapped with host
    sizing)."""
    (b2_packed, pa_packed, rowmeta, rows_sorted) = _plan_body(
        a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, order,
        W=W, npa_pad=npa_pad, nsegB_pad=nsegB_pad, nrow=nrow, nrow_pad=nrow_pad,
        nnz=nnz, pattern=pattern, b2_ws=b2_ws, presorted=presorted, patch=patch,
        b2_packed=b2_packed, classes_n=classes_n, remap=remap, pre=pre,
    )
    a_dt, b_dt = str(a_dat.dtype), str(b_dat.dtype)
    outs = tuple(
        _chunk_body(
            b2_packed, pa_packed, rows_sorted, rowmeta,
            jnp.int32(start), jnp.int32(cnt), L=L, R_pad=R_pad, W=W,
            a_dtype=a_dt, b_dtype=b_dt, accum_dtype=accum_dtype, pattern=pattern,
            b2_ws=b2_ws,
        )
        for (L, R_pad, start, cnt) in schedule
    )
    return rows_sorted, outs


def spgemm_slab_device(
    A: CSR,
    B: CSR,
    plan: SpgemmPlan | None = None,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    A_dev: CSR | None = None,
    B_dev: CSR | None = None,
    pattern: bool | None = None,
    sizing=None,
):
    """Device-resident SpGEMM: returns (chunk outputs, tail row ids, plan).
    Chunk outputs are device arrays (rows, cols_u, vals_u, nuniq) per call —
    a slab-compressed C.  Use :func:`spgemm_slab` for a host CSR.

    Without a pre-built plan this runs the FUSED path: one compiled program
    covering plan + stream + every class chunk (single dispatch).  With a
    plan, the phases run as separate dispatches (incremental / test use).
    ``pattern=None`` auto-detects all-ones values (reference semantics) and
    drops the value channels from the device program.  ``sizing``: a
    precomputed ``_sizing`` result (avoids re-running the O(nnz) pass)."""
    if plan is not None:
        sched, tail_start = _chunk_schedule(
            plan.classes, plan.class_counts, plan.slot_budget
        )
        # one compiled program for ALL chunks (single dispatch) — the
        # numeric phase of the two-phase API.  Plans
        # carrying the class-aligned cache run the gather-free program; the
        # cache's accum dtype must match (else fall back to the fetch path).
        use_aligned = bool(plan.aligned_cols) and plan.aligned_accum == str(
            jnp.dtype(accum_dtype).name
        )
        if use_aligned:
            outs = list(
                _fused_numeric_aligned(
                    plan.aligned_cols,
                    plan.aligned_vals,
                    plan.rows_sorted,
                    schedule=tuple(sched),
                    accum_dtype=accum_dtype,
                    pattern=plan.pattern,
                )
            )
        else:
            outs = list(
                _fused_numeric(
                    plan.b2_packed,
                    plan.pa_packed,
                    plan.rows_sorted,
                    plan.rowmeta,
                    schedule=tuple(sched),
                    W=plan.seg_w,
                    a_dtype=plan.a_dtype,
                    b_dtype=plan.b_dtype,
                    accum_dtype=accum_dtype,
                    pattern=plan.pattern,
                    b2_ws=plan.b2_ws,
                )
            )
        ntail = int(plan.class_counts[len(plan.classes)])
        tail_rows = (
            np.asarray(plan.rows_sorted[tail_start : tail_start + ntail])
            if ntail
            else np.zeros(0, np.int32)
        )
        return outs, tail_rows, plan

    # ---- fused single-dispatch path ---------------------------------------
    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)
    A_dev, B_dev = (A_dev or A), (B_dev or B)
    pre = None
    if sizing is None:
        if isinstance(B.data, np.ndarray):
            # the B2 build doesn't depend on the sizing pass — only on
            # nsegB, a cheap O(nrowB) host sum.  Dispatch it FIRST (async)
            # so its device time overlaps the O(nnz) host sizing.  (Moving
            # MORE of the plan into this pre-program was tried and measured
            # WORSE: the extra cross-program buffers ate the overlap — see
            # _pre_build's docstring.)
            b_iptr = np.asarray(B.indptr, np.int64)
            nsegB_pre = _nseg_pad(
                int(((b_iptr[1:] - b_iptr[:-1] + W - 1) // W).sum())
            )
            pre = _b2_build(
                jnp.asarray(B_dev.indptr, jnp.int32),
                jnp.asarray(B_dev.indices, jnp.int32),
                jnp.asarray(B_dev.data),
                W=W,
                nsegB_pad=nsegB_pre,
                pattern=pattern,
                b2_ws=_pick_b2_ws(W, pattern, np.dtype(B_dev.data.dtype), nsegB_pre),
            )
        sizing = _sizing(A, B, W, classes)
    elif not isinstance(sizing, Sizing):  # legacy 4-tuple callers
        sizing = Sizing(*sizing)
    npa, nsegB, cls, counts = sizing
    sched, tail_start = _chunk_schedule(classes, counts, slot_budget)
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    nsegB_pad = _nseg_pad(nsegB)
    npa_pad = _round_up(npa, 1024)
    if pre is not None and _nseg_pad(nsegB) != pre.shape[0] * 128 // _pick_b2_ws(
        W, pattern, np.dtype(B_dev.data.dtype), nsegB_pad
    ):
        pre = None  # defensive: host nsegB disagreed with the sizing pass
    # NO nrow/nnz-scale host->device input: the class vector and its stable
    # sort are recomputed on device (order=None + classes_n/remap,
    # _plan_body).
    device_cls = sizing.rows_sorted is None  # device sizing: cls is resident
    rows_sorted, outs = _fused_exec(
        jnp.asarray(A_dev.indptr, jnp.int32),
        jnp.asarray(A_dev.indices, jnp.int32),
        jnp.asarray(A_dev.data),
        jnp.asarray(B_dev.indptr, jnp.int32),
        jnp.asarray(B_dev.indices, jnp.int32),
        jnp.asarray(B_dev.data),
        jnp.asarray(cls) if device_cls else None,
        W=W,
        npa_pad=npa_pad,
        nsegB_pad=nsegB_pad,
        nrow=A.nrow,
        nrow_pad=A.nrow + max_chunk,
        nnz=A.nnz,
        schedule=tuple(sched),
        accum_dtype=accum_dtype,
        pattern=pattern,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(B_dev.data.dtype), nsegB_pad),
        classes_n=None if device_cls else classes,
        remap=None if device_cls else sizing.remap,
        b2_packed=pre,
    )
    ntail = int(counts[len(classes)])
    if ntail == 0:
        tail_rows = np.zeros(0, np.int32)
    elif sizing.rows_sorted is not None:
        # host mirror of the device's stable class sort: tail ids read from
        # host memory instead of a device slice round-trip
        tail_rows = sizing.rows_sorted[tail_start : tail_start + ntail]
    else:
        tail_rows = np.asarray(rows_sorted[tail_start : tail_start + ntail])
    return list(outs), tail_rows, None


def spgemm_chain_device(plan: "SpgemmPlan", n_products: int = 8, *,
                        accum_dtype=jnp.float32):
    """``n_products`` plan-reuse numeric phases launched back-to-back with
    NO intermediate fence — the repeated-product steady state (same
    structure each step: the cuSPARSE spgemm-reuse contract, and the shape
    of pagerank-style iteration where the plan is rebuilt only on structure
    change).

    The warm path waits for every product; here the
    dispatches queue asynchronously on the device and the caller fences
    ONCE at the end, so per-product cost approaches the pure device-time
    floor.  Returns the last product's chunk outputs (all products are
    identical by construction; timing the chain and dividing by
    ``n_products`` is the honest per-product steady-state measurement —
    bench.py's ``spgemm_chain_ms``).

    Requires an aligned-cache plan (``spgemm_plan(expand=True)``, the
    default) with a matching accumulation dtype."""
    assert plan.aligned_cols, "chain requires an aligned-cache plan"
    assert plan.aligned_accum == str(jnp.dtype(accum_dtype).name), (
        plan.aligned_accum, accum_dtype)
    sched, _ = _chunk_schedule(plan.classes, plan.class_counts, plan.slot_budget)
    outs = None
    for _ in range(max(int(n_products), 1)):
        outs = _fused_numeric_aligned(
            plan.aligned_cols,
            plan.aligned_vals,
            plan.rows_sorted,
            schedule=tuple(sched),
            accum_dtype=accum_dtype,
            pattern=plan.pattern,
        )
    return list(outs)


#: auto plan-reuse (spgemm_slab): operand pairs multiplied a second time get
#: a cached two-phase plan; call 3+ runs the gather-free aligned numeric
#: program.  Weakly keyed by operand
#: identity; capped to bound device memory (~8 B/padded-slot per plan).
_PLAN_SEEN: dict = {}
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX = 2
AUTO_PLAN_MIN_NNZ = 1 << 18


def _operand_fingerprint(A: CSR, B: CSR):
    """Cheap content fingerprint guarding the auto plan cache against
    in-place mutation of the (frozen-dataclass, but numpy-backed) operands:
    the plan bakes VALUES and STRUCTURE, so a user writing A.data[:] between
    calls must invalidate it.  Full sums over data+indices (~10 ms at 5M
    nnz — small next to the O(nnz) sizing pass this path already runs)."""
    def fp(M):
        d = np.asarray(M.data[: M.nnz])
        return (
            int(M.nnz),
            float(np.add.reduce(d, dtype=np.float64)),
            int(np.add.reduce(np.asarray(M.indices[: M.nnz]), dtype=np.int64)),
        )

    return fp(A) + (fp(B) if B is not A else ())


def _operand_digest(A: CSR, B: CSR) -> str:
    """Collision-resistant content hash for CROSS-PROCESS checkpoint resume.

    The in-memory plan cache pairs :func:`_operand_fingerprint` with object
    identity, so the sum-based fingerprint only has to catch in-place
    mutation; the checkpoint manifest has no identity to lean on — the
    fingerprint alone is invariant under value swaps and equal-sum
    permutations, so a different product could silently resume stale pieces.
    sha256 over the exact operand bytes (data/indices/indptr, trimmed to
    nnz) is ~1 GB/s — trivial next to the minutes-long streamed runs this
    guards."""
    import hashlib

    h = hashlib.sha256()
    for M in (A,) if B is A else (A, B):
        for arr in (M.data[: M.nnz], M.indices[: M.nnz], M.indptr):
            a = np.ascontiguousarray(np.asarray(arr))
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _auto_plan_lookup(key, A, B):
    ent = _PLAN_CACHE.get(key)
    if ent is not None and ent[0]() is A and ent[1]() is B:
        if ent[3] == _operand_fingerprint(A, B):
            return ent[2]
        _PLAN_CACHE.pop(key, None)  # operands mutated in place: invalidate
    return None


def _auto_plan_note(key, A, B, build):
    """Second sighting of the same (A, B, config) triggers the plan build."""
    import weakref

    seen = _PLAN_SEEN.get(key)
    if seen is None or seen[0]() is not A or seen[1]() is not B:
        _PLAN_SEEN[key] = (
            weakref.ref(A, lambda r, k=key: _PLAN_SEEN.pop(k, None)),
            weakref.ref(B, lambda r, k=key: _PLAN_SEEN.pop(k, None)),
        )
        return None
    plan = build()
    while len(_PLAN_CACHE) >= _PLAN_CACHE_MAX:
        _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
    _PLAN_CACHE[key] = (
        weakref.ref(A, lambda r, k=key: _PLAN_CACHE.pop(k, None)),
        weakref.ref(B, lambda r, k=key: _PLAN_CACHE.pop(k, None)),
        plan,
        _operand_fingerprint(A, B),
    )
    return plan


def spgemm_slab(
    A: CSR,
    B: CSR,
    *,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    as_csr: bool = True,
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
):
    """C = A @ B via per-row-class batched slab sorts (exact: duplicate
    columns merged, rows ascending, columns sorted within rows).

    Repeated products over the SAME operand objects self-optimize: the
    second call builds the two-phase plan (class-aligned expansion cache,
    see :func:`spgemm_plan`) and every later call executes the gather-free
    numeric program — no API opt-in needed (host-CSR operands, tail-free
    sizings, nnz >= AUTO_PLAN_MIN_NNZ)."""
    if pattern is None:  # detect ONCE here; threaded through every sub-call
        pattern = _is_pattern(A) and _is_pattern(B)
    if A.nnz == 0 or B.nnz == 0:
        out = COO(
            row=np.zeros(0, np.int32),
            col=np.zeros(0, np.int32),
            data=np.zeros(0, np.float32),
            shape=(A.nrow, B.ncol),
            nnz=0,
        )
        return to_csr(out) if as_csr else out
    # huge products: split A's rows so each piece's padded expansion fits
    # the device kernel's int32 budget (the >=100M-nnz multi-host regime)
    W = seg_w
    classes_n = tuple(sorted({_round_up(c, W) for c in classes}))
    try:
        sizing = _sizing(A, B, W, classes_n)
        if checkpoint_dir is not None:
            # checkpointing is piece-granular and only engages on the
            # streamed big path; a product that fits one call has no pieces
            # to persist — say so instead of silently ignoring the flag
            import warnings

            warnings.warn(
                "checkpoint_dir ignored: product fits a single call (no "
                "pieces to checkpoint); only >=budget streamed products "
                "resume", stacklevel=2,
            )
    except _ExpansionTooLarge as e:
        # huge products: uniform row pieces through ONE compiled program
        # (recursive halving would recompile per piece size).  Start the
        # piece search at total/(budget/2) — repartitioning a 100M-nnz
        # matrix per doubling is seconds each.
        hint = 2
        while hint * _MAX_EXP_PAD < int(e.args[0]) * 2:
            hint *= 2
        out = spgemm_slab_big(
            A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
            accum_dtype=accum_dtype, pattern=pattern, pieces_hint=hint,
            checkpoint_dir=checkpoint_dir,
        )
        if as_csr:
            return out
        from spmm_tpu.formats.containers import to_coo

        return to_coo(out)

    # device-compact is only a win while its padded-expansion-sized scratch
    # (data+indices, ~8 B/slot) fits comfortably next to the chunk outputs;
    # past this, host assembly (pull each chunk, free it) has the lower peak
    _CSR_COMPACT_MAX = 1 << 26
    ntail = sizing.counts[len(classes_n)] if len(sizing.counts) > len(classes_n) else 0
    auto_ok = (
        as_csr
        and ntail == 0
        and A.nnz >= AUTO_PLAN_MIN_NNZ
        and sizing.npa * W <= _CSR_COMPACT_MAX
        and isinstance(A.data, np.ndarray)
    )
    if auto_ok:
        key = (
            id(A), id(B), classes_n, W, slot_budget,
            str(jnp.dtype(accum_dtype).name), pattern,
        )
        plan = _auto_plan_lookup(key, A, B)
        if plan is None:
            plan = _auto_plan_note(
                key, A, B,
                lambda: spgemm_plan(
                    A, B, classes=classes, seg_w=W, slot_budget=slot_budget,
                    pattern=pattern, accum_dtype=accum_dtype, sizing=sizing,
                ),
            )
        if plan is not None and plan.aligned_cols:
            sched, _ = _chunk_schedule(
                plan.classes, plan.class_counts, plan.slot_budget
            )
            nnz_pad = _round_up(plan.npa * plan.seg_w, 1024)
            data, indices, indptr, knnz = _fused_numeric_aligned_csr(
                plan.aligned_cols, plan.aligned_vals, plan.rows_sorted,
                schedule=tuple(sched), accum_dtype=accum_dtype,
                pattern=plan.pattern, nrow=A.nrow, nnz_pad=nnz_pad,
            )
            k = int(knnz)
            return CSR(
                data=np.asarray(data[:k]),
                indices=np.asarray(indices[:k], np.int32),
                indptr=np.asarray(indptr, np.int64),
                shape=(A.nrow, B.ncol),
                nnz=k,
            )
    if as_csr and sizing.npa * W <= _CSR_COMPACT_MAX:
        # fast path: compact on device, transfer only the CSR arrays
        # (~out_nnz * 8 B instead of the padded slabs)
        try:
            Cd = spgemm_slab_csr(
                A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
                accum_dtype=accum_dtype, pattern=pattern, sizing=sizing,
            )
            h = Cd.host()
            return CSR(
                data=np.asarray(h.data[: Cd.nnz]),
                indices=np.asarray(h.indices[: Cd.nnz], np.int32),
                indptr=np.asarray(h.indptr, np.int64),
                shape=Cd.shape,
                nnz=Cd.nnz,
            )
        except ValueError:
            pass  # heavy-tail rows: fall through to the host-assembly path
    outs, tail_rows, _ = spgemm_slab_device(
        A, B, classes=classes, seg_w=seg_w, slot_budget=slot_budget,
        accum_dtype=accum_dtype, pattern=pattern, sizing=sizing,
    )

    out_rows, out_cols, out_vals = _pull_chunks(outs)
    if len(tail_rows):
        tr, tc, tv = _tail_products(
            A.host(), np.asarray(tail_rows, np.int64), B.host(), accum_dtype
        )
        out_rows.append(tr)
        out_cols.append(tc)
        out_vals.append(tv)

    rows = np.concatenate(out_rows) if out_rows else np.zeros(0, np.int64)
    cols = np.concatenate(out_cols) if out_cols else np.zeros(0, np.int64)
    vals = np.concatenate(out_vals) if out_vals else np.zeros(0, np.float32)

    out = _assemble_csr(rows, cols, vals, (A.nrow, B.ncol))
    if as_csr:
        return out
    from spmm_tpu.formats.containers import to_coo

    return to_coo(out)


@functools.partial(
    jax.jit,
    static_argnames=(
        "W", "npa_pad", "nsegB_pad", "nrow", "nrow_pad", "schedule",
        "accum_dtype", "pattern", "b2_ws",
    ),
)
def _piece_exec(
    a_indptr, a_ind, a_dat, cls_s, nnz_sc, sc_tab, b_indptr, b_ind, b_dat,
    *, W, npa_pad, nsegB_pad, nrow, nrow_pad, schedule, accum_dtype, pattern,
    b2_ws=None,
):
    """One uniform piece of a huge product: plan + runtime-scalar chunk
    schedule.  All pieces share this single compiled program — piece nnz and
    per-chunk (start, count) enter as traced scalars (``sc_tab``), exactly
    the uniform-schedule trick the SPMD path uses across shards
    (parallel/spgemm_spmd.py)."""
    (b2p, pap, rowmeta, rows_sorted) = _plan_body(
        a_indptr, a_ind, a_dat, b_indptr, b_ind, b_dat, cls_s,
        W=W, npa_pad=npa_pad, nsegB_pad=nsegB_pad, nrow=nrow, nrow_pad=nrow_pad,
        nnz=nnz_sc[0], pattern=pattern, b2_ws=b2_ws,
    )
    a_dt, b_dt = str(a_dat.dtype), str(b_dat.dtype)
    outs = tuple(
        _chunk_body(
            b2p, pap, rows_sorted, rowmeta, sc_tab[0, i], sc_tab[1, i],
            L=L, R_pad=R_pad, W=W, a_dtype=a_dt, b_dtype=b_dt,
            accum_dtype=accum_dtype, pattern=pattern, b2_ws=b2_ws,
        )
        for i, (L, R_pad) in enumerate(schedule)
    )
    return rows_sorted, outs


class _BigCheckpoint:
    """Piece-granular checkpoint/resume for :func:`spgemm_slab_big`.

    The reference has NO checkpoint/resume at all (SURVEY.md §5 — it even
    leaks its preprocessing outputs); here the >=100M-nnz streamed products
    run for minutes, so each completed piece's CSR
    triple is persisted (one .npz per piece) and a manifest pins the product
    it belongs to.  A re-run with the same ``checkpoint_dir`` skips finished
    pieces; a manifest mismatch (different operands/config) raises rather
    than silently mixing two products."""

    def __init__(self, path, A, B, P, classes, W, slot_budget, accum, pattern,
                 extra=None):
        import json
        import os

        self.dir = path
        os.makedirs(path, exist_ok=True)
        manifest = {
            **(extra or {}),
            # repr-strings, not floats: NaN in operand data would make the
            # JSON round-trip compare NaN != NaN and refuse a valid resume
            "fingerprint": [repr(x) for x in _operand_fingerprint(A, B)],
            # collision-resistant byte hash: the sum fingerprint is invariant
            # under value swaps / equal-sum permutations, which is fine for
            # the identity-paired in-memory cache but not for blind resume
            "sha256": _operand_digest(A, B),
            "shape_a": list(A.shape),
            "shape_b": list(B.shape),
            "pieces": int(P),
            "classes": list(classes),
            "seg_w": int(W),
            "slot_budget": int(slot_budget),
            "accum_dtype": accum,
            "pattern": bool(pattern),
        }
        mpath = os.path.join(path, "manifest.json")
        prev = None
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    prev = json.load(f)
            except ValueError:
                prev = None  # torn write (crash mid-manifest): rewrite below
        if prev is not None:
            if prev != manifest:
                raise ValueError(
                    f"checkpoint dir {path!r} holds a different product/config "
                    "(manifest mismatch); point at a fresh directory"
                )
        else:
            # no (or torn) manifest: any piece files present are unattributable
            # — drop them rather than resume from unknown provenance
            import glob

            for fp in glob.glob(os.path.join(path, "piece_*.npz")):
                os.remove(fp)
            tmp = mpath + ".tmp"
            with open(tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(tmp, mpath)  # atomic, like the piece files

    def _piece_path(self, p: int) -> str:
        import os

        return os.path.join(self.dir, f"piece_{p:05d}.npz")

    def load(self, p: int):
        import os

        fp = self._piece_path(p)
        if not os.path.exists(fp):
            return None
        try:
            with np.load(fp) as z:
                return (z["data"], z["indices"], z["indptr"])
        except Exception:  # torn write (crash mid-save): recompute the piece
            os.remove(fp)
            return None

    def save(self, p: int, triple) -> None:
        import os

        fp = self._piece_path(p)
        tmp = fp + ".tmp.npz"  # np.savez appends .npz to bare names
        data, indices, indptr = triple
        np.savez(tmp, data=data, indices=indices, indptr=indptr)
        os.replace(tmp, fp)  # atomic: a crash never leaves a torn piece file

    # -- multi-shard pieces (the distributed big path: one file per piece
    # holding every shard's local CSR triple) ------------------------------
    def load_multi(self, p: int, nsh: int):
        import os

        fp = self._piece_path(p)
        if not os.path.exists(fp):
            return None
        try:
            with np.load(fp) as z:
                return [
                    (z[f"data{s}"], z[f"ind{s}"], z[f"iptr{s}"])
                    for s in range(nsh)
                ]
        except Exception:  # torn write or wrong shard count: recompute
            os.remove(fp)
            return None

    def save_multi(self, p: int, triples) -> None:
        import os

        fp = self._piece_path(p)
        tmp = fp + ".tmp.npz"
        arrs = {}
        for s, (data, indices, indptr) in enumerate(triples):
            arrs[f"data{s}"] = data
            arrs[f"ind{s}"] = indices
            arrs[f"iptr{s}"] = indptr
        np.savez(tmp, **arrs)
        os.replace(tmp, fp)


def spgemm_slab_big(
    A: CSR,
    B: CSR,
    *,
    pieces: int | None = None,
    pieces_hint: int | None = None,
    classes: Sequence[int] = DEFAULT_CLASSES,
    seg_w: int = DEFAULT_SEG_W,
    slot_budget: int = DEFAULT_SLOT_BUDGET,
    accum_dtype=jnp.float32,
    pattern: bool | None = None,
    checkpoint_dir: str | None = None,
) -> CSR:
    """C = A @ B for products whose padded expansion exceeds the single-call
    budget (the >=100M-nnz regime, single-device analog of spgemm_dist_big).

    A is split into uniform row pieces; every piece runs the SAME compiled
    program (:func:`_piece_exec`) with per-piece runtime scalars, outputs are
    pulled and freed piece by piece, so both compile count and device peak
    stay piece-sized.  ``pieces`` defaults to the smallest power of two whose
    largest piece fits ``_MAX_EXP_PAD`` padded slots.

    ``checkpoint_dir``: persist each completed piece and resume a killed run
    from the last finished piece (see :class:`_BigCheckpoint`).  The caller
    owns the directory's lifetime (delete it after the product is consumed)."""
    from spmm_tpu.parallel.partition import partition_rows
    from spmm_tpu.parallel.spgemm_spmd import _per_shard_sizing, _uniform_schedule

    W = seg_w
    classes = tuple(sorted({_round_up(c, W) for c in classes}))
    if pattern is None:
        pattern = _is_pattern(A) and _is_pattern(B)

    P = pieces or pieces_hint or 2
    while True:
        S = partition_rows(A, P)
        # a SINGLE row's expansion can exceed the budget (it becomes a tail
        # row and never enters the slabs) — stop splitting at one-row pieces
        # instead of doubling forever
        at_min = S.rows_per_shard <= 1 or P >= A.nrow
        try:
            cls, counts, npa_max, nnz_s = _per_shard_sizing(S, B, W, classes)
        except ValueError:  # a piece still exceeds int32 expansion
            if at_min:
                raise  # one row alone exceeds the int32 pa bound
            P *= 2
            continue
        if pieces is not None or npa_max * W <= _MAX_EXP_PAD or at_min:
            break
        P *= 2

    sched, starts, cnts, _ = _uniform_schedule(
        classes=classes, counts=counts[:, : len(classes) + 1], slot_budget=slot_budget
    )
    tail_per_piece = counts[:, len(classes)]
    schedule = tuple(sched)
    sc_tab = np.stack([starts, cnts], axis=1)  # (P, 2, nchunks)

    Bh = B.host()
    b_iptr64 = np.asarray(Bh.indptr, np.int64)
    lenB = b_iptr64[1:] - b_iptr64[:-1]
    nsegB = int(((lenB + W - 1) // W).sum())
    max_chunk = _bucket_pow2(max(slot_budget // classes[0], 8))
    rows_pad = S.rows_per_shard
    nsegB_pad = _nseg_pad(nsegB)
    kw = dict(
        W=W,
        npa_pad=_round_up(npa_max, 1024),
        nsegB_pad=nsegB_pad,
        nrow=rows_pad,
        nrow_pad=rows_pad + max_chunk,
        schedule=schedule,
        accum_dtype=accum_dtype,
        pattern=pattern,
        b2_ws=_pick_b2_ws(W, pattern, np.dtype(Bh.data.dtype), nsegB_pad),
    )

    b_dev = (
        jnp.asarray(Bh.indptr, jnp.int32),
        jnp.asarray(Bh.indices, jnp.int32),
        jnp.asarray(Bh.data),
    )
    s_ind = np.asarray(S.indices)
    s_dat = np.asarray(S.data)
    s_iptr = np.asarray(S.indptr)

    # per piece: (data, indices, local indptr) as TIGHT host arrays.  Pieces
    # without heavy-tail rows compact ON DEVICE (_compact_to_csr) and
    # transfer only real nonzeros — no padded slabs to the host, no
    # host masking, and the final CSR is a plain concatenation (pieces are
    # ordered row blocks).  Tail-bearing pieces take the masked path + a
    # local counting sort.
    ckpt = (
        _BigCheckpoint(
            checkpoint_dir, A, B, P, classes, W, slot_budget,
            str(jnp.dtype(accum_dtype).name), pattern,
        )
        if checkpoint_dir is not None
        else None
    )
    nnz_pad_piece = _round_up(npa_max * W, 1024)
    piece_csrs = []
    for p in range(P):
        if ckpt is not None:
            got = ckpt.load(p)
            if got is not None:
                piece_csrs.append(got)
                continue
        rows_sorted, outs = _piece_exec(
            jnp.asarray(s_iptr[p], jnp.int32),
            jnp.asarray(s_ind[p], jnp.int32),
            jnp.asarray(s_dat[p]),
            jnp.asarray(cls[p]),
            jnp.asarray(nnz_s[p : p + 1]),
            jnp.asarray(sc_tab[p]),
            *b_dev,
            **kw,
        )
        nt = int(tail_per_piece[p])
        if nt == 0 and not outs:  # piece holds only empty rows
            piece_csrs.append(
                (
                    np.zeros(0, np.dtype(jnp.dtype(accum_dtype).name)),
                    np.zeros(0, np.int32),
                    np.zeros(rows_pad + 1, np.int64),
                )
            )
            if ckpt is not None:
                ckpt.save(p, piece_csrs[-1])
            del rows_sorted
            continue
        if nt == 0:
            data, indices, indptr, knnz = _compact_to_csr(
                tuple(o[0] for o in outs),
                tuple(o[1] for o in outs),
                tuple(o[2] for o in outs),
                tuple(o[3] for o in outs),
                nrow=rows_pad,
                nnz_pad=nnz_pad_piece,
            )
            k = int(knnz)
            piece_csrs.append(
                (
                    np.asarray(data[:k]),
                    np.asarray(indices[:k], np.int32),
                    np.asarray(indptr, np.int64),
                )
            )
            if ckpt is not None:
                ckpt.save(p, piece_csrs[-1])
            del data, indices, indptr, rows_sorted, outs
            continue

        rows_l, cols_l, vals_l = _pull_chunks(outs)
        base = int(counts[p, : len(classes)].sum())
        trows = np.asarray(rows_sorted)[base : base + nt].astype(np.int64)
        sub_full = CSR(
            data=s_dat[p],
            indices=np.asarray(s_ind[p], np.int32),
            indptr=np.asarray(s_iptr[p], np.int64),
            shape=(rows_pad, A.shape[1]),
            nnz=int(nnz_s[p]),
        )
        tr, tc, tv = _tail_products(sub_full, trows, Bh, accum_dtype)
        rows_l.append(tr)
        cols_l.append(tc)
        vals_l.append(tv)
        del rows_sorted
        Cp = _assemble_csr(
            np.concatenate(rows_l), np.concatenate(cols_l), np.concatenate(vals_l),
            (rows_pad, B.ncol),
        )
        piece_csrs.append(
            (
                np.asarray(Cp.data[: Cp.nnz]),
                np.asarray(Cp.indices[: Cp.nnz], np.int32),
                np.asarray(Cp.indptr, np.int64),
            )
        )
        if ckpt is not None:
            ckpt.save(p, piece_csrs[-1])

    # stitch ordered row-block CSRs; crop padded rows past A.nrow
    datas = [c[0] for c in piece_csrs]
    inds = [c[1] for c in piece_csrs]
    iptrs = []
    off = 0
    for i, (_, _, ip) in enumerate(piece_csrs):
        ip = ip + off
        iptrs.append(ip if i == 0 else ip[1:])
        off = int(ip[-1])
    indptr_full = np.concatenate(iptrs) if iptrs else np.zeros(1, np.int64)
    return CSR(
        data=np.concatenate(datas) if datas else np.zeros(0, np.float32),
        indices=np.concatenate(inds) if inds else np.zeros(0, np.int32),
        indptr=indptr_full[: A.nrow + 1],
        shape=(A.nrow, B.ncol),
        nnz=int(indptr_full[A.nrow]),
    )



def _pull_chunks(outs):
    """Pull slab chunk outputs to host as (rows, cols, vals) lists, freeing
    each chunk's device buffers as it is consumed."""
    rows_l, cols_l, vals_l = [], [], []
    outs = list(outs)
    while outs:
        r, cols_u, vals_u, nuniq = outs.pop(0)
        nu = np.asarray(nuniq)
        L = cols_u.shape[1]
        mask = np.arange(L)[None, :] < nu[:, None]
        rows_l.append(np.repeat(np.asarray(r, np.int64), nu))
        cols_l.append(np.asarray(cols_u)[mask].astype(np.int64))
        vals_l.append(np.asarray(vals_u)[mask])
        del r, cols_u, vals_u, nuniq
    return rows_l, cols_l, vals_l


def _tail_products(H: CSR, trows: np.ndarray, Bh: CSR, accum_dtype):
    """Heavy-tail rows via the global-sort fallback: products of ``H``'s rows
    ``trows`` with B, upcast to ``accum_dtype`` to match the slab rows.
    Returns (rows [ids into trows' ROW SPACE of H], cols, vals)."""
    from spmm_tpu.ops.spgemm import spgemm as spgemm_sorted

    npdt = np.dtype(jnp.dtype(accum_dtype).name)
    sub = _take_rows(H, trows)
    sub = dataclasses.replace(sub, data=np.asarray(sub.data, npdt))
    Bc = dataclasses.replace(Bh, data=np.asarray(np.asarray(Bh.data), npdt))
    Ct = spgemm_sorted(sub, Bc, as_csr=False)
    rows = trows[np.asarray(Ct.row[: Ct.nnz], np.int64)]
    return (
        rows,
        np.asarray(Ct.col[: Ct.nnz], np.int64),
        np.asarray(Ct.data[: Ct.nnz]),
    )


def _assemble_csr(rows, cols, vals, shape) -> CSR:
    """Concatenated per-chunk outputs → canonical CSR without a global
    comparison sort: each row lives in exactly one chunk with its columns
    already sorted, so a STABLE sort by row id alone (native counting sort
    when available) yields the final order."""
    nrow = shape[0]
    counts = np.bincount(rows, minlength=nrow) if len(rows) else np.zeros(nrow, np.int64)
    out_indptr = np.zeros(nrow + 1, dtype=np.int64)
    np.cumsum(counts, out=out_indptr[1:])
    nnz_out = int(out_indptr[-1])
    c_ind = np.empty(nnz_out, dtype=np.int32)
    c_dat = np.empty(nnz_out, dtype=vals.dtype if len(vals) else np.float32)
    if nnz_out:
        from spmm_tpu.ops.transform import _stable_argsort_smallint

        order = _stable_argsort_smallint(rows, nrow)
        c_ind[:] = cols[order]
        c_dat[:] = vals[order]
    return CSR(
        data=c_dat,
        indices=c_ind,
        indptr=out_indptr,
        shape=shape,
        nnz=nnz_out,
    )


def _take_rows(Ah: CSR, rows: np.ndarray) -> CSR:
    """Sub-CSR holding only ``rows`` (same width, len(rows) height)."""
    indptr = np.asarray(Ah.indptr, dtype=np.int64)
    starts, lens = indptr[rows], indptr[rows + 1] - indptr[rows]
    nnz = int(lens.sum())
    new_iptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum(lens, out=new_iptr[1:])
    pos = np.arange(nnz, dtype=np.int64)
    rof = np.repeat(np.arange(len(rows), dtype=np.int64), lens)
    src = starts[rof] + (pos - new_iptr[rof])
    return CSR(
        data=np.asarray(Ah.data)[src],
        indices=np.asarray(Ah.indices, np.int32)[src],
        indptr=new_iptr,
        shape=(len(rows), Ah.shape[1]),
        nnz=nnz,
    )
