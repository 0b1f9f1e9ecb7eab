"""Speed-of-light models for every kernel (HBM bytes / peak FLOPs).

Each op gets an analytic lower bound on runtime from (a) unavoidable HBM
traffic at peak bandwidth and (b) FLOPs at peak compute.  Sparse kernels at
web-graph densities are bandwidth-bound, so the HBM term dominates; the
achieved/SoL ratio is the headline efficiency.

Peaks come from one table keyed by the device's ``device_kind``; a device
that is not in the table is an error, not a default.  A second,
algorithm-aware bound (:class:`MeasuredRates`) charges each kernel's
irreducible primitives at rates measured on the running device by
``benchmarks/primitives.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_gbps: float  #: HBM bandwidth, GB/s
    flops_f32: float  #: peak fp32 FLOP/s outside the tensor cores
    flops_tf32: float  #: peak dense TF32 tensor-core FLOP/s
    flops_bf16: float  #: peak dense bf16 tensor-core FLOP/s
    source: str


#: published peaks by ``jax.Device.device_kind``
PEAKS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "H100 SXM", hbm_gbps=3350.0, flops_f32=67e12, flops_tf32=495e12,
        flops_bf16=989e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates at 700 W",
    ),
}


def chip_spec(device_kind: str) -> ChipSpec:
    """Peak rates of ``device_kind``; raises for a device not in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no peak rates for device kind {device_kind!r}: add its published "
            "peaks to spmm_tpu.ops.roofline.PEAKS"
        ) from None


def detect_chip() -> ChipSpec:
    import jax

    return chip_spec(jax.devices()[0].device_kind)


@dataclasses.dataclass(frozen=True)
class Roofline:
    flops: float
    hbm_bytes: float
    chip: ChipSpec

    @property
    def t_bandwidth_s(self) -> float:
        return self.hbm_bytes / (self.chip.hbm_gbps * 1e9)

    @property
    def t_compute_s(self) -> float:
        return self.flops / self.chip.flops_f32

    @property
    def t_sol_s(self) -> float:
        return max(self.t_bandwidth_s, self.t_compute_s)

    def efficiency(self, measured_s: float) -> float:
        return self.t_sol_s / max(measured_s, 1e-12)


def spmm_roofline(nnz: int, m: int, n: int, k: int, *, bytes_val=4, bytes_idx=4,
                  b_reuse: float = 1.0, chip: ChipSpec | None = None) -> Roofline:
    """A(m×n, nnz) @ B(n×k).  ``b_reuse``: average times each touched B row is
    re-read from HBM (1.0 = perfect panel caching; nnz/distinct-cols = none)."""
    chip = chip or detect_chip()
    flops = 2.0 * nnz * k
    distinct = min(nnz, n)
    bytes_ = (
        nnz * (bytes_val + bytes_idx)  # A
        + distinct * k * bytes_val * b_reuse  # B panels
        + m * k * bytes_val  # Y
    )
    return Roofline(flops=flops, hbm_bytes=bytes_, chip=chip)


def spmv_roofline(nnz: int, m: int, n: int, **kw) -> Roofline:
    return spmm_roofline(nnz, m, n, 1, **kw)


@dataclasses.dataclass(frozen=True)
class MeasuredRates:
    """Primitive rates measured on one device (``benchmarks/primitives.py
    --json``) — the second, ALGORITHM-AWARE bound.  The analytic Roofline
    assumes peak-HBM streaming; kernels built on random gathers, scatters
    and sorts cannot beat those primitives' measured rates however well
    they stream.  The ``*_attainable`` bounds below count each kernel's
    irreducible primitive invocations at these rates.

    There are no default rates: :meth:`load` reads the calibration file and
    refuses one captured on another ``device_kind``.

    Caveat on ``att_frac > 1``: the gather calibration uses UNIFORM-RANDOM
    indices — the true worst case.  A kernel whose access stream has
    locality can beat the uniform-random rate, so fractions slightly above
    1 mean "at or past the random-gather wall", not a measurement error."""

    device_kind: str
    row_gather_rows_s: float  # aligned 2-D row gather, any width
    scatter_elems_s: float  # segment_sum / .at[] set
    scalar_gather_s: float  # x[idx]
    sort_batched_s: float  # minor-axis lax.sort, best width
    sort_global_s: float  # 1-D lax.sort
    elementwise_gbs: float  # fused elementwise passes, bytes/s
    #: batched-sort rate vs slab WIDTH: ((L, elems_s), ...); the warm/chain
    #: bounds charge each chunk at its own width's rate
    sort_batched_curve: tuple = ()
    #: row-gather rate vs TABLE size: ((table_bytes, rows_s), ...)
    row_gather_curve: tuple = ()
    #: the same measured with NARROW (32 B) rows; bounds on genuinely narrow
    #: tables (the (nrowB, 2) geometry lookup) use it
    row_gather_narrow_curve: tuple = ()

    @staticmethod
    def _interp(curve, x: float) -> float:
        """Log-log interpolation of ((x, rate), ...), clamped at the ends."""
        import math

        pts = sorted((float(a), float(r)) for a, r in curve)
        if x <= pts[0][0]:
            return pts[0][1]
        if x >= pts[-1][0]:
            return pts[-1][1]
        lx = math.log(x)
        for (a0, r0), (a1, r1) in zip(pts, pts[1:]):
            if x <= a1:
                f = (lx - math.log(a0)) / (math.log(a1) - math.log(a0))
                return math.exp((1 - f) * math.log(r0) + f * math.log(r1))
        return pts[-1][1]

    def sort_rate(self, width: float | None = None) -> float:
        """Width-matched batched-sort rate; the best-width scalar when no
        curve was captured."""
        if not width or not self.sort_batched_curve:
            return self.sort_batched_s
        return self._interp(self.sort_batched_curve, width)

    def row_gather_rate(self, table_bytes: float | None = None,
                        row_bytes: float | None = None) -> float:
        """Size-matched row-gather rate; ``row_bytes`` <= 64 selects the
        narrow-row curve when available."""
        curve = self.row_gather_curve
        if row_bytes is not None and row_bytes <= 64 and self.row_gather_narrow_curve:
            curve = self.row_gather_narrow_curve
        if not table_bytes or not curve:
            return self.row_gather_rows_s
        return self._interp(curve, table_bytes)

    @staticmethod
    def calibration_path() -> str:
        import os

        return os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "primitive_rates.json",
        )

    @classmethod
    def load(cls, device_kind: str | None = None) -> "MeasuredRates":
        """Rates from the calibration file; raises unless it exists and was
        captured on ``device_kind`` (default: the running device)."""
        import json

        if device_kind is None:
            import jax

            device_kind = jax.devices()[0].device_kind
        p = cls.calibration_path()
        try:
            with open(p) as f:
                raw = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(
                f"no primitive-rate calibration at {p}: run "
                "benchmarks/primitives.py --json on the device"
            ) from None
        if raw.get("_device") != device_kind:
            raise ValueError(
                f"{p} was captured on {raw.get('_device')!r}, not {device_kind!r}"
            )
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {"device_kind": device_kind}
        for k, v in raw.items():
            if k not in fields or k == "device_kind":
                continue
            if k.endswith("_curve"):
                kw[k] = tuple((float(b), float(r)) for b, r in v)
            else:
                kw[k] = float(v)
        return cls(**kw)


def spmm_attainable(nnz_padded_rows: int, m: int, k: int, rates: MeasuredRates,
                    *, table_bytes: float | None = None) -> float:
    """Attainable seconds for gather-formulated SpMM: one B-row gather per
    (padded) nonzero + streaming the (m, k) output.  ``table_bytes``: size
    of the gathered B panel (n*k*4)."""
    return nnz_padded_rows / rates.row_gather_rate(table_bytes, row_bytes=k * 4) + (
        2.0 * m * k * 4
    ) / rates.elementwise_gbs


def spmv_attainable(nnz_padded: int, rates: MeasuredRates) -> float:
    """Attainable seconds for gather-formulated SpMV: one scalar x-gather
    per (padded) nonzero."""
    return nnz_padded / rates.scalar_gather_s


def _sort_seconds(rates: MeasuredRates, slots: int, chunk_slots) -> float:
    """Two batched sorts over the padded slots (expansion sort + merge
    compaction), each chunk at its width-matched rate when given."""
    if chunk_slots:
        return 2.0 * sum(s / rates.sort_rate(L) for L, s in chunk_slots)
    return 2.0 * slots / rates.sort_batched_s


def spgemm_attainable(npa: int, slots: int, nnz_b: int, rates: MeasuredRates,
                      nnz_a: int | None = None,
                      *, nrow_b: int | None = None,
                      b2_table_bytes: float | None = None,
                      geom_table_bytes: float | None = None,
                      b2_row_bytes: float = 512.0,
                      geom_row_bytes: float = 8.0,
                      out_nnz: int | None = None,
                      chunk_slots=None) -> float:
    """Attainable seconds for the irreducible primitive set of the cold
    slab-ESC multiply, each term at its measured (size-matched) rate:

    - one segment-table row gather per pa, from the B2 table;
    - one B-row-geometry row gather per A nonzero, from the (nrowB, 2)
      table (narrow rows);
    - three scatters: nnz(B) elements building the aligned B2 table, nnz(A)
      elements materializing the pa step function, and nrow(B) row-start
      deltas for the B2 pad-offset step;
    - the expansion sort and the merge-compaction sort over the slots;
    - the stream traffic: the pa channel table written once (4 B/pa) and the
      merged output written once (8 B/out-nnz).

    Mask/iota/run-detection elementwise passes are excluded, so the bound is
    a lower envelope for this algorithm class."""
    if nnz_a is None:
        nnz_a = nnz_b  # the A x A reference workload
    stream_bytes = 4.0 * npa + (8.0 * out_nnz if out_nnz else 0.0)
    return (
        npa / rates.row_gather_rate(b2_table_bytes, row_bytes=b2_row_bytes)
        + nnz_a / rates.row_gather_rate(geom_table_bytes, row_bytes=geom_row_bytes)
        + _sort_seconds(rates, slots, chunk_slots)
        + (nnz_b + nnz_a + (nrow_b or 0)) / rates.scatter_elems_s
        + stream_bytes / rates.elementwise_gbs
    )


def spgemm_warm_attainable(slots: int, out_nnz: int, rates: MeasuredRates,
                           *, chunk_slots=None) -> float:
    """Attainable seconds for the ALIGNED numeric phase (plan-reuse warm
    path): the gather half ran at plan time, so what remains is the two
    batched sorts over the cached slots and one read of the aligned cache +
    one write of the merged output."""
    stream_bytes = 4.0 * slots + 8.0 * out_nnz
    return _sort_seconds(rates, slots, chunk_slots) + stream_bytes / rates.elementwise_gbs


def spgemm_roofline(expand: int, nnz_a: int, nnz_b: int, nnz_out: int, *,
                    bytes_val=4, bytes_idx=4, chip: ChipSpec | None = None) -> Roofline:
    """ESC SpGEMM: ``expand`` partial products (= FLOPs/2).

    Problem-intrinsic HBM bound (algorithm-independent): read A and B once,
    materialize + re-read the expanded (col, val) stream once each way (any
    ESC formulation moves at least the 8 B/slot expansion through HBM twice),
    write C once.  Deliberately does NOT model the sort algorithm's own
    passes — the kernel must earn them."""
    chip = chip or detect_chip()
    flops = 2.0 * expand
    slot_bytes = bytes_idx + bytes_val
    bytes_ = (
        nnz_a * (bytes_val + bytes_idx)
        + nnz_b * (bytes_val + bytes_idx)
        + expand * slot_bytes * 2
        + nnz_out * (bytes_val + 2 * bytes_idx)
    )
    return Roofline(flops=flops, hbm_bytes=bytes_, chip=chip)
