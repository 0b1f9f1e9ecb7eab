from spmm_tpu.ops.spmm import spmm, spmv, spmm_xla, spmv_xla
from spmm_tpu.ops.spgemm import spgemm_sorted, spgemm_coo_padded, spgemm_expand_bound
from spmm_tpu.ops.slab_spgemm import (
    spgemm_slab,
    spgemm_slab_device,
    spgemm_plan,
    spgemm_plan_revalue,
    spgemm_slab_csr,
)

# the slab-sorted ESC kernel is the production SpGEMM (batched minor-axis
# sorts instead of one global sort); spgemm_sorted remains as the
# fallback/oracle and handles the heavy-tail rows
spgemm = spgemm_slab
from spmm_tpu.ops.ell_spmm import ell_spmm, ell_spmv
from spmm_tpu.ops.pallas_bsr import bsr_spmm, bsr_spmm_pallas, bsr_spmm_xla, bsr_spmv
from spmm_tpu.ops.blocked import (
    blocked_chain_spmv,
    blocked_panel_view,
    blocked_slab_view,
    blocked_spmm_panel,
    blocked_spmm_slab,
    blocked_spmm_xla,
)
from spmm_tpu.ops.roofline import spmm_roofline, spmv_roofline, spgemm_roofline, ChipSpec
from spmm_tpu.ops.segments import boundary_segments
from spmm_tpu.ops.sddmm import sddmm, sddmm_values
from spmm_tpu.ops.transform import (
    transpose,
    add,
    diagonal,
    row_sums,
    col_sums,
    scale_rows,
    scale_cols,
)

__all__ = [
    "spmm",
    "spmv",
    "spmm_xla",
    "spmv_xla",
    "spgemm",
    "spgemm_sorted",
    "spgemm_slab",
    "spgemm_slab_device",
    "spgemm_slab_csr",
    "spgemm_plan",
    "spgemm_plan_revalue",
    "spgemm_coo_padded",
    "spgemm_expand_bound",
    "ell_spmm",
    "ell_spmv",
    "bsr_spmm",
    "bsr_spmm_pallas",
    "bsr_spmv",
    "bsr_spmm_xla",
    "blocked_chain_spmv",
    "blocked_panel_view",
    "blocked_spmm_panel",
    "blocked_slab_view",
    "blocked_spmm_slab",
    "blocked_spmm_xla",
    "spmm_roofline",
    "spmv_roofline",
    "spgemm_roofline",
    "ChipSpec",
    "boundary_segments",
    "sddmm",
    "sddmm_values",
    "transpose",
    "add",
    "diagonal",
    "row_sums",
    "col_sums",
    "scale_rows",
    "scale_cols",
]
