"""Pass 3a/3b — panelization and per-panel row sort with v8 grouping.

Redesign of the reference's panel layer
(reference: gen_panel_list v8sort.h:49-73; panel_sort_nnz v8sort.h:152-232).

- Panelization: within a region, aim for ``rows/panel_rows + 1`` panels,
  balanced by nnz, boundaries aligned to the 8-row group width (the
  reference advances in steps of 8).
- Panel sort: rows sorted ascending by length (stable — the reference's
  argsort is unstable, an implementation accident not worth copying); rows
  sharing (panel, length) with length in (0, max_len] are grouped 8 at a
  time into "v8" vector groups; the ``count % 8`` leftovers and rows longer
  than ``max_len`` form the panel's ``remain`` tail, like the reference's
  concat(order, remain) layout (v8sort.h:213-220).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from spmm_tpu.formats.containers import CSR


def panelize(
    row_lengths: np.ndarray, region_bounds: np.ndarray, panel_rows: int = 2048, align: int = 8
) -> np.ndarray:
    """nnz-balanced, 8-row-aligned panel boundaries for every region.

    Returns global panel row boundaries (int64, ascending, deduped) covering
    [0, nrow]; every region boundary is also a panel boundary.
    """
    bounds_out = [np.asarray([0], dtype=np.int64)]
    lens = np.asarray(row_lengths, dtype=np.int64)
    for s, t in zip(region_bounds[:-1], region_bounds[1:]):
        rows = int(t - s)
        if rows <= 0:
            continue
        npanels = rows // panel_rows + 1
        cum = np.concatenate([[0], np.cumsum(lens[s:t])])
        total = cum[-1]
        targets = (np.arange(1, npanels, dtype=np.int64) * total) // npanels
        cutpos = np.searchsorted(cum, targets, side="left")
        cutpos = (cutpos // align) * align  # 8-row alignment (reference v8sort.h:64)
        cuts = np.unique(np.concatenate([cutpos[(cutpos > 0) & (cutpos < rows)], [rows]]))
        bounds_out.append(np.asarray(s) + cuts)
    return np.unique(np.concatenate(bounds_out)).astype(np.int64)


class PanelSortResult(NamedTuple):
    #: permutation local to the pre-sort order: perm[new_pos] = pre_sort_row
    perm: np.ndarray
    #: per-row panel id (in final order)
    panel_of_row: np.ndarray
    #: group table: first final-row index of each 8-row group
    group_row: np.ndarray
    #: group table: per-row length L of each group
    group_len: np.ndarray
    #: per final row: True if the row belongs to a v8 group
    is_grouped: np.ndarray


def panel_sort(
    row_lengths: np.ndarray,
    panel_bounds: np.ndarray,
    *,
    group_width: int = 8,
    max_len: int = 32,
) -> PanelSortResult:
    """Sort rows within each panel by (groupable?, length, position); emit the
    v8 group table.  Fully vectorized (one lexsort over all rows)."""
    lens = np.asarray(row_lengths, dtype=np.int64)
    nrow = len(lens)
    panel_of = (
        np.searchsorted(panel_bounds, np.arange(nrow, dtype=np.int64), side="right") - 1
    )

    groupable = (lens > 0) & (lens <= max_len)
    # rank of each row within its (panel, len) bucket, in position order.
    # composite small-int key + stable argsort == radix sort, ~5x faster than
    # the equivalent lexsort at ~1M rows.
    lmax = int(lens.max()) + 2 if nrow else 2
    order_plb = np.argsort(panel_of * lmax + lens, kind="stable")
    sorted_panel = panel_of[order_plb]
    sorted_len = lens[order_plb]
    bucket_change = np.concatenate(
        [[True], (sorted_panel[1:] != sorted_panel[:-1]) | (sorted_len[1:] != sorted_len[:-1])]
    )
    bucket_id = np.cumsum(bucket_change) - 1
    bucket_start = np.zeros(bucket_id[-1] + 1 if nrow else 0, dtype=np.int64)
    if nrow:
        starts = np.nonzero(bucket_change)[0]
        bucket_start[:] = starts
    rank_sorted = np.arange(nrow, dtype=np.int64) - bucket_start[bucket_id]
    bucket_count = np.zeros_like(bucket_start)
    if nrow:
        counts = np.diff(np.concatenate([starts, [nrow]]))
        bucket_count[:] = counts
    cnt_sorted = bucket_count[bucket_id]
    in_group_sorted = (
        groupable[order_plb]
        & (rank_sorted < (cnt_sorted // group_width) * group_width)
    )
    # scatter back to row order
    rank = np.empty(nrow, dtype=np.int64)
    rank[order_plb] = rank_sorted
    in_group = np.zeros(nrow, dtype=bool)
    in_group[order_plb] = in_group_sorted

    # final order within panel: v8 rows first (by len, pos), then remain (by len, pos)
    perm = np.argsort((panel_of * 2 + (~in_group)) * lmax + lens, kind="stable")

    # group table: every 8-aligned run of grouped rows in final order
    g_final = in_group[perm]
    lens_final = lens[perm]
    grouped_pos = np.nonzero(g_final)[0]
    firsts = grouped_pos[::group_width] if grouped_pos.size else grouped_pos
    group_row = firsts.astype(np.int64)
    group_len = lens_final[firsts] if firsts.size else np.zeros(0, np.int64)
    return PanelSortResult(
        perm=perm.astype(np.int64),
        panel_of_row=panel_of[perm],
        group_row=group_row,
        group_len=group_len,
        is_grouped=g_final,
    )
