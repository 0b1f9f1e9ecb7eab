// Native host preprocessing passes (the sequential/hash-bound pieces).
//
// Host components replacing the reference's serial scans with
// equivalent-but-correct implementations (cited per function):
//  - region_split: first-touch distinct-column budget scan
//    (reference: PreProcessing/transmat.h:334-376)
//  - relabel_first_touch: per-region first-touch column relabeling
//    (reference: PreProcessing/serial_newblock_clock.cpp:187-204)
//  - dominant_sections: per-row dominant column section
//    (reference intent: PreProcessing/bitmap.h:108-146; see SURVEY.md §2.3)
//
// All are O(nnz) single passes using version-stamped scratch arrays (no
// per-region clears), which is why they beat the numpy sort-based fallbacks.
//
// Build: part of libspmm_native.so (see build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>

// First-touch scans use a 1-bit-per-column bitset carved out of the caller's
// int32 scratch (ncol*4 bytes >= ncol/8 bytes always).  The bitset for a
// ~1M-column matrix is ~128 KB — L2-resident — where the int32 stamp array it
// replaces is ~4 MB of random-access misses; clearing it per region is a
// sequential memset, amortized O(ncol/64) per region.
static inline uint64_t* bitset_of(int* scratch) {
  return reinterpret_cast<uint64_t*>(scratch);
}
static inline long long bitset_words(long long ncol) { return (ncol + 63) >> 6; }
static inline bool test_and_set(uint64_t* bits, long long c) {
  uint64_t w = bits[c >> 6], m = 1ull << (c & 63);
  if (w & m) return true;
  bits[c >> 6] = w | m;
  return false;
}

extern "C" {

// Scan rows in order; close a region once the count of distinct columns since
// the region began reaches `budget` (close AFTER the triggering row).
// `stamp` is caller-provided scratch of size ncol int32 (any contents).
// Writes region row boundaries (excluding leading 0) to `bounds_out`;
// returns the number of boundaries written (== number of regions).
long long region_split(const long long* indptr, const int* cols, long long nrow,
                       long long ncol, long long budget, int* stamp,
                       long long* bounds_out) {
  uint64_t* bits = bitset_of(stamp);
  const long long nw = bitset_words(ncol);
  std::memset(bits, 0, nw * 8);
  long long nb = 0;
  long long distinct = 0;
  for (long long r = 0; r < nrow; ++r) {
    for (long long p = indptr[r]; p < indptr[r + 1]; ++p) {
      distinct += !test_and_set(bits, cols[p]);
    }
    if (distinct >= budget) {
      bounds_out[nb++] = r + 1;
      distinct = 0;
      std::memset(bits, 0, nw * 8);
    }
  }
  if (nb == 0 || bounds_out[nb - 1] != nrow) bounds_out[nb++] = nrow;
  return nb;
}

// Fused permutation algebra (reference wbsort.h:16-34,58-67): compose the
// two row permutations, invert, and build the final-order CSR indptr in ONE
// O(nrow) pass (replaces four numpy gather/scatter/cumsum passes).
//   perm1  (nrow) i64: bitmap-reorder permutation (pos -> original row)
//   perm3  (nrow) i64: panel-sort permutation (final pos -> bitmap pos)
// Outputs: row_perm32[f] = original row at final position f,
//          row_inv32[orig] = final position, indptr_final (nrow+1).
void perm_algebra(const long long* perm1, const long long* perm3,
                  const long long* orig_indptr, long long nrow,
                  int* row_perm32, int* row_inv32, long long* indptr_final) {
  long long acc = 0;
  indptr_final[0] = 0;
  for (long long f = 0; f < nrow; ++f) {
    if (f + 8 < nrow) __builtin_prefetch(&perm1[perm3[f + 8]]);
    long long orig = perm1[perm3[f]];
    row_perm32[f] = (int)orig;
    row_inv32[orig] = (int)f;
    acc += orig_indptr[orig + 1] - orig_indptr[orig];
    indptr_final[f + 1] = acc;
  }
}

// Same scan but visiting rows in permuted order (row_perm[r] = original row),
// so the reordered matrix never needs materializing before the split.
long long region_split_permuted(const long long* indptr, const int* cols,
                                const long long* row_perm, long long nrow,
                                long long ncol, long long budget, int* stamp,
                                long long* bounds_out) {
  uint64_t* bits = bitset_of(stamp);
  const long long nw = bitset_words(ncol);
  std::memset(bits, 0, nw * 8);
  long long nb = 0;
  long long distinct = 0;
  for (long long r = 0; r < nrow; ++r) {
    // two-stage software pipeline over the dependent loads: warm the
    // indptr entry of the row 16 ahead, then the column segment of the row
    // 8 ahead (whose indptr entry the previous stage already pulled in)
    if (r + 16 < nrow) __builtin_prefetch(&indptr[row_perm[r + 16]]);
    if (r + 8 < nrow) __builtin_prefetch(&cols[indptr[row_perm[r + 8]]]);
    long long orig = row_perm[r];
    for (long long p = indptr[orig]; p < indptr[orig + 1]; ++p) {
      distinct += !test_and_set(bits, cols[p]);
    }
    if (distinct >= budget) {
      bounds_out[nb++] = r + 1;
      distinct = 0;
      std::memset(bits, 0, nw * 8);
    }
  }
  if (nb == 0 || bounds_out[nb - 1] != nrow) bounds_out[nb++] = nrow;
  return nb;
}

// Per-region first-touch relabel of the packed column stream.
//  cols:        packed column ids (region-concatenated), length nnz
//  region_nnz:  region boundaries in the packed stream, length nregions+1
//  map/mapstamp: caller scratch of size ncol
// Outputs:
//  codes_out:   region-local relabeled id per nonzero        (len nnz)
//  gather_out:  original column per relabel slot, region-major (len <= nnz)
//  region_counts_out: distinct columns per region            (len nregions)
// Returns total number of distinct (region, col) slots.
long long relabel_first_touch(const int* cols, long long nnz,
                              const long long* region_nnz, long long nregions,
                              long long ncol, int* map, int* mapstamp,
                              int* codes_out, int* gather_out,
                              long long* region_counts_out) {
  uint64_t* bits = bitset_of(mapstamp);
  const long long nw = bitset_words(ncol);
  std::memset(bits, 0, nw * 8);
  long long total = 0;
  for (long long reg = 0; reg < nregions; ++reg) {
    long long lo = region_nnz[reg], hi = region_nnz[reg + 1];
    int next = 0;
    for (long long p = lo; p < hi; ++p) {
      int c = cols[p];
      if (!test_and_set(bits, c)) {
        map[c] = next;
        gather_out[total + next] = c;
        ++next;
      }
      codes_out[p] = map[c];
    }
    region_counts_out[reg] = next;
    total += next;
    if (reg + 1 < nregions) std::memset(bits, 0, nw * 8);
  }
  return total;
}

// Fused pack: gather nonzeros into final row order, 8-row interleave v8
// groups, and relabel columns per region in first-touch order — one pass.
// (reference equivalents: row gather serial_newblock_clock.cpp:339-360,
//  v8 interleave :366-399, relabel :187-204; fused here because each is a
//  separate O(nnz) numpy pass otherwise.)
//
//  indptr_orig  (nrow+1) int64   original CSR
//  indices      (nnz)    int32
//  data         (nnz*esz) bytes  values (any element size esz)
//  row_perm     (nrow)   int64   final_pos -> original row
//  indptr_final (nrow+1) int64   CSR indptr in final order
//  row_group    (nrow)   int32   group id per final row, -1 if ungrouped
//  region_bounds(nregions+1) int64  region row boundaries (final order)
//  map/mapstamp (ncol)   int32   scratch
// Outputs: packed data bytes, cols_local, gather_cols, region_counts.
// Returns total distinct (region, col) slots.
}  // extern "C"  (resumed below — the pack kernel is a template)

// Value copies are specialized on the element size (T = byte/4-byte/8-byte
// word; values are bit-copied, so only the width matters) — a runtime-esz
// memcpy in the inner loop defeats vectorized codegen.  Per-group source
// bases are hoisted out of the element loop (the reference recomputes the
// row base per element, serial_newblock_clock.cpp:366-385).
template <typename T>
static long long pack_blocked_impl(
    const long long* indptr_orig, const int* indices, const T* data,
    long long nrow, long long ncol, const int* row_perm,
    const long long* indptr_final, const int* row_group,
    const long long* region_bounds, long long nregions, int* map,
    int* mapstamp, T* packed_data, int* cols_local, int* gather_out,
    long long* region_counts_out) {
  uint64_t* bits = bitset_of(mapstamp);
  const long long nw = bitset_words(ncol);
  std::memset(bits, 0, nw * 8);
  long long total = 0;
  long long r = 0;
  for (long long reg = 0; reg < nregions; ++reg) {
    long long row_end = region_bounds[reg + 1];
    int next = 0;
    while (r < row_end) {
      long long base = indptr_final[r];
      if (row_group[r] >= 0) {
        // 8 consecutive equal-length rows, element-major interleave:
        // slot base + 8*e + rr holds element e of group-row rr.
        // Traversal is in SLOT order (element-major) so the first-touch
        // relabel order matches the packed stream, as the contract requires.
        long long L = indptr_final[r + 1] - indptr_final[r];
        long long sb[8];
        for (long long rr = 0; rr < 8; ++rr) sb[rr] = indptr_orig[row_perm[r + rr]];
        // two-stage prefetch pipeline: row_perm is sequential, but
        // indptr_orig[perm] and the source segments are random — warm the
        // next group's 8 source streams and the group-after-next's indptr
        for (long long rr = 0; rr < 8 && r + 16 + rr < nrow; ++rr)
          __builtin_prefetch(&indptr_orig[row_perm[r + 16 + rr]]);
        for (long long rr = 0; rr < 8 && r + 8 + rr < nrow; ++rr) {
          long long s = indptr_orig[row_perm[r + 8 + rr]];
          __builtin_prefetch(&indices[s]);
          __builtin_prefetch(&data[s]);
        }
        T* pd = packed_data + base;
        int* cl = cols_local + base;
        for (long long e = 0; e < L; ++e) {
          for (long long rr = 0; rr < 8; ++rr) {
            long long src = sb[rr] + e;
            int c = indices[src];
            if (!test_and_set(bits, c)) {
              map[c] = next;
              gather_out[total + next] = c;
              ++next;
            }
            cl[8 * e + rr] = map[c];
            pd[8 * e + rr] = data[src];
          }
        }
        r += 8;
      } else {
        if (r + 16 < nrow) __builtin_prefetch(&indptr_orig[row_perm[r + 16]]);
        if (r + 8 < nrow) {
          long long s = indptr_orig[row_perm[r + 8]];
          __builtin_prefetch(&indices[s]);
          __builtin_prefetch(&data[s]);
        }
        long long src0 = indptr_orig[row_perm[r]];
        long long L = indptr_final[r + 1] - indptr_final[r];
        T* pd = packed_data + base;
        int* cl = cols_local + base;
        for (long long e = 0; e < L; ++e) {
          int c = indices[src0 + e];
          if (!test_and_set(bits, c)) {
            map[c] = next;
            gather_out[total + next] = c;
            ++next;
          }
          cl[e] = map[c];
          pd[e] = data[src0 + e];
        }
        r += 1;
      }
    }
    region_counts_out[reg] = next;
    total += next;
    if (reg + 1 < nregions) std::memset(bits, 0, nw * 8);
  }
  return total;
}

extern "C" {

long long pack_blocked(const long long* indptr_orig, const int* indices,
                       const char* data, long long esz, long long nrow,
                       long long ncol, const int* row_perm,
                       const long long* indptr_final, const int* row_group,
                       const long long* region_bounds, long long nregions,
                       int* map, int* mapstamp, char* packed_data,
                       int* cols_local, int* gather_out,
                       long long* region_counts_out) {
  switch (esz) {
    case 4:
      return pack_blocked_impl<uint32_t>(
          indptr_orig, indices, reinterpret_cast<const uint32_t*>(data), nrow,
          ncol, row_perm, indptr_final, row_group, region_bounds, nregions,
          map, mapstamp, reinterpret_cast<uint32_t*>(packed_data), cols_local,
          gather_out, region_counts_out);
    case 8:
      return pack_blocked_impl<uint64_t>(
          indptr_orig, indices, reinterpret_cast<const uint64_t*>(data), nrow,
          ncol, row_perm, indptr_final, row_group, region_bounds, nregions,
          map, mapstamp, reinterpret_cast<uint64_t*>(packed_data), cols_local,
          gather_out, region_counts_out);
    case 2:
      return pack_blocked_impl<uint16_t>(
          indptr_orig, indices, reinterpret_cast<const uint16_t*>(data), nrow,
          ncol, row_perm, indptr_final, row_group, region_bounds, nregions,
          map, mapstamp, reinterpret_cast<uint16_t*>(packed_data), cols_local,
          gather_out, region_counts_out);
    case 1:
      return pack_blocked_impl<uint8_t>(
          indptr_orig, indices, reinterpret_cast<const uint8_t*>(data), nrow,
          ncol, row_perm, indptr_final, row_group, region_bounds, nregions,
          map, mapstamp, reinterpret_cast<uint8_t*>(packed_data), cols_local,
          gather_out, region_counts_out);
    case 16: {  // complex128 / 16-byte PODs
      struct W16 { uint64_t a, b; };
      return pack_blocked_impl<W16>(
          indptr_orig, indices, reinterpret_cast<const W16*>(data), nrow,
          ncol, row_perm, indptr_final, row_group, region_bounds, nregions,
          map, mapstamp, reinterpret_cast<W16*>(packed_data), cols_local,
          gather_out, region_counts_out);
    }
    default:
      return -1;  // wrapper falls back to the numpy path
  }
}

// Pass 3b — per-panel row sort by length + v8 grouping, one O(rows) pass.
// (reference: panel_sort_nnz v8sort.h:152-232 — argsort per panel there;
//  counting sort here since groupable lengths are bounded by max_len and
//  longer "remain" rows only need a small per-panel comparison sort.)
//
//  lens          (nrow)       row lengths (pre-sort order)
//  panel_bounds  (npanels+1)  ascending row boundaries covering [0, nrow]
//  group_width   W (8)        rows per vector group
//  max_len       groupable length cap (reference: 32)
// Outputs:
//  perm_out      (nrow)   perm[new_pos] = pre_sort row
//  grouped_out   (nrow)   1 if the row at final position is in a v8 group
//  group_row_out (<=nrow/W) first final-row index of each group
//  group_len_out (same)   per-row length L of each group
//  row_group_out (nrow)   group id per final row, -1 if ungrouped
// Returns the number of groups.
long long panel_sort(const long long* lens, long long nrow,
                     const long long* panel_bounds, long long npanels,
                     long long group_width, long long max_len,
                     long long* perm_out, unsigned char* grouped_out,
                     long long* group_row_out, long long* group_len_out,
                     long long* row_group_out) {
  const long long W = group_width;
  long long ngroups = 0;
  // scratch: counting bins for lengths 0..max_len
  long long* cnt = new long long[max_len + 1];
  long long* base = new long long[max_len + 1];
  long long* seen = new long long[max_len + 1];
  long long remain_cap = 0;
  long long* remain = nullptr;  // (len, pos) pairs for comparison sort

  for (long long pi = 0; pi < npanels; ++pi) {
    long long s = panel_bounds[pi], t = panel_bounds[pi + 1];
    long long rows = t - s;
    if (rows <= 0) continue;
    for (long long l = 0; l <= max_len; ++l) cnt[l] = 0;
    for (long long r = s; r < t; ++r) {
      long long L = lens[r];
      if (L > 0 && L <= max_len) ++cnt[L];
    }
    // grouped rows per length = count rounded down to a multiple of W;
    // they occupy the front of the panel ordered by (len, position)
    long long g_total = 0;
    for (long long l = 1; l <= max_len; ++l) {
      long long g = cnt[l] - cnt[l] % W;
      base[l] = g_total;
      seen[l] = 0;
      g_total += g;
    }
    // place grouped rows (counting sort, stable by construction)
    long long nrem = 0;
    if (rows > remain_cap) {
      delete[] remain;
      remain_cap = rows;
      remain = new long long[2 * remain_cap];
    }
    for (long long r = s; r < t; ++r) {
      long long L = lens[r];
      bool g = false;
      if (L > 0 && L <= max_len) {
        long long gcap = cnt[L] - cnt[L] % W;
        if (seen[L] < gcap) {
          long long pos = s + base[L] + seen[L];
          perm_out[pos] = r;
          grouped_out[pos] = 1;
          ++seen[L];
          g = true;
        }
      }
      if (!g) {
        remain[2 * nrem] = L;
        remain[2 * nrem + 1] = r;
        ++nrem;
      }
    }
    // remain rows: comparison sort by (len, position) — strict order, so
    // the position tiebreak makes it deterministic/stable
    {
      struct Pair { long long l, p; };
      Pair* pr = reinterpret_cast<Pair*>(remain);
      // insertion-friendly sizes are common; std::sort handles the rest
      std::sort(pr, pr + nrem, [](const Pair& a, const Pair& b) {
        return a.l != b.l ? a.l < b.l : a.p < b.p;
      });
      for (long long i = 0; i < nrem; ++i) {
        long long pos = s + g_total + i;
        perm_out[pos] = pr[i].p;
        grouped_out[pos] = 0;
        row_group_out[pos] = -1;
      }
    }
    // group table: every W consecutive grouped rows share a length
    for (long long k = 0; k + W <= g_total; k += W) {
      group_row_out[ngroups] = s + k;
      group_len_out[ngroups] = lens[perm_out[s + k]];
      for (long long r = 0; r < W; ++r) row_group_out[s + k + r] = ngroups;
      ++ngroups;
    }
  }
  delete[] cnt;
  delete[] base;
  delete[] seen;
  delete[] remain;
  return ngroups;
}

// SpGEMM slab-kernel sizing (ops/slab_spgemm.py): one O(nnz_A + nrow_B) pass
// computing, for C = A @ B with B rows split into width-W segments:
//   nsegB   = total B segments,
//   npa     = total (A-nonzero x B-segment) pairs,
//   cls_out = per-A-row expansion class (index into `classes`, ascending;
//             nclasses if above the last class, nclasses+1 if zero)
// Returns npa; *nsegB_out receives nsegB.  exp_pad per row = W * (pa count).
long long spgemm_sizing(const long long* a_indptr, const int* a_ind,
                        long long nrowA, const long long* b_indptr,
                        long long nrowB, long long W,
                        const long long* classes, long long nclasses,
                        int* cls_out, long long* nsegB_out) {
  // Per-B-row segment counts as a compact uint16 table: the per-a-nonzero
  // random access then touches 2 bytes in an L2-scale table instead of two
  // 8-byte indptr entries in an 8*nrowB one.  Counts >= 65535 (B rows with
  // > ~65534*W nonzeros) fall back to the exact indptr computation.
  uint16_t* nseg16 = new uint16_t[nrowB];
  long long nsegB = 0;
  for (long long j = 0; j < nrowB; ++j) {
    long long s = (b_indptr[j + 1] - b_indptr[j] + W - 1) / W;
    nsegB += s;
    nseg16[j] = s < 65535 ? (uint16_t)s : (uint16_t)65535;
  }
  *nsegB_out = nsegB;
  long long npa = 0;
  for (long long r = 0; r < nrowA; ++r) {
    long long pa = 0;
    for (long long p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      __builtin_prefetch(&nseg16[a_ind[p + 32 < a_indptr[nrowA] ? p + 32 : p]]);
      long long j = a_ind[p];
      long long s = nseg16[j];
      if (s == 65535) s = (b_indptr[j + 1] - b_indptr[j] + W - 1) / W;
      pa += s;
    }
    npa += pa;
    long long exp_pad = W * pa;
    if (exp_pad == 0) {
      cls_out[r] = (int)(nclasses + 1);
    } else {
      long long c = 0;
      while (c < nclasses && exp_pad > classes[c]) ++c;
      cls_out[r] = (int)c;
    }
  }
  delete[] nseg16;
  return npa;
}

// spgemm_sizing + the DEAD-RUN PATCH for the device plan's set-scatter step
// function (ops/slab_spgemm.py:_plan_body, patch!=None).  A "dead" A-nonzero
// points at an empty B row: it expands to nothing, but its delta in the
// step-function scatter collides with the following live nonzero's — which
// forces the ~1.6x slower add-scatter.  This pass emits one (position,
// -chan[previous live]) pair per dead RUN so the device can use unique-index
// set-scatters and restore the missing deltas with O(dead runs) adds.
// patch_pos/patch_val must hold >= nnz(A) entries; *npatch_out receives the
// count.  Everything else matches spgemm_sizing.
long long spgemm_sizing_patch(const long long* a_indptr, const int* a_ind,
                              long long nrowA, const long long* b_indptr,
                              long long nrowB, long long W,
                              const long long* classes, long long nclasses,
                              int* cls_out, long long* nsegB_out,
                              int* patch_pos, int* patch_val,
                              long long* npatch_out) {
  // uint8 table: web-scale graphs have median row lengths << 255*W, so the
  // per-nonzero random access touches a 1 B/row, L2-resident table (uint16
  // was 2 B/row; measured ~1.2x end to end on the 916K-row web-Google
  // synthetic).  Rare rows with >= 255 segments take the exact-indptr
  // fallback.
  uint8_t* nseg8 = new uint8_t[nrowB];
  long long* bseg_off = new long long[nrowB];
  long long nsegB = 0;
  for (long long j = 0; j < nrowB; ++j) {
    long long s = (b_indptr[j + 1] - b_indptr[j] + W - 1) / W;
    bseg_off[j] = nsegB;
    nsegB += s;
    nseg8[j] = s < 255 ? (uint8_t)s : (uint8_t)255;
  }
  *nsegB_out = nsegB;
  long long npa = 0;   // running pa counter == seg_off of the next nonzero
  // last live nonzero's (column, pa-before) — its chan value
  // bseg_off[j_live] - pa_live is computed LAZILY, only at a live->dead
  // edge (~dead-run count), so the hot loop touches just the 1 B/row
  // nseg8 table like the patchless pass (bseg_off per nonzero was a
  // second, 8 B random access and cost ~30% end to end)
  long long j_live = -1, pa_live = 0;
  long long k = 0;
  for (long long r = 0; r < nrowA; ++r) {
    long long row_pa0 = npa;
    for (long long p = a_indptr[r]; p < a_indptr[r + 1]; ++p) {
      __builtin_prefetch(&nseg8[a_ind[p + 32 < a_indptr[nrowA] ? p + 32 : p]]);
      long long j = a_ind[p];
      long long s = nseg8[j];
      if (s == 255) s = (b_indptr[j + 1] - b_indptr[j] + W - 1) / W;
      if (s > 0) {
        j_live = j;
        pa_live = npa;
        npa += s;
      } else if (j_live >= 0) {
        long long c_prev = bseg_off[j_live] - pa_live;
        if (c_prev != 0) {
          patch_pos[k] = (int)npa;
          patch_val[k] = (int)(-c_prev);
          ++k;
        }
        j_live = -1;  // chan is 0 through the rest of this dead run
      }
    }
    long long exp_pad = W * (npa - row_pa0);
    if (exp_pad == 0) {
      cls_out[r] = (int)(nclasses + 1);
    } else {
      long long c = 0;
      while (c < nclasses && exp_pad > classes[c]) ++c;
      cls_out[r] = (int)c;
    }
  }
  *npatch_out = k;
  delete[] nseg8;
  delete[] bseg_off;
  return npa;
}

// Stable counting argsort of small-integer keys in [0, nkeys):
// perm_out[new_pos] = old_pos.  O(n + nkeys); replaces numpy's O(n log n)
// stable argsort for bucket permutations (bitmap reorder: nkeys = sections+1).
void counting_argsort(const long long* keys, long long n, long long nkeys,
                      long long* perm_out) {
  long long* cnt = new long long[nkeys + 1]();
  for (long long i = 0; i < n; ++i) ++cnt[keys[i] + 1];
  for (long long k = 1; k <= nkeys; ++k) cnt[k] += cnt[k - 1];
  for (long long i = 0; i < n; ++i) perm_out[cnt[keys[i]]++] = i;
  delete[] cnt;
}

// int32-keys / int32-perm variant (skips the int64 astype copy the generic
// entry forces on int32 class vectors — ~5 ms at 916K rows).
void counting_argsort_i32(const int* keys, long long n, long long nkeys,
                          int* perm_out) {
  long long* cnt = new long long[nkeys + 1]();
  for (long long i = 0; i < n; ++i) ++cnt[keys[i] + 1];
  for (long long k = 1; k <= nkeys; ++k) cnt[k] += cnt[k - 1];
  for (long long i = 0; i < n; ++i) perm_out[cnt[keys[i]]++] = (int)i;
  delete[] cnt;
}

// Per-row dominant section: the section (col >> shift-free: col / sect) with
// the most nonzeros in the row; ties -> lowest section; empty row -> -1.
// Assumes column indices sorted within each row (CSR canonical form).
void dominant_sections(const long long* indptr, const int* cols, long long nrow,
                       long long sect_size, long long* dom_out) {
  // sect_size is a power of two in every shipped config (reference SECT=2048,
  // serial_newblock_clock.cpp:19) — a shift beats the per-nonzero division.
  const bool pow2 = sect_size > 0 && (sect_size & (sect_size - 1)) == 0;
  const int shift = pow2 ? __builtin_ctzll((unsigned long long)sect_size) : 0;
  for (long long r = 0; r < nrow; ++r) {
    long long best_cnt = 0, best_sect = -1;
    long long run_cnt = 0, run_sect = -1;
    for (long long p = indptr[r]; p < indptr[r + 1]; ++p) {
      long long s = pow2 ? (cols[p] >> shift) : (cols[p] / sect_size);
      if (s == run_sect) {
        ++run_cnt;
      } else {
        if (run_cnt > best_cnt) { best_cnt = run_cnt; best_sect = run_sect; }
        run_sect = s;
        run_cnt = 1;
      }
    }
    if (run_cnt > best_cnt) { best_cnt = run_cnt; best_sect = run_sect; }
    dom_out[r] = best_sect;
  }
}

// ELL slab fill: one memcpy+memset pass per row into a (R, L) slab pair —
// the ELL pack's hot loop (formats/ell.py).  numpy's broadcast-mask
// double fancy-index build of the same slabs costs ~5 passes over nnz plus
// an int64 widening of the column ids; this is a single streaming pass
// (~GB/s), which is what drops the web-Google auto-pack from ~260 ms to
// tens of ms.  dat/out_d are raw byte pointers with element size esz
// (4 = fp32, 8 = fp64); ptr/ln index the SOURCE CSR rows in slab order.
void ell_fill_slab(const char* dat, const int* ind, long long esz,
                   const long long* ptr, const long long* ln,
                   long long R, long long L,
                   char* out_d, int* out_c) {
  for (long long r = 0; r < R; ++r) {
    long long l = ln[r];
    if (l > L) l = L;
    if (l < 0) l = 0;  // defensive: a negative memcpy size is a heap stomp
    const long long p = ptr[r];
    char* od = out_d + r * L * esz;
    std::memcpy(od, dat + p * esz, (size_t)(l * esz));
    std::memset(od + l * esz, 0, (size_t)((L - l) * esz));
    int* oc = out_c + r * L;
    std::memcpy(oc, ind + p, (size_t)(l * sizeof(int)));
    std::memset(oc + l, 0, (size_t)((L - l) * sizeof(int)));
  }
}

}  // extern "C"
