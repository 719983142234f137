// A variant of the LZ match-table kernel for the A/B in
// scripts/torch_table_ab.py: the stable LSD radix sort of
// tpucomp_torch/csrc/lz_match_table_radix.cuh for every row, as the table
// was built before rows of up to 64 KB got the grouping kernel of
// tpucomp_torch/csrc/lz_match_table.cu.  Same C interface and the same
// table; it counts nothing.  The A/B finds the header in tpucomp_torch/csrc.

#include "lz_match_table_radix.cuh"

extern "C" int tc_lz_match_table_grid(long long batch, long long row_bytes, long long* scratch_bytes) {
  return tpucomp_lzt::radix_grid(batch, row_bytes, scratch_bytes);
}

extern "C" int tc_lz_match_table(const void* data, const void* lengths, void* out, void* scratch,
                                 long long batch, long long row_bytes, int stride, int max_offset,
                                 int end_margin, int grid, void* counters, void* stream) {
  (void)counters;
  return tpucomp_lzt::radix_launch(data, lengths, out, scratch, batch, row_bytes, stride, max_offset, end_margin,
                                   grid, stream);
}
