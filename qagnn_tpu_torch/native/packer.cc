// Host-side edge packer of a training batch: variable-length COO edge lists
// -> fixed (G, E) buckets, each graph's edges stably sorted by source node,
// with a uint8 mask of the real slots.
//
// Counterpart of pack_edges_ptrs in qagnn_tpu/native/packer.cc, with one
// change of interface: each graph's source and destination rows come as
// two pointers instead of one (2, len) block, so that the per-graph views
// the graph cache hands out (columns of one (2, total) array, whose rows
// are contiguous but whose block is not) are read without a copy.
//
// C ABI only (loaded with ctypes by build.py): no C++ type crosses it.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Pack the edges of n_graphs graphs into (n_graphs, edges_per_graph).
//   src_ptrs[g], dst_ptrs[g], type_ptrs[g]: graph g's source, destination
//     and relation ids, lengths[g] of each
// Outputs, preallocated by the caller, (n_graphs, edges_per_graph) each:
//   out_src, out_dst, out_type: int32, the first min(lengths[g],
//     edges_per_graph) edges of graph g in a stable order of their sources
//     (a counting sort, O(E + N)), the rest 0
//   out_mask: 1 for those slots, 0 after them
// A graph with more edges than edges_per_graph keeps its lowest-index ones.
// Returns 0, or g + 1 for the first graph g with a negative source (its
// row and the rows after it are then not written).
int64_t pack_edges_rows(const int32_t* const* src_ptrs,
                        const int32_t* const* dst_ptrs,
                        const int32_t* const* type_ptrs,
                        const int64_t* lengths, int64_t n_graphs,
                        int64_t edges_per_graph, int32_t* out_src,
                        int32_t* out_dst, int32_t* out_type,
                        uint8_t* out_mask) {
  std::vector<int64_t> counts;
  for (int64_t g = 0; g < n_graphs; ++g) {
    const int64_t e = std::min(lengths[g], edges_per_graph);
    const int32_t* src = src_ptrs[g];
    const int32_t* dst = dst_ptrs[g];
    const int32_t* typ = type_ptrs[g];
    int32_t* osrc = out_src + g * edges_per_graph;
    int32_t* odst = out_dst + g * edges_per_graph;
    int32_t* otyp = out_type + g * edges_per_graph;
    uint8_t* omask = out_mask + g * edges_per_graph;

    int32_t min_src = 0, max_src = 0;
    for (int64_t i = 0; i < e; ++i) {
      min_src = std::min(min_src, src[i]);
      max_src = std::max(max_src, src[i]);
    }
    if (min_src < 0) return g + 1;
    // counts[v + 1] = edges with source v; then the prefix sums give each
    // source's first slot, and a pass in edge order keeps ties stable
    counts.assign(static_cast<size_t>(max_src) + 2, 0);
    for (int64_t i = 0; i < e; ++i) ++counts[src[i] + 1];
    for (int32_t v = 0; v <= max_src; ++v) counts[v + 1] += counts[v];
    for (int64_t i = 0; i < e; ++i) {
      const int64_t pos = counts[src[i]]++;
      osrc[pos] = src[i];
      odst[pos] = dst[i];
      otyp[pos] = typ[i];
    }
    std::memset(omask, 1, e);
    const int64_t pad = edges_per_graph - e;
    std::memset(osrc + e, 0, pad * sizeof(int32_t));
    std::memset(odst + e, 0, pad * sizeof(int32_t));
    std::memset(otyp + e, 0, pad * sizeof(int32_t));
    std::memset(omask + e, 0, pad);
  }
  return 0;
}

}  // extern "C"
