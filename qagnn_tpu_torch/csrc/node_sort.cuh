// A graph's live edge slots sorted by node in shared memory: the prologue
// that the unprojected op's route-1 kernels share (gat_unproj.cu:
// aggr_graph_kernel and bwd1_graph_kernel, which sort by the node they sum
// into, and bwd2_graph_kernel, which sorts by both endpoints;
// denoms_graph_kernel takes the offset scan alone).
//
// A block reads the graph's (src, dst, mask) once, packs each slot's local
// endpoints into one word (DEAD where masked) and counts the live slots per
// node with shared integer atomics, which are native on sm_90a (ATOMS.ADD;
// a shared float atomicAdd is a compare-and-swap loop there, so no route-1
// kernel sums floats that way). One warp turns the counts into offsets; the
// slots are then placed in node order (a counting sort), each node's slots a
// run of the permutation. Node and slot indices are uint16, so N and E are
// at most 65536.
#pragma once
#include "gat_common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t DEAD = 0xffffffffu;  // a masked slot's packed word
constexpr int PB = 8;                   // loads a thread has in flight while
                                        // it counts the slots

// the node of a packed slot: its source (KEY 0) or its destination (KEY 1)
template <int KEY>
__device__ __forceinline__ int slot_node(uint32_t sd) {
  return KEY == 0 ? (int)(sd & 0xffff) : (int)(sd >> 16);
}

// every slot of the graph, PB a thread at once, NT threads: s_sd[e] = src |
// dst << 16, or DEAD where masked; the live slots' counts per source into
// cnt_s (BY_SRC) and per destination into cnt_d (BY_DST), which arrive zeroed
template <int NT, bool BY_SRC, bool BY_DST>
__device__ __forceinline__ void pack_slots(const int32_t* __restrict__ g_src,
                                           const int32_t* __restrict__ g_dst,
                                           const uint8_t* __restrict__ g_mask,
                                           int E, uint32_t* s_sd, int* cnt_s,
                                           int* cnt_d) {
  for (int e0 = threadIdx.x; e0 < E; e0 += PB * NT) {
    bool lv[PB];
    int sv[PB], dv[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int e = e0 + k * NT;
      lv[k] = e < E && g_mask[e];
      sv[k] = e < E ? g_src[e] : 0;
      dv[k] = e < E ? g_dst[e] : 0;
    }
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      const int e = e0 + k * NT;
      if (e >= E) break;
      if (lv[k]) {
        if (BY_SRC) atomicAdd(&cnt_s[sv[k]], 1);
        if (BY_DST) atomicAdd(&cnt_d[dv[k]], 1);
      }
      s_sd[e] = lv[k] ? (uint32_t)sv[k] | (uint32_t)dv[k] << 16 : DEAD;
    }
  }
}

// exclusive scan of cnt[0, n) into off[0, n] and cur[0, n), by one warp
__device__ __forceinline__ void warp_offsets(const int* cnt, int* off,
                                             int* cur, int n, int lane) {
  const int per = (n + 31) / 32, i0 = lane * per;
  int sum = 0;
  for (int i = i0; i < i0 + per && i < n; ++i) sum += cnt[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  int run = incl - sum;
  for (int i = i0; i < i0 + per && i < n; ++i) {
    const int c = cnt[i];               // cur may be cnt itself
    off[i] = cur[i] = run;
    run += c;
  }
  if (lane == 31) off[n] = incl;
}

// the first node whose run starts at or after virtual slot v
__device__ __forceinline__ int first_node(const int* off, int n, int v) {
  int lo = 0, hi = n;                   // off[n] >= v always
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (off[mid] >= v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// part `part` of `parts` of the sorted slots [a, b), cut at node
// boundaries: the first node of the part (its slots start at off[node])
__device__ __forceinline__ int part_start(const int* off, int n, int a, int b,
                                          int part, int parts) {
  return first_node(off, n, a + (int)((long long)(b - a) * part / parts));
}

// every live slot whose node (KEY) lies in [lo, hi), NT threads: put at its
// node's next place in perm, cur holding each node's next place (the
// offsets, as warp_offsets leaves them)
template <int KEY, int NT>
__device__ __forceinline__ void place_slots(const uint32_t* s_sd, int E,
                                            int lo, int hi, int* cur,
                                            uint16_t* perm) {
  for (int e = threadIdx.x; e < E; e += NT) {
    const uint32_t sd = s_sd[e];
    if (sd == DEAD) continue;
    const int n = slot_node<KEY>(sd);
    if (n >= lo && n < hi) perm[atomicAdd(&cur[n], 1)] = (uint16_t)e;
  }
}

// the columns [c0, c0 + cw) of the N rows of a (., HD) node array from a
// (the graph's first row) into s (N x cw), by cp.async, NT threads; the
// caller commits and waits
template <typename T, int NT>
__device__ __forceinline__ void stage_slice(T* s, const T* __restrict__ a,
                                            int N, int HD, int c0, int cw) {
  constexpr int EW = 16 / sizeof(T);     // values of a 16-byte word
  for (int i = threadIdx.x; i < N * (cw / EW); i += NT) {
    const int r = i / (cw / EW), c = EW * (i % (cw / EW));
    cp_async16(s + r * cw + c, a + (long long)r * HD + c0 + c);
  }
}

}  // namespace
