// Feature moments of the masked edge slots, the data-only input of the edge
// encoder's analytic train-mode BatchNorm statistics:
//     hist[f]   = number of masked slots whose feature row sets f
//     M[f, f']  = number of masked slots whose row sets both f and f'
//     n         = number of masked slots
// where a slot's row is [onehot(rel) | onehot(type[src]) | onehot(type[dst])],
// so it sets exactly three features. A relation id outside [0, n_rel)
// matches no relation column of the TPU kernel's one-hot (`_feat_onehot`
// :72-78, a comparison with the feature ids): its relation part is zero,
// while its head and tail types and its count stand.
//
// Replaces the TPU kernel `_moments_kernel`
// (qagnn_tpu/ops/pallas_edge_encoder.py:93, launched by
// `edge_feature_moments` :144), which builds the (F, T) one-hot tile and takes
// feat feat^T on the matrix unit, accumulating over a sequential grid.
//
// A slot's row is fixed by its triple (rel, type[src], type[dst]), so the
// kernel counts the T = (n_rel + 1) * n_ntype^2 triples (640 at n_rel = 39,
// n_ntype = 4; relation n_rel is the bucket of slots with no relation) and
// expands the counts C into hist, M and n, all exact integer sums of C:
//     hist[rel r] = sum_ab C[r,a,b], hist[head a] = sum_rb C, hist[tail b] =
//     sum_ra C; M's diagonal blocks are diag(hist) (a row sets one feature of
//     each part); M[r, head a] = sum_b C[r,a,b], M[r, tail b] = sum_a C,
//     M[head a, tail b] = sum_r C, and their transposes; n = sum C. The sums
//     over r take the bucket; no r index of hist or M names it.
//
// One launch. About one block an SM reads a contiguous slab of the (G, E)
// arrays, four slots a thread in 16-byte loads (the mask in 4-byte ones),
// and counts its live slots' triples in a T-int table in shared memory with
// one shared integer atomic a slot (native on this card; the old kernel
// made 13 a slot, one of them on a single counter for every thread of a
// block). Grouping a warp's equal triples first with __match_any_sync
// measured slower at these sizes (few lanes of a warp share a triple), so
// the atomics take the slots one by one. Each block then adds its non-zero
// counts into a T-int table in device memory with fire-and-forget global
// atomics (at most T a block, spread over T addresses), and the last block
// to finish (a __threadfence and a ticket taken with one atomic) reads the
// table, expands it into the f32 outputs and leaves the table and the ticket
// at zero for the next launch. So there is no memset and no conversion, and
// the result is exact (integer sums; counts below 2^24 are exact in f32).
// Writing each block's counts as a row of partials for the last block to
// sum measured slower: that block then reads every row through L2 while the
// rest of the card waits. A separate one-block expand launch would add a
// second launch to the same work, so the expansion stays in the last block.
// The table and ticket are 1 + T int32 that the caller allocates zeroed once
// per device and stream: launches on one stream run one after another, so
// no two run at once on one table.
//
// Bound on the H100: bytes, the four (G, E) int32 / bool arrays read once
// (3.4 MB at G=64, E=4096: about 1.0 us at 3.35 TB/s). That lies below what
// one launch costs on this card (an empty kernel, timed the same way), and
// two dependent reads (a slot's indices, then its endpoints' types) and the
// last block's read-and-expand follow one another inside the launch, so a
// few microseconds over the launch are the floor of this design.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MT = 512;                 // threads per block
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory a block may opt into, less room for s_last
constexpr size_t MAX_SMEM = 227 * 1024 - 64;

// the triple counts: n_rel relations and the no-relation bucket
__host__ __device__ inline int triples(int n_rel, int n_ntype) {
  return (n_rel + 1) * n_ntype * n_ntype;
}

// ints of a block's counts and of the last block's tables (RA and RB for
// the n_rel relations, AB)
__host__ __device__ inline int table_ints(int n_rel, int n_ntype) {
  return triples(n_rel, n_ntype) + 2 * n_rel * n_ntype + n_ntype * n_ntype;
}

// the triple of a slot of graph g, or -1 where it is not masked (or its
// endpoints or their types are out of range); a relation id outside
// [0, n_rel) counts in the no-relation bucket n_rel
__device__ __forceinline__ int slot_key(bool live, int rel, int s, int d,
                                        long long g, int N,
                                        const int32_t* __restrict__ ntype,
                                        int n_rel, int n_ntype) {
  if (!live || (unsigned)s >= (unsigned)N || (unsigned)d >= (unsigned)N)
    return -1;
  const int a = ntype[g * N + s], b = ntype[g * N + d];
  if ((unsigned)a >= (unsigned)n_ntype || (unsigned)b >= (unsigned)n_ntype)
    return -1;
  const int r = (unsigned)rel < (unsigned)n_rel ? rel : n_rel;
  return (r * n_ntype + a) * n_ntype + b;
}

// V = 4: four consecutive slots a thread by 16-byte loads (the caller
// checks the alignment); V = 1: one slot a thread, any alignment.
template <int V>
__global__ void __launch_bounds__(MT)
edge_moments_kernel(const int32_t* __restrict__ etype,
                    const int32_t* __restrict__ src,
                    const int32_t* __restrict__ dst,
                    const int32_t* __restrict__ ntype,
                    const uint8_t* __restrict__ mask,
                    unsigned* __restrict__ ticket, float* __restrict__ out,
                    long long n_edges, long long chunk, int E, int N,
                    int n_rel, int n_ntype) {
  extern __shared__ int s_c[];           // counts (T), then the tables
  __shared__ bool s_last;
  const int T = triples(n_rel, n_ntype);
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < T; i += MT) s_c[i] = 0;
  __syncthreads();

  const long long lo = blockIdx.x * chunk;
  const long long hi = lo + chunk < n_edges ? lo + chunk : n_edges;
  for (long long i0 = lo + (long long)tid * V; i0 < hi;
       i0 += (long long)MT * V) {
    // the slots' graphs: V <= E, so at most one boundary among them
    const long long g0 = i0 / E;
    const int e0 = (int)(i0 - g0 * E);
    int key[V];
    if (V == 4 && i0 + 4 <= hi) {
      const int4 r = *reinterpret_cast<const int4*>(etype + i0);
      const int4 s = *reinterpret_cast<const int4*>(src + i0);
      const int4 d = *reinterpret_cast<const int4*>(dst + i0);
      const uchar4 m = *reinterpret_cast<const uchar4*>(mask + i0);
      const int rv[4] = {r.x, r.y, r.z, r.w}, sv[4] = {s.x, s.y, s.z, s.w},
                dv[4] = {d.x, d.y, d.z, d.w};
      const bool mv[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};
#pragma unroll
      for (int j = 0; j < V; ++j)
        key[j] = slot_key(mv[j], rv[j], sv[j], dv[j], g0 + (e0 + j >= E), N,
                          ntype, n_rel, n_ntype);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const long long i = i0 + j;
        key[j] = i < hi ? slot_key(mask[i] != 0, etype[i], src[i], dst[i],
                                   g0 + (e0 + j >= E), N, ntype, n_rel,
                                   n_ntype)
                        : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (key[j] >= 0) atomicAdd(&s_c[key[j]], 1);
  }
  __syncthreads();

  // this block's counts into the device's table, then the ticket
  int* counts = reinterpret_cast<int*>(ticket) + 1;
  for (int i = tid; i < T; i += MT)
    if (s_c[i]) atomicAdd(&counts[i], s_c[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: C from the table, which it leaves zeroed
  __threadfence();
  for (int i = tid; i < T; i += MT) {
    s_c[i] = __ldcg(counts + i);
    counts[i] = 0;
  }
  __syncthreads();

  // RA[r][a] = sum_b C, RB[r][b] = sum_a C (r < n_rel), AB[a][b] = sum_r C
  // (the no-relation bucket included)
  const int nt = n_ntype, F = n_rel + 2 * nt;
  int* RA = s_c + T;
  int* RB = RA + n_rel * nt;
  int* AB = RB + n_rel * nt;
  for (int i = tid; i < n_rel * nt; i += MT) {
    const int r = i / nt, x = i % nt;
    int ra = 0, rb = 0;
    for (int y = 0; y < nt; ++y) {
      ra += s_c[(r * nt + x) * nt + y];
      rb += s_c[(r * nt + y) * nt + x];
    }
    RA[i] = ra;
    RB[i] = rb;
  }
  // AB by warps: lanes stride over the relations, then a warp sum
  for (int i = tid >> 5; i < nt * nt; i += MT / 32) {
    int v = 0;
    for (int r = lane; r <= n_rel; r += 32) v += s_c[r * nt * nt + i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) AB[i] = v;
  }
  __syncthreads();
  // the outputs straight from the three tables, one barrier after them:
  // hist[f] at f's slot in M's diagonal (and in hist), M[i][j] by the parts
  // of i and j (0 relation, 1 head type, 2 tail type)
  for (int idx = tid; idx < F * F + F; idx += MT) {
    const bool diag_only = idx >= F * F;   // hist[f], f = idx - F * F
    int i = diag_only ? idx - F * F : idx / F, j = diag_only ? i : idx % F;
    int pi = i < n_rel ? 0 : (i < n_rel + nt ? 1 : 2);
    int pj = j < n_rel ? 0 : (j < n_rel + nt ? 1 : 2);
    int v = 0;
    if (i == j) {
      for (int x = 0; x < nt; ++x)
        v += pi == 0 ? RA[i * nt + x]
                     : (pi == 1 ? AB[(i - n_rel) * nt + x]
                                : AB[x * nt + i - n_rel - nt]);
    } else if (pi != pj) {
      if (pi > pj) {
        const int t = i; i = j; j = t;
        const int u = pi; pi = pj; pj = u;
      }
      const int li = i - (pi == 0 ? 0 : n_rel);
      const int lj = j - (pj == 1 ? n_rel : n_rel + nt);
      v = pi == 1 ? AB[li * nt + lj] : (pj == 1 ? RA : RB)[li * nt + lj];
    }
    out[diag_only ? i : F + idx] = (float)v;
  }
  if (tid == 0) {
    int n = 0;
    for (int x = 0; x < nt * nt; ++x) n += AB[x];
    out[F + F * F] = (float)n;
    *ticket = 0u;                        // ready for the next launch
  }
}

}  // namespace

// out: F + F*F + 1 f32, written whole: hist, then M row-major, then n.
// ticket: 1 + (n_rel + 1) * n_ntype^2 int32, the ticket and the table of
// triple counts, zero on entry (and left zero); launches that share one must
// run one after another. A slot whose relation id lies out of range counts
// with no relation feature; slots whose endpoints or types lie out of range
// are not counted. The grid is one block an SM at most, fewer where the
// slots would not give each thread its four.
extern "C" int edge_moments_launch(const void* etype, const void* src,
                                   const void* dst, const void* ntype,
                                   const void* mask, void* ticket, void* out,
                                   int G, int E, int N, int n_rel, int n_ntype,
                                   void* stream) {
  const long long T = (long long)(n_rel + 1) * n_ntype * n_ntype;
  if (n_rel <= 0 || n_ntype <= 0 || T > (1 << 20))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (size_t)table_ints(n_rel, n_ntype);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_edges = (long long)G * E;
  const long long per_block = (long long)MT * 4;
  const long long want = (n_edges + per_block - 1) / per_block;
  const int n_blocks = (int)(want < 1 ? 1 : (want < n_sm ? want : n_sm));
  // whole groups of 4 slots a block, so that 16-byte loads stay aligned
  const long long chunk = ((n_edges + n_blocks - 1) / n_blocks + 3) & ~3LL;
  const bool wide = ((uintptr_t)etype | (uintptr_t)src | (uintptr_t)dst) % 16 == 0
                    && (uintptr_t)mask % 4 == 0 && E >= 4;
  const auto kernel = wide ? edge_moments_kernel<4> : edge_moments_kernel<1>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<n_blocks, MT, smem, (cudaStream_t)stream>>>(
      (const int32_t*)etype, (const int32_t*)src, (const int32_t*)dst,
      (const int32_t*)ntype, (const uint8_t*)mask, (unsigned*)ticket,
      (float*)out, n_edges, chunk, E, N, n_rel, n_ntype);
  return (int)cudaGetLastError();
}
