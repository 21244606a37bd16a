// Exact fused k-nearest-neighbour search (k <= 8) over masked point clouds,
// with the refs split across blocks and an exact merge of k-sorted lists.
//
// Replaces: alego_tpu/ops/pallas_nn.py, knn_pallas / _knn_kernel (the
// scan-to-map 5-NN, and the k = 1 loop-acceptance check).  The odometry
// 1-NN (nn1_pallas) has its own kernel, csrc/nn1.cu.
//
// Contract (pallas_nn.py:27-33,62-73,163-167,283-287), bit for bit with the
// plain version (ops/nn.py knn_plain):
//   * d2 = (dx*dx + dy*dy) + dz*dz, each operation rounded as a separate f32
//     operation (__fsub_rn / __fmul_rn / __fadd_rn: no FMA contraction);
//   * the k best refs in (d2, idx) order: ties go to the lowest ref index;
//   * d2 is clamped to >= 0 and idx to [0, N-1];
//   * an invalid query reports (1e30, 0) in every slot.
// The reference adds a +1e30 penalty to invalid refs; this kernel skips
// them and writes the fill slots in the merge.  That gives the same answer
// wherever |coordinates| < 5e10: a valid ref's d2 is then below 3e22, and an
// invalid or padding ref's d2 + 1e30 rounds to exactly 1e30 (one f32 ulp
// there is 2^76 ~ 7.6e22).  So every valid ref sorts before every invalid
// one, and those all tie at 1e30: where fewer than k refs are valid, the
// other slots hold the lowest indices in [0, max(N, k)) that are not valid
// refs, ascending, at d2 = 1e30, clipped to N - 1 (the reference pads the
// refs to k when N < k).  With fewer than k valid refs the merged list holds
// all of them, so the merge finds those fill indices, all below k, by
// itself.  No active lengths are needed: no reduction runs before the
// kernels.
//
// What bounds it on this card: operations, ~9 f32 operations per live query
// x live ref (2243 x 11992 at the surf mapping shape) against ~0.3 MB of
// traffic, once the work reaches every SM.  A thread per query alone gave
// 48 blocks at the surf shape (36 with live queries) on 132 SMs.  So the
// grid is query tiles of 64 x ref chunks, sized by the wrapper from the
// static Q, N and k (ops/nn.py knn_chunk) to put several blocks on every SM.
//   knn_chunks: a block stages its chunk's refs in shared memory as float4
//     (x, y, z, 0), an invalid ref with x = +inf so that its d2 is +inf and
//     it never enters a list (one f32 add per pair fewer than a penalty).
//     Each thread keeps its query's K best of the chunk in registers, in
//     (d2, idx) order, and writes them as keys (float bits of d2) << 32 |
//     idx into part[chunk][slot][query], coalesced, ~0 in the slots it did
//     not fill.  Inserting into a register list is a branch, and a warp
//     takes it whenever one of its 32 lanes inserts: on most refs while the
//     lists fill at the start of a chunk, and still often after (by count,
//     on ~44% of the refs of a 768-ref chunk of uniformly spread points).
//     So the ref loop inserts nothing: it writes each ref to the thread's
//     next free slot of a 24-slot buffer in shared memory and keeps it
//     (count + 1) only if it beats the thread's K-th best as of its last
//     flush; a store and an add, no branch.  Every 8 refs the warp flushes
//     together if one lane could overflow: each lane inserts its own
//     candidates in index order with strict < (an equal d2 stays behind the
//     lower index), so a flush costs the warp its fullest lane's count.  A
//     stale K-th best only lets more candidates through, never fewer: the
//     lists are exact.
//   knn_merge: a warp per query.  The unsigned order of the keys is (d2,
//     idx) order since d2 >= +0, and no two keys are equal since no two idx
//     are, so any merge order gives the same K smallest keys.  Each lane
//     folds the lists of every 32nd chunk into a sorted register list; then
//     K rounds of a warp min over the lanes' heads, the lane that holds the
//     min popping it; then the contract: clamps, fill slots, invalid
//     queries.
// Blocks whose queries are all invalid, and ref tiles with no valid ref, do
// no distance work.  What is left: the buffer's store per pair, the flushes
// while the lists fill at the start of each chunk, and two launches per
// call.  tools/sweep_knn_grid.py times the launch against the grid's size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 64;         // threads (queries) per block
constexpr int kTile = 256;           // refs per shared-memory tile
constexpr int kGroup = 8;            // refs between two looks at the buffers
constexpr int kSlots = 24;           // candidate slots per thread
constexpr int kMergeThreads = 256;   // 8 queries, a warp each
constexpr float kBig = 1e30f;
constexpr unsigned long long kNone = ~0ull;  // an empty slot
static_assert(kTile % kGroup == 0 && kSlots >= kGroup, "buffer layout");

// Insert (cd, ci) into the list (bd, bi), ascending, if it beats the last
// entry: before the first strictly larger entry, then the rest shift down
// one slot, so equal distances keep their (index) order.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float cd,
                                       int ci) {
  if (!(cd < bd[K - 1])) return;
  bool shift = false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (shift || cd < bd[s]) {
      const float td = bd[s];
      const int ti = bi[s];
      bd[s] = cd;
      bi[s] = ci;
      cd = td;
      ci = ti;
      shift = true;
    }
  }
}

// Insert a thread's buffered candidates, in the (index) order they came.
template <int K>
__device__ __forceinline__ void drain(const float2 (&cand)[kSlots][kQueries],
                                      int t, int cnt, float (&bd)[K],
                                      int (&bi)[K]) {
  for (int c = 0; c < cnt; ++c)
    insert<K>(bd, bi, cand[c][t].x, __float_as_int(cand[c][t].y));
}

template <int K>
__global__ void __launch_bounds__(kQueries)
knn_chunks(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
           const float* __restrict__ ref, const uint8_t* __restrict__ rmask,
           int Q, int N, int chunk, unsigned long long* __restrict__ part) {
  __shared__ float4 tile[kTile];
  // each thread's candidates (d2, idx bits), a column per thread
  __shared__ float2 cand[kSlots][kQueries];
  const int t = threadIdx.x;
  const int qi = blockIdx.x * kQueries + t;
  const bool live = qi < Q && qmask[qi] != 0;
  if (!__syncthreads_or(live)) return;  // the merge never reads these

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = query[3 * qi];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }
  float thr = INFINITY;  // bd[K-1] as of the last flush
  int cnt = 0;           // candidates buffered since
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(N, c0 + chunk);
  for (int base = c0; base < c1; base += kTile) {
    const int n = min(kTile, c1 - base);
    const int n_pad = (n + kGroup - 1) / kGroup * kGroup;
    bool any = false;
    __syncthreads();
    for (int j = t; j < n_pad; j += kQueries) {
      const int g = base + j;
      const bool ok = j < n && rmask[g] != 0;
      tile[j] = ok ? make_float4(ref[3 * g], ref[3 * g + 1], ref[3 * g + 2], 0.f)
                   : make_float4(INFINITY, 0.f, 0.f, 0.f);
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;
    for (int j = 0; j < n_pad; j += kGroup) {
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const float4 p = tile[j + g];
        const float dx = __fsub_rn(qx, p.x);
        const float dy = __fsub_rn(qy, p.y);
        const float dz = __fsub_rn(qz, p.z);
        const float cd = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        // every ref takes the next free slot; only a candidate keeps it
        cand[cnt][t] = make_float2(cd, __int_as_float(base + j + g));
        cnt += cd < thr;
      }
      // the warp flushes together once a lane could overflow in the next group
      if (__any_sync(0xFFFFFFFFu, cnt > kSlots - kGroup)) {
        drain<K>(cand, t, cnt, bd, bi);
        cnt = 0;
        thr = bd[K - 1];
      }
    }
  }
  drain<K>(cand, t, cnt, bd, bi);
  if (!live) return;
  unsigned long long* out = part + (size_t)blockIdx.y * K * Q + qi;
#pragma unroll
  for (int s = 0; s < K; ++s)
    out[(size_t)s * Q] =
        bd[s] < INFINITY
            ? ((unsigned long long)__float_as_uint(bd[s]) << 32) | (unsigned)bi[s]
            : kNone;
}

template <int K>
__global__ void __launch_bounds__(kMergeThreads)
knn_merge(const uint8_t* __restrict__ qmask,
          const unsigned long long* __restrict__ part, int Q, int N,
          int chunks, float* __restrict__ d_out, int32_t* __restrict__ i_out) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= Q) return;  // the same for the whole warp
  float* d = d_out + (size_t)qi * K;
  int32_t* ix = i_out + (size_t)qi * K;
  if (!qmask[qi]) {
    if (lane < K) {
      d[lane] = kBig;
      ix[lane] = 0;
    }
    return;
  }

  unsigned long long l[K];  // this lane's K smallest keys, ascending
#pragma unroll
  for (int s = 0; s < K; ++s) l[s] = kNone;
  for (int c = lane; c < chunks; c += 32) {
    const unsigned long long* src = part + (size_t)c * K * Q + qi;
    unsigned long long in[K];
#pragma unroll
    for (int s = 0; s < K; ++s) in[s] = src[(size_t)s * Q];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      // carry the larger key down the list; a key above l[K-1] falls off
      unsigned long long key = in[s];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        const unsigned long long lo = min(l[t], key);
        key = max(l[t], key);
        l[t] = lo;
      }
    }
  }

  unsigned long long mine = kNone;  // lane s keeps the s-th key
  unsigned taken = 0;               // bit j: ref j (j < K) is in the list
  int found = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    unsigned long long m = l[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = min(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
    if (m == kNone) break;  // the same in every lane: no valid ref is left
    if (l[0] == m) {        // one lane only: the keys are distinct
#pragma unroll
      for (int t = 0; t + 1 < K; ++t) l[t] = l[t + 1];
      l[K - 1] = kNone;
    }
    if (lane == s) mine = m;
    const unsigned j = (unsigned)m;
    if (j < (unsigned)K) taken |= 1u << j;
    found = s + 1;
  }
  if (lane >= K) return;
  if (lane < found) {
    d[lane] = fmaxf(__uint_as_float((unsigned)(mine >> 32)), 0.f);
    ix[lane] = min(max((int)(unsigned)mine, 0), N - 1);
    return;
  }
  // fewer than K valid refs, all of them in the list: this slot takes the
  // (lane - found)-th index below K that is not a valid ref
  int j = 0;
  for (int want = lane - found; j < K; ++j) {
    if ((taken >> j) & 1u) continue;
    if (want-- == 0) break;
  }
  d[lane] = kBig;
  ix[lane] = min(j, N - 1);
}

template <int K>
void launch(const float* q, const uint8_t* qm, const float* r,
            const uint8_t* rm, int Q, int N, int chunk,
            unsigned long long* part, float* d, int32_t* i,
            cudaStream_t stream) {
  const int chunks = (N + chunk - 1) / chunk;
  const dim3 grid((Q + kQueries - 1) / kQueries, chunks);
  knn_chunks<K><<<grid, kQueries, 0, stream>>>(q, qm, r, rm, Q, N, chunk,
                                                part);
  constexpr int per_block = kMergeThreads / 32;
  knn_merge<K><<<(Q + per_block - 1) / per_block, kMergeThreads, 0, stream>>>(
      qm, part, Q, N, chunks, d, i);
}

}  // namespace

// query [Q, 3] f32, qmask [Q] bool, ref [N, 3] f32, rmask [N] bool; k in
// 1..8; `chunk` refs per block (a multiple of 32, at most 65535 chunks);
// part [ceil(N / chunk), k, Q] uint64 scratch; d [Q, k] f32 and idx [Q, k]
// int32 out.  Returns cudaGetLastError() after the launches, or -1 for a
// bad k or chunk.
extern "C" int alego_knn(const float* q, const uint8_t* qm, const float* r,
                         const uint8_t* rm, int Q, int N, int k, int chunk,
                         unsigned long long* part, float* d, int32_t* i,
                         void* stream) {
  if (chunk <= 0 || chunk % 32 != 0 || (N + chunk - 1) / chunk > 65535)
    return -1;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 2: launch<2>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 3: launch<3>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 4: launch<4>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 5: launch<5>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 6: launch<6>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 7: launch<7>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    case 8: launch<8>(q, qm, r, rm, Q, N, chunk, part, d, i, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
