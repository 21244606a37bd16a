// Exact fused 1-NN over masked point clouds, with the refs split across
// blocks.
//
// Replaces: alego_tpu/ops/pallas_nn.py, nn1_pallas / _nn_kernel (the
// odometry association's nearest neighbour).
//
// Contract (pallas_nn.py:27-33,62-73), bit for bit:
//   * d2 = (dx*dx + dy*dy) + dz*dz, each operation rounded as a separate f32
//     operation (__fsub_rn / __fmul_rn / __fadd_rn: no FMA contraction);
//   * ties go to the lowest ref index;
//   * d2 is clamped to >= 0 and idx to [0, N-1];
//   * an invalid query, or one with no valid ref, reports (1e30, 0).
// The reference adds a +1e30 penalty to invalid refs; this kernel skips
// them instead.  That gives the same answer wherever |coordinates| < 5e10:
// a valid ref's d2 is then below 3e22, far below 1e30, and an invalid ref's
// d2 + 1e30 rounds to exactly 1e30 (one f32 ulp there is 2^76 ~ 7.6e22, so
// that needs d2 below ~3.8e22), so an invalid ref never beats a valid one,
// and when no ref is valid all tie at 1e30 and the lowest index, 0, wins.
// So the kernel needs no active lengths: no reduction runs before it.
//
// What bounds it on this card: at the odometry shapes (<= 512 queries, a
// few hundred live, against <= 8192 refs) neither operations (~16 M) nor
// bytes (~0.1 MB) but how many SMs the work reaches and the launch.  A
// thread per query alone fills 4 blocks of 132 SMs.  So the grid is query
// tiles x ref chunks, sized by the wrapper from the static Q and N to put
// several blocks on every SM: a block stages its chunk's refs in shared
// memory as float4 (x, y, z, 0 or +inf), each thread keeps its query's best
// (d2, idx) over the chunk, visiting refs in index order with strict <, and
// writes it packed as (float bits of d2) << 32 | idx, a key whose unsigned
// order is (d2, idx) order since d2 >= +0.  A second small kernel takes the
// minimum key of each query over the chunks (a warp per query) and writes
// (d2, idx).  Blocks whose queries are all invalid, and ref tiles with no
// valid ref, do no distance work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 64;  // threads (queries) per block
constexpr int kTile = 256;    // refs per shared-memory tile
constexpr int kReduceThreads = 256;  // 8 queries, a warp each
constexpr float kBig = 1e30f;
constexpr unsigned long long kNone = ~0ull;  // no valid ref in the chunk

__global__ void __launch_bounds__(kQueries)
nn1_chunks(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
           const float* __restrict__ ref, const uint8_t* __restrict__ rmask,
           int Q, int N, int chunk, unsigned long long* __restrict__ part) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kQueries + threadIdx.x;
  const bool live = qi < Q && qmask[qi] != 0;
  if (!__syncthreads_or(live)) return;  // the reduce never reads these

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = query[3 * qi];
    qy = query[3 * qi + 1];
    qz = query[3 * qi + 2];
  }
  float bd = INFINITY;
  int bi = 0;
  const int c0 = blockIdx.y * chunk;
  const int c1 = min(N, c0 + chunk);
  for (int base = c0; base < c1; base += kTile) {
    const int n = min(kTile, c1 - base);
    bool any = false;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kQueries) {
      const int g = base + j;
      const bool ok = rmask[g] != 0;
      tile[j] = make_float4(ref[3 * g], ref[3 * g + 1], ref[3 * g + 2],
                            ok ? 0.f : INFINITY);
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;
    for (int j = 0; j < n; ++j) {
      const float4 p = tile[j];
      const float dx = __fsub_rn(qx, p.x);
      const float dy = __fsub_rn(qy, p.y);
      const float dz = __fsub_rn(qz, p.z);
      const float cd = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                    __fmul_rn(dz, dz)),
          p.w);  // +0 for a valid ref (exact), +inf skips an invalid one
      if (cd < bd) {
        bd = cd;
        bi = base + j;
      }
    }
  }
  if (live)
    part[(size_t)blockIdx.y * Q + qi] =
        bd < INFINITY
            ? ((unsigned long long)__float_as_uint(bd) << 32) | (unsigned)bi
            : kNone;
}

// A warp per query: each lane takes the minimum over every 32nd chunk, then
// the warp's lanes combine theirs.  The minimum of the keys does not depend
// on the order they are taken in.
__global__ void __launch_bounds__(kReduceThreads)
nn1_reduce(const uint8_t* __restrict__ qmask,
           const unsigned long long* __restrict__ part, int Q, int N,
           int chunks, float* __restrict__ d_out, int32_t* __restrict__ i_out) {
  const int qi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (qi >= Q) return;  // the same for the whole warp
  unsigned long long best = kNone;
  if (qmask[qi])
    for (int c = lane; c < chunks; c += 32)
      best = min(best, part[(size_t)c * Q + qi]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    best = min(best, __shfl_xor_sync(0xFFFFFFFFu, best, off));
  if (lane != 0) return;
  if (best == kNone) {
    d_out[qi] = kBig;
    i_out[qi] = 0;
  } else {
    d_out[qi] = fmaxf(__uint_as_float((unsigned)(best >> 32)), 0.f);
    i_out[qi] = min(max((int)(unsigned)best, 0), N - 1);
  }
}

}  // namespace

// query [Q, 3] f32, qmask [Q] bool, ref [N, 3] f32, rmask [N] bool;
// `chunk` refs per block (a multiple of 32); part [ceil(N / chunk), Q]
// uint64 scratch; d [Q] f32 and idx [Q] int32 out.  Returns
// cudaGetLastError() after the launches, or -1 for a bad chunk.
extern "C" int alego_nn1(const float* q, const uint8_t* qm, const float* r,
                         const uint8_t* rm, int Q, int N, int chunk,
                         unsigned long long* part, float* d, int32_t* i,
                         void* stream) {
  if (chunk <= 0 || chunk % 32 != 0) return -1;
  cudaStream_t s = (cudaStream_t)stream;
  const int chunks = (N + chunk - 1) / chunk;
  const dim3 grid((Q + kQueries - 1) / kQueries, chunks);
  nn1_chunks<<<grid, kQueries, 0, s>>>(q, qm, r, rm, Q, N, chunk, part);
  nn1_reduce<<<(Q + kReduceThreads / 32 - 1) / (kReduceThreads / 32),
               kReduceThreads, 0, s>>>(qm, part, Q, N, chunks, d, i);
  return (int)cudaGetLastError();
}
