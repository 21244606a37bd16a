// Exact fused k-nearest-neighbour search (k <= 8) over masked,
// front-compacted point clouds.
//
// Replaces: alego_tpu/ops/pallas_nn.py, knn_pallas / _knn_kernel (the
// scan-to-map 5-NN).  The odometry 1-NN (nn1_pallas) has its own kernel
// with the refs split across blocks, csrc/nn1.cu.
//
// Contract (pallas_nn.py:27-33,62-73,163-167,283-287):
//   * d2 = ((dx*dx + dy*dy) + dz*dz) + penalty, each operation rounded as a
//     separate f32 operation (no FMA contraction), never |q|^2-2q.r+|r|^2;
//   * an invalid ref carries a +1e30 penalty, an invalid query reports 1e30
//     (and index 0);
//   * d2 is clamped to >= 0 and idx to [0, N-1];
//   * ties go to the lowest ref index (refs visited in index order, each
//     inserted after the entries of equal distance);
//   * nothing past the last live query or ref is computed: the active
//     lengths come from a device tensor (no host read).  Slots that no
//     live ref fills take (1e30, slot index): the next refs by index, as
//     the plain version gives (the Pallas kernel repeats an index there;
//     every consumer masks these 1e30 slots).
//
// What bounds it on this card: operations.  Q x N_live x ~9 f32 operations
// against ~(Q + N) x 16 bytes of traffic; at the mapping shape (3072 x 16384)
// that is ~450 M operations on 0.3 MB.  The design keeps every distance in
// registers (the Pallas kernel's reason to exist was keeping the [TQ, TR]
// tile out of HBM): one thread per query holds its k best in registers,
// sorted by (distance, index) by insertion; refs stream through shared
// memory in 1024-point tiles packed as float4 (x, y, z, penalty), so a warp
// reads each ref as one broadcast.  Parallelism is over queries only (one
// small block of 64 queries each), which leaves most SMs idle at the
// mapping shapes: the ref split of csrc/nn1.cu with a k-sorted merge is
// queued in ROADMAP.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueries = 64;  // threads (queries) per block
constexpr int kTile = 1024;   // refs per shared-memory tile
constexpr float kBig = 1e30f;

template <int K>
__global__ void __launch_bounds__(kQueries)
knn_kernel(const float* __restrict__ query, const uint8_t* __restrict__ qmask,
           const float* __restrict__ ref, const uint8_t* __restrict__ rmask,
           const int32_t* __restrict__ active, int Q, int N,
           float* __restrict__ d_out, int32_t* __restrict__ i_out) {
  __shared__ float4 tile[kTile];
  const int q_live = active[0];
  const int r_live = active[1];
  const int qi = blockIdx.x * blockDim.x + threadIdx.x;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (qi < Q) {
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

  // block-uniform: a block wholly past the last live query does no work
  if ((int)(blockIdx.x * blockDim.x) < q_live) {
    for (int base = 0; base < r_live; base += kTile) {
      const int n = min(kTile, r_live - base);
      __syncthreads();
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int g = base + j;
        tile[j] = make_float4(ref[3 * g], ref[3 * g + 1], ref[3 * g + 2],
                              rmask[g] ? 0.f : kBig);
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) {
        const float4 p = tile[j];
        const float dx = __fsub_rn(qx, p.x);
        const float dy = __fsub_rn(qy, p.y);
        const float dz = __fsub_rn(qz, p.z);
        float cd = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                      __fmul_rn(dz, dz)),
            p.w);
        if (cd < bd[K - 1]) {
          // insert before the first strictly larger entry, then shift the
          // rest down one slot: equal distances keep their (index) order
          int ci = base + j;
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
      }
    }
  }

  if (qi >= Q) return;
  const bool valid = qmask[qi] != 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float d = bd[s];
    int i = bi[s];
    if (d == INFINITY) {  // fewer than K live refs
      d = kBig;
      i = s;
    }
    d_out[qi * K + s] = valid ? fmaxf(d, 0.f) : kBig;
    i_out[qi * K + s] = valid ? min(max(i, 0), N - 1) : 0;
  }
}

template <int K>
void launch(const float* q, const uint8_t* qm, const float* r,
            const uint8_t* rm, const int32_t* active, int Q, int N, float* d,
            int32_t* i, cudaStream_t stream) {
  const int blocks = (Q + kQueries - 1) / kQueries;
  knn_kernel<K><<<blocks, kQueries, 0, stream>>>(q, qm, r, rm, active, Q, N,
                                                 d, i);
}

}  // namespace

// query [Q, 3] f32, qmask [Q] bool, ref [N, 3] f32, rmask [N] bool,
// active [2] int32 = (1 + last live query, 1 + last live ref) on the device;
// d [Q, k] f32 and idx [Q, k] int32 out.  Returns cudaGetLastError() after
// the launch, or -1 for k outside 1..8.
extern "C" int alego_knn(const float* q, const uint8_t* qm, const float* r,
                         const uint8_t* rm, const int32_t* active, int Q,
                         int N, int k, float* d, int32_t* i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: launch<1>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 2: launch<2>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 3: launch<3>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 4: launch<4>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 5: launch<5>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 6: launch<6>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 7: launch<7>(q, qm, r, rm, active, Q, N, d, i, s); break;
    case 8: launch<8>(q, qm, r, rm, active, Q, N, d, i, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
