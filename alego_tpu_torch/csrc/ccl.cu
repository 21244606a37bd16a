// Connected-component labelling of the range image, iterated to the exact
// fixpoint inside ONE thread block.
//
// Replaces: alego_tpu/ops/pallas_ccl.py, ccl_fixpoint_pallas / _ccl_kernel
// (the whole CCL fixpoint as one VMEM-resident Pallas program).
//
// Computes: component-min flat-index labels [R, H] int32 of the 4-connected
// image whose edges are conn_right[r][c] (c <-> c+1 mod H, circular columns)
// and conn_up[r][c] (row r <-> r+1).  Pixels without edges keep their own
// flat index, exactly as the reference's fixpoint.
//
// What bounds it on this card: neither bytes (~0.1 MB in, 0.26 MB out) nor
// arithmetic (~20 rounds x 64k pixels of integer min).  It is a chain of
// ~20 dependent rounds, each of which needs the whole image: latency and
// synchronisation bound.  The TPU kernel kept the image in VMEM for the same
// reason; an XLA-style loop of separate launches would pay a launch and a
// device-memory round trip per round.
//
// Design: labels < R*H = 64000 < 2^16, so the whole image fits as uint16 in
// 125 KiB of shared memory and the two edge masks fit as bits in 15.5 KB:
// one block of 1024 threads holds the entire fixpoint on one SM, with a
// shared "changed" flag ending the loop, and no host synchronisation.  Each
// round: a warp per row runs a segmented min-scan along the row forward and
// backward (32 columns per step, shuffles), starting from the value across
// the column seam so runs that wrap at column H-1 -> 0 join; then a thread
// per column sweeps the rings down and up.  Component-min labels do not
// depend on the schedule (pallas_ccl.py:10-19), so this gives the same
// labels as the Pallas kernel.  Only one SM works: the later redesign
// (several blocks with distributed shared memory, or fewer rounds) is
// queued in ROADMAP.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr unsigned kBig = 0xFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ bool edge(const uint32_t* bits, int c) {
  return (bits[c >> 5] >> (c & 31)) & 1u;
}

// One pass of a segmented min-scan along a circular row.  Position i of the
// pass visits column col(i); linked(i) says whether col(i) is joined to the
// column visited before it.  Returns whether any label dropped.
template <bool kForward>
__device__ bool row_pass(unsigned short* row, const uint32_t* rb, int H,
                         bool seam, int lane) {
  bool any = false;
  unsigned carry = seam ? row[kForward ? H - 1 : 0] : kBig;
  for (int base = 0; base < H; base += 32) {
    const int i = base + lane;
    const int c = kForward ? i : H - 1 - i;
    unsigned v = kBig;
    bool head = true;
    if (i < H) {
      v = row[c];
      if (kForward)
        head = c == 0 ? !seam : !edge(rb, c - 1);
      else
        head = c == H - 1 ? !seam : !edge(rb, c);
    }
    const unsigned old = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned ov = __shfl_up_sync(kFull, v, off);
      const int oh = __shfl_up_sync(kFull, (int)head, off);
      if (lane >= off) {
        if (!head) v = min(v, ov);
        head = head || oh;
      }
    }
    if (!head) v = min(v, carry);
    carry = __shfl_sync(kFull, v, 31);
    if (i < H && v < old) {
      row[c] = (unsigned short)v;
      any = true;
    }
  }
  __syncwarp();
  return any;
}

__global__ void __launch_bounds__(kThreads)
ccl_kernel(const uint8_t* __restrict__ conn_right,
           const uint8_t* __restrict__ conn_up, int R, int H, int max_rounds,
           int32_t* __restrict__ labels_out, int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int changed;
  const int words = (H + 31) >> 5;
  uint32_t* right = reinterpret_cast<uint32_t*>(smem);
  uint32_t* up = right + R * words;
  unsigned short* lab =
      reinterpret_cast<unsigned short*>(up + (R - 1) * words);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // pack the edge masks into bits: one 32-bit word per warp ballot
  for (int w = warp; w < R * words; w += nwarps) {
    const int r = w / words, c = (w % words) * 32 + lane;
    const unsigned b = __ballot_sync(kFull, c < H && conn_right[r * H + c]);
    if (lane == 0) right[w] = b;
  }
  for (int w = warp; w < (R - 1) * words; w += nwarps) {
    const int r = w / words, c = (w % words) * 32 + lane;
    const unsigned b = __ballot_sync(kFull, c < H && conn_up[r * H + c]);
    if (lane == 0) up[w] = b;
  }
  for (int i = tid; i < R * H; i += blockDim.x) lab[i] = (unsigned short)i;
  __syncthreads();

  int round = 0;
  for (;;) {
    if (tid == 0) changed = 0;
    __syncthreads();
    // horizontal: a warp per ring, forward then backward segmented min-scan
    for (int r = warp; r < R; r += nwarps) {
      unsigned short* row = lab + r * H;
      const uint32_t* rb = right + r * words;
      const bool seam = edge(rb, H - 1);
      bool any = row_pass<true>(row, rb, H, seam, lane);
      any |= row_pass<false>(row, rb, H, seam, lane);
      if (any) changed = 1;
    }
    __syncthreads();
    // vertical: a thread per column, complete down + up chain collapse
    for (int c = tid; c < H; c += blockDim.x) {
      bool any = false;
      unsigned prev = lab[c];
      for (int r = 1; r < R; ++r) {
        unsigned v = lab[r * H + c];
        if (edge(up + (r - 1) * words, c) && prev < v) {
          v = prev;
          lab[r * H + c] = (unsigned short)v;
          any = true;
        }
        prev = v;
      }
      for (int r = R - 2; r >= 0; --r) {
        unsigned v = lab[r * H + c];
        if (edge(up + r * words, c) && prev < v) {
          v = prev;
          lab[r * H + c] = (unsigned short)v;
          any = true;
        }
        prev = v;
      }
      if (any) changed = 1;
    }
    __syncthreads();
    const int ch = changed;
    ++round;
    __syncthreads();  // every thread has read the flag before it is reset
    if (!ch || round >= max_rounds) break;
  }

  for (int i = tid; i < R * H; i += blockDim.x) labels_out[i] = lab[i];
  if (tid == 0) *rounds_out = round;
}

}  // namespace

// labels [R, H] int32 out; rounds [1] int32 out (rounds run; max_rounds
// means the bound stopped it).  Returns cudaGetLastError() after the launch.
extern "C" int alego_ccl(const uint8_t* conn_right, const uint8_t* conn_up,
                         int R, int H, int max_rounds, int32_t* labels,
                         int32_t* rounds, void* stream) {
  // edge bits (2R-1 rows of 32-bit words) + uint16 labels
  const size_t smem =
      (2 * (size_t)R - 1) * ((H + 31) >> 5) * 4 + (size_t)R * H * 2;
  cudaError_t err = cudaFuncSetAttribute(
      ccl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ccl_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      conn_right, conn_up, R, H, max_rounds, labels, rounds);
  return (int)cudaGetLastError();
}
