// Connected-component labelling of the range image by union-find across
// the card, in three short kernels and no fixpoint rounds.
//
// Replaces: alego_tpu/ops/pallas_ccl.py, ccl_fixpoint_pallas / _ccl_kernel
// (the whole CCL fixpoint as one VMEM-resident Pallas program).
//
// Computes: component-min flat-index labels [R, H] int32 of the 4-connected
// image whose edges are conn_right[r][c] (c <-> c+1 mod H, circular columns)
// and conn_up[r][c] (row r <-> r+1).  Pixels without edges keep their own
// flat index, exactly as the reference's fixpoint.
//
// Union-find with min-root linking: a root is only ever hooked under a
// smaller root (atomicMin on int32 parents), so every parent is <= its child
// and the one root left in each component is its smallest flat index.  The
// labels are therefore the component-min labelling of the reference whatever
// order the threads run in.  find() reads parents through volatile loads,
// since other threads lower them concurrently.
//
// What bounds it on this card: neither bytes (~0.1 MB of edges in, 0.26 MB
// of labels out) nor operations (a few per pixel).  What is left once the
// fixpoint rounds are gone is launch and memory latency: three dependent
// kernels, and the find chains that cross tiles (one hop per tile a
// component spans, each an L2 read).  The design keeps every pass one
// launch wide, with no loop over rounds and no host synchronisation:
//   1. ccl_tiles: a block per tile of all R rows x kTileW columns links the
//      tile's own edges in shared memory (horizontal runs by warp ballots,
//      the rest by unions), flattens the tile and writes each pixel's
//      global parent (its tile root, as a flat index) into labels;
//   2. ccl_seams: a thread per (tile border, row) links the conn_right edges
//      that cross tile borders, the circular one from column H-1 to 0
//      included, in the int32 parents in device memory (L2-resident);
//   3. ccl_flatten: a thread per pixel replaces its parent by its root.
// The labels tensor is the parent array: the kernels allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileW = 64;       // columns per tile (a tile spans all rows)
constexpr int kMaxThreads = 1024;
constexpr int kSeamThreads = 256;
constexpr int kFlatThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int find_root(volatile int* parent, int i) {
  int p = parent[i];
  while (p != i) {
    i = p;
    p = parent[i];
  }
  return i;
}

// Join the sets of a and b: hook the larger root under the smaller.  When
// the atomicMin finds b no longer a root (another thread hooked it to
// `old` first), it may have moved b's link from `old` to a; joining a with
// `old` next restores that link, so no connection is lost.
__device__ void unite(int* parent, int a, int b) {
  for (;;) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
ccl_tiles(const uint8_t* __restrict__ conn_right,
          const uint8_t* __restrict__ conn_up, int R, int H,
          int32_t* __restrict__ labels) {
  extern __shared__ int sp[];  // [R, kTileW] tile-local parents
  const int c0 = blockIdx.x * kTileW;
  const int tw = min(kTileW, H - c0);
  const int n = R * kTileW;

  // Local index r * kTileW + lc orders pixels as their flat index r * H + c
  // does, so the tile's min-root is the min flat index of its piece.  A
  // warp holds 32 columns of one row: each pixel's first parent is the head
  // of its horizontal run within the warp (a ballot of run heads), so runs
  // need no unions; a run that enters the warp from the left starts at the
  // warp's first pixel, which is joined to its left neighbour below.  n and
  // blockDim.x are multiples of 32, so every lane runs every ballot.
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lc = i % kTileW, lane = i & 31;
    const bool joined =
        lc > 0 && lc < tw && conn_right[(i / kTileW) * H + c0 + lc - 1];
    const unsigned below = __ballot_sync(kFull, !joined) & (kFull >> (31 - lane));
    sp[i] = i - lane + (below ? 31 - __clz(below) : 0);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / kTileW, lc = i - r * kTileW;
    if (lc >= tw) continue;
    const int g = r * H + c0 + lc;
    if ((i & 31) == 0 && lc > 0 && conn_right[g - 1]) unite(sp, i - 1, i);
    if (r + 1 < R && conn_up[g]) unite(sp, i, i + kTileW);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / kTileW, lc = i - r * kTileW;
    if (lc >= tw) continue;
    const int root = find_root(sp, i);
    const int rr = root / kTileW;
    labels[r * H + c0 + lc] = rr * H + c0 + (root - rr * kTileW);
  }
}

__global__ void __launch_bounds__(kSeamThreads)
ccl_seams(const uint8_t* __restrict__ conn_right, int R, int H, int tiles,
          int32_t* labels) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tiles * R) return;
  const int tile = t / R, r = t - tile * R;
  const int c = min((tile + 1) * kTileW, H) - 1;  // the tile's last column
  if (conn_right[r * H + c])
    unite(labels, r * H + c, r * H + (c + 1 == H ? 0 : c + 1));
}

__global__ void __launch_bounds__(kFlatThreads)
ccl_flatten(int n, int32_t* labels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a concurrent reader sees the old parent or the root: both ancestors
  if (i < n) labels[i] = find_root(labels, i);
}

}  // namespace

// conn_right [R, H] and conn_up [R-1, H] bool (one byte each); labels
// [R, H] int32 out, also the kernels' parent array.  Needs R * H < 2^31 and
// R * kTileW * 4 bytes of shared memory.  Returns cudaGetLastError() after
// the launches.
extern "C" int alego_ccl(const uint8_t* conn_right, const uint8_t* conn_up,
                         int R, int H, int32_t* labels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (H + kTileW - 1) / kTileW;
  const int n = R * kTileW;
  const int threads = min(kMaxThreads, n);  // n is a multiple of 32
  const size_t smem = (size_t)n * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ccl_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  ccl_tiles<<<tiles, threads, smem, s>>>(conn_right, conn_up, R, H, labels);
  ccl_seams<<<(tiles * R + kSeamThreads - 1) / kSeamThreads, kSeamThreads, 0,
              s>>>(conn_right, R, H, tiles, labels);
  ccl_flatten<<<(R * H + kFlatThreads - 1) / kFlatThreads, kFlatThreads, 0,
                s>>>(R * H, labels);
  return (int)cudaGetLastError();
}
