// One whole masked Gauss-Newton solve over a batch of kind-tagged residual
// rows (ops/residuals.py Correspondences), in one launch of a thread-block
// cluster.
//
// Replaces no TPU kernel.  The reference runs each solve as a
// lax.while_loop (alego_tpu/ops/gauss_newton.py solve_gn) that XLA fuses
// into a few device programs per iteration; the port ran the same loop op
// by op, some 300-500 small device ops per iteration, about 80% of a
// frame's device ops.  This kernel is the port's counterpart of that fused
// loop: ops/gauss_newton.py solve_correspondences_plain (solve_gn over
// eval_correspondences) is its plain version.
//
// What bounds it on this card: neither bytes (at most 4096 rows x 60 bytes
// on the frame's solves) nor operations (~200 per row and iteration) but
// the chain of each iteration: rows -> reduction -> the 6x6 solve -> the
// next iteration's rotation, a few microseconds of latency.  The design
// shortens each link:
//   * the rows on a cluster of up to 8 blocks (the portable cluster size;
//     gauss_newton.gn_plan: one block per 256 rows), block b owning batch
//     rows [b * chunk, min((b + 1) * chunk, N)) and the last block also the
//     prior's 6 rows (prior_weight > 0), so the 4096-row mapping solve is
//     two rows a thread on 8 SMs.  256 threads a block, not 512: the same
//     time an iteration on the H100, and 255 registers a thread instead
//     of 128, so nothing spills;
//   * each block copies its rows into shared memory once per solve (TMA
//     bulk copies for the 16-byte aligned part of each field, plain loads
//     for the rest); every iteration reads them there.  A block stages at
//     most kStageRows rows; rows past that (batches of more than
//     8 x kStageRows rows) are read from global memory;
//   * each thread evaluates its rows' residual and Jacobian by kind (0
//     line, 1 plane from 3 points, 2 fitted plane), multiplies the Jacobian
//     by its kind's column mask, drops a non-finite row, applies the Huber
//     weight, and accumulates its share of the 21 entries of H (upper
//     triangle), the 6 of g and the count of rows with weight > 0 in f64;
//     a warp sums them by a butterfly that halves the values each lane
//     keeps at every step (31 shuffles; lane l ends with sum l), then a
//     block sums its warps in order;
//   * each block writes its 28 sums into every block's shared memory
//     (distributed shared memory), then one cluster barrier; every block
//     sums the blocks in rank order and finishes the iteration itself: the
//     same operations on the same values, so the blocks hold the same
//     params and the stop is uniform, with one cluster barrier an iteration
//     and no broadcast.  The sums alternate between two buffers, so a block
//     that runs ahead writes where no block still reads; every remote write
//     lands before the barrier that follows it, so a block may exit after
//     its last barrier without another;
//   * warp 0 finishes the iteration in registers as gauss_newton.gn_step
//     and solve_gn do: dim mask and identity block, damping, a 6x6 LU with
//     partial pivoting (lane a holds row a; the pivot found from the
//     column's shuffles, the elimination row-parallel, each element's
//     operations in the order of a serial LU; a zero pivot means no step,
//     as solve_ex's info), the min_count and finite tests, the degeneracy
//     projector, the max_step cap and the param_tol stop, which ends the
//     loop (past it the plain loop's update is a masked no-op); then the
//     next R and its rpy partials from one sincos per angle, on 4 lanes.
// The projector (eig_floor > 0) is built once, from the first iteration's
// H at params0: gauss_newton.eigh6's cyclic Jacobi in f64 (JACOBI_SWEEPS
// sweeps of the same 5 rounds of 3 disjoint rotations, each angle
// atan2(2 a_pq sgn(d), |d|) / 2), on warp 0: lane r holds row r of A and
// of V, each round's 3 angles run on the lanes of their pairs at once and
// the row and column updates are lane-parallel, each element updated in
// the order of the serial rotations; then P = V diag(lam > floor) V^T in
// f32.  Sines and cosines come from sincospi in f64 (an exact reduction:
// sincos and sincosf have a slow path with a table in local memory; this
// kernel has no stack frame).
//
// Accumulation type: each row's residual, Jacobian and weights in f32, as
// the plain version computes them; the products of H and g and their sums
// in f64 (each product of two f32 is exact), rounded once to f32 before
// the solve, which is f32 as in the plain version.  The order of the sums
// is fixed (thread, warp, block, cluster rank) and no atomics are used, so
// two launches agree bit for bit; the plain version's f32 matrix products
// sum in their own order, so the two agree to f32 rounding of the sums.
//
// The kernel reads params0 and writes the answer in device memory and
// allocates nothing, so it is captured into the frame's CUDA graphs as it
// is.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 8;      // the portable cluster size (gauss_newton.GN_MAX_BLOCKS)
constexpr int kSums = 28;          // H upper triangle (21), g (6), count of weight > 0
constexpr int kStageRows = 3456;   // rows a block stages: 3456 x 60 bytes = 202.5 KiB
constexpr int kRowFloats = 15;     // a staged row: cp, pj, pl, pm [3], scalar, weight, kind
constexpr float kEps = 1e-9f;      // residuals.EPS
constexpr int kJacobiSweeps = 6;   // gauss_newton.JACOBI_SWEEPS
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr double kInvPi = 0.318309886183790671538;

// gauss_newton._JACOBI_ROUNDS: the 15 pairs of a 6x6 matrix in 5 rounds of
// 3 disjoint pairs, round r as the nibbles p0 q0 p1 q1 p2 q2 (functions,
// so that unrolled loops index registers with constants)
__host__ __device__ constexpr int round_pairs(int r) {
  return r == 0 ? 0x012534 : r == 1 ? 0x021345 : r == 2 ? 0x032415 : r == 3 ? 0x043512 : 0x051423;
}
__host__ __device__ constexpr int pair_p(int r, int k) {
  return (round_pairs(r) >> (20 - 8 * k)) & 15;
}
__host__ __device__ constexpr int pair_q(int r, int k) {
  return (round_pairs(r) >> (16 - 8 * k)) & 15;
}

// the Correspondences fields from a row on
struct Rows {
  const float *cp, *pj, *pl, *pm, *scalar, *weight;
  const int32_t* kind;
};

struct Row {
  float cp[3], pj[3], pl[3], pm[3], scalar, weight;
  int kind;
};

struct Shared {
  float p[6];     // the current params
  float p0[6];    // params0 (the prior's anchor)
  float R[9];     // rpy_to_rot(p[3:6]), row-major
  float D[27];    // D[a][i][j]: d(R cp)_i / d rpy_a = sum_j D[a][i][j] cp_j
  float P[36];    // the degeneracy projector
  float Vf[36];   // the projector's eigenvectors in f32, and which it keeps
  float keep[6];
  float cols[18];  // kind_cols, or ones
  float mask[6];   // dim_mask
  double part[kWarps][kSums];
  double sums[2][kMaxBlocks][kSums];  // each block's sums, by iteration parity
  unsigned long long bar;             // the staging copies' mbarrier
  int live;
  int done;       // iterations run
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// c ? a : b on values.  A plain ?: between two elements of a register
// array can be folded into one load through a selected address, which
// puts the array in local memory (a stack frame); the PTX select cannot.
__device__ __forceinline__ double choose(bool c, double a, double b) {
  double r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f64 %0, %1, %2, q;\n\t}"
      : "=d"(r)
      : "d"(a), "d"(b), "r"((int)c));
  return r;
}

__device__ __forceinline__ float choose(bool c, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)c));
  return r;
}

// ---- staging: TMA bulk copies completing on an mbarrier ----

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar) {
  uint32_t ok = 0;
  while (!ok)
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(ok)
        : "r"(bar)
        : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// floats of n that the bulk copy takes: the 16-byte part of an aligned source
__device__ __forceinline__ int bulk_floats(const float* src, int n) {
  return ((uintptr_t)src & 15) == 0 ? (n & ~3) : 0;
}

// Copy the block's first `n` rows of the 7 fields into shared memory at
// dyn (`stage` rows a field, in the order of Rows): thread 0 issues the
// bulk copies, every thread copies the rest; the caller waits on the
// mbarrier after a block barrier.  Returns the rows in shared memory.
__device__ __forceinline__ Rows stage_rows(const Rows& g, float* dyn, int stage, int n,
                                           uint32_t bar, int tid) {
  const float* src[7] = {g.cp, g.pj, g.pl, g.pm, g.scalar, g.weight,
                         reinterpret_cast<const float*>(g.kind)};
  float* dst[7] = {dyn, dyn + 3 * stage, dyn + 6 * stage, dyn + 9 * stage, dyn + 12 * stage,
                   dyn + 13 * stage, dyn + 14 * stage};
  if (tid == 0) {
    mbar_init(bar);
    uint32_t bytes = 0;
#pragma unroll
    for (int f = 0; f < 7; ++f) bytes += 4u * bulk_floats(src[f], f < 4 ? 3 * n : n);
    mbar_expect(bar, bytes);
#pragma unroll
    for (int f = 0; f < 7; ++f) {
      const int b = bulk_floats(src[f], f < 4 ? 3 * n : n);
      if (b > 0) bulk_copy(dst[f], src[f], 4u * b, bar);
    }
  }
#pragma unroll
  for (int f = 0; f < 7; ++f) {
    const int m = f < 4 ? 3 * n : n;
    for (int k = bulk_floats(src[f], m) + tid; k < m; k += kThreads) dst[f][k] = src[f][k];
  }
  return {dst[0], dst[1], dst[2], dst[3], dst[4], dst[5], reinterpret_cast<int32_t*>(dst[6])};
}

// ---- one row ----

__device__ __forceinline__ bool finite6(const float* x) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 6; ++c) ok = ok && isfinite(x[c]);
  return ok;
}

// max |x| over 6 that propagates NaN, as torch.max does
__device__ __forceinline__ float absmax6(const float* x) {
  float m = fabsf(x[0]);
#pragma unroll
  for (int c = 1; c < 6; ++c) {
    const float a = fabsf(x[c]);
    if (a > m || a != a) m = (m != m) ? m : a;
  }
  return m;
}

__device__ __forceinline__ float huber(float r, float delta) {
  const float a = fabsf(r);
  return a <= delta ? 1.f : delta / fmaxf(a, 1e-12f);
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void load_row(const Rows& b, int i, Row& w) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w.cp[a] = b.cp[3 * i + a];
    w.pj[a] = b.pj[3 * i + a];
    w.pl[a] = b.pl[3 * i + a];
    w.pm[a] = b.pm[3 * i + a];
  }
  w.scalar = b.scalar[i];
  w.weight = b.weight[i];
  w.kind = b.kind[i];
}

// A row at the params in s: residual r and Jacobian J, the kind's column
// mask applied (eval_correspondences, solve_correspondences)
__device__ __forceinline__ void eval_row(const Shared& s, const Row& w, float& r, float* J) {
  float lp[3], dl[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lp[a] = (w.cp[0] * s.R[3 * a] + w.cp[1] * s.R[3 * a + 1] + w.cp[2] * s.R[3 * a + 2]) + s.p[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) {  // d lp_a / d rpy_b
      const float* d = s.D + 9 * b + 3 * a;
      dl[a][b] = d[0] * w.cp[0] + d[1] * w.cp[1] + d[2] * w.cp[2];
    }
  }
  const int k = w.kind;
  float e[3];
  float scale = 1.f;  // the line's 1 / |pj - pl|, as a quotient
  if (k == 0) {       // point to line
    float u[3], v[3], q[3], c[3], qc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      u[a] = lp[a] - w.pj[a];
      v[a] = lp[a] - w.pl[a];
      q[a] = w.pj[a] - w.pl[a];
    }
    const float kk = sqrtf(dot3(q, q) + kEps);
    cross(u, v, c);
    const float m = sqrtf(dot3(c, c) + kEps);
    r = m / kk;
    cross(q, c, qc);
#pragma unroll
    for (int a = 0; a < 3; ++a) e[a] = qc[a] / m;
    scale = kk;
  } else if (k == 1) {  // point to the plane of 3 points
    float a1[3], a2[3], n[3], d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      a1[a] = w.pj[a] - w.pl[a];
      a2[a] = w.pj[a] - w.pm[a];
      d[a] = lp[a] - w.pj[a];
    }
    cross(a1, a2, n);
    const float nn = sqrtf(dot3(n, n) + kEps);
    const float signed_r = dot3(d, n) / nn;
    const float sg = signed_r > 0.f ? 1.f : (signed_r < 0.f ? -1.f : 0.f);
#pragma unroll
    for (int a = 0; a < 3; ++a) e[a] = sg * n[a] / nn;
    r = fabsf(signed_r);
  } else {  // point to a fitted plane: pj the unit normal, scalar d0
    r = dot3(w.pj, lp) + w.scalar;
#pragma unroll
    for (int a = 0; a < 3; ++a) e[a] = w.pj[a];
  }
  const float* cols = s.cols + 6 * (k == 0 ? 0 : (k == 1 ? 1 : 2));
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float j = c < 3 ? e[c] : (e[0] * dl[0][c - 3] + e[1] * dl[1][c - 3]) + e[2] * dl[2][c - 3];
    if (k == 0) j = j / scale;
    J[c] = j * cols[c];
  }
}

// One step of warp_sums: the lanes with bit O keep the upper O of their
// 2 O values, the others the lower O, and each adds its partner's half.
// (Loops in this file have constant trip counts: nvcc leaves a loop whose
// bound depends on an outer loop's index rolled, and a register array it
// indexes goes to local memory.)
template <int O>
__device__ __forceinline__ void butterfly(double (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const double send = choose(upper, v[i], v[i + O]);
    const double keep = choose(upper, v[i + O], v[i]);
    v[i] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// The warp's sums of v[0..31] (28 sums and 4 zeros): lane l ends with the
// warp's sum l (31 shuffles, in a fixed order)
__device__ __forceinline__ double warp_sums(double (&v)[32], int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// ---- warp 0: the 6x6 algebra ----

// sin and cos of an f32 angle: sincospi of x / pi in f64, rounded once to
// f32 (sincosf's reduction of |x| >= 105615 keeps a table in local memory;
// sincospi's reduction is exact, and x / pi in f64 is accurate far past
// any angle a solve meets)
__device__ __forceinline__ void sincos_f32(float x, float* s, float* c) {
  double sd, cd;
  sincospi((double)x * kInvPi, &sd, &cd);
  *s = (float)sd;
  *c = (float)cd;
}

// R and its rpy partials at p (se3.rpy_to_rot, se3.drotp_drpy) into s, by
// the whole warp: lanes 0-2 the sine and cosine of one angle each, lanes
// 0-3 nine entries each
__device__ __forceinline__ void rotation(Shared& s, const float* p, int lane) {
  float sn = 0.f, cs = 1.f;
  if (lane < 3)
    sincos_f32(choose(lane == 0, p[3], choose(lane == 1, p[4], p[5])), &sn, &cs);
  const float sr = __shfl_sync(kFull, sn, 0), cr = __shfl_sync(kFull, cs, 0);
  const float sp = __shfl_sync(kFull, sn, 1), cp = __shfl_sync(kFull, cs, 1);
  const float sy = __shfl_sync(kFull, sn, 2), cy = __shfl_sync(kFull, cs, 2);
  if (lane == 0) {
    const float R[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                        -sp,     cp * sr,                cp * cr};
#pragma unroll
    for (int k = 0; k < 9; ++k) s.R[k] = R[k];
  } else if (lane == 1) {  // d/droll: rows x, y, z; columns px, py, pz
    const float D[9] = {0.f, cy * sp * cr + sr * sy, sy * cr - cy * sr * sp,
                        0.f, -cy * sr + sy * sp * cr, -sr * sy * sp - cy * cr,
                        0.f, cp * cr, -cp * sr};
#pragma unroll
    for (int k = 0; k < 9; ++k) s.D[k] = D[k];
  } else if (lane == 2) {  // d/dpitch
    const float D[9] = {-cy * sp, cy * cp * sr, cy * cr * cp,
                        -sp * sy, sy * cp * sr, sy * cp * cr,
                        -cp, -sp * sr, -sp * cr};
#pragma unroll
    for (int k = 0; k < 9; ++k) s.D[9 + k] = D[k];
  } else if (lane == 3) {  // d/dyaw
    const float D[9] = {-sy * cp, -(sy * sp * sr + cr * cy), cy * sr - sy * cr * sp,
                        cp * cy, -sy * cr + cy * sp * sr, cy * cr * sp + sy * sr,
                        0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 9; ++k) s.D[18 + k] = D[k];
  }
}

// x[i] for a lane-dependent i, by selects (no local memory)
__device__ __forceinline__ double pick(const double* x, int i) {
  double v = x[0];
#pragma unroll
  for (int c = 1; c < 6; ++c) v = choose(i == c, x[c], v);
  return v;
}

// X <- X J on this lane's row for the rotation of pair (p, q):
// J[p][p] = J[q][q] = c, J[p][q] = s, J[q][p] = -s
__device__ __forceinline__ void rotate_cols(double* X, int p, int q, double c, double s) {
  const double xp = X[p], xq = X[q];
  X[p] = xp * c - xq * s;
  X[q] = xp * s + xq * c;
}

// degeneracy_projector(H0, floor) into s.P (gauss_newton.eigh6 in f64):
// lane r holds row r of the masked H0 (h), of A and of V (lanes 6-31 a
// copy of row 5).  In each round every lane computes the angle of its
// row's pair; an element of A takes the column rotation of its column's
// pair and the row rotation of its row's pair in the order of the serial
// rotations (pair 0, 1, 2; columns before rows within a pair).
__device__ __forceinline__ void projector(const float* h, int r, int lane, double floor,
                                          Shared& s) {
  const bool finite = __all_sync(kFull, finite6(h));
  double A[6], V[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    A[c] = finite ? (double)h[c] : (c == r ? 1.0 : 0.0);
    V[c] = c == r ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
#pragma unroll
    for (int round = 0; round < 5; ++round) {
      int kr = 0, partner = 0;  // this row's pair and the pair's other row
      bool is_p = false;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (r == pair_p(round, k)) kr = k, partner = pair_q(round, k), is_p = true;
        if (r == pair_q(round, k)) kr = k, partner = pair_p(round, k), is_p = false;
      }
      const int p = is_p ? r : partner, q = is_p ? partner : r;
      const double diag = pick(A, r), off = pick(A, partner);
      const double app = __shfl_sync(kFull, diag, p), aqq = __shfl_sync(kFull, diag, q);
      const double apq = __shfl_sync(kFull, off, p);
      const double d = aqq - app;
      const double y = copysign(apq, apq * d);
      const double phi = atan2(y + y, fabs(d));
      double sn, cs;
      sincospi(0.5 * phi * kInvPi, &sn, &cs);
      double c[3], sk[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        c[k] = __shfl_sync(kFull, cs, pair_p(round, k));
        sk[k] = __shfl_sync(kFull, sn, pair_p(round, k));
      }
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k <= kr) rotate_cols(A, pair_p(round, k), pair_q(round, k), c[k], sk[k]);
      double other[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) other[j] = __shfl_sync(kFull, A[j], partner);
#pragma unroll
      for (int j = 0; j < 6; ++j)  // J^T X on rows p, q
        A[j] = is_p ? cs * A[j] - sn * other[j] : sn * other[j] + cs * A[j];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (k > kr) rotate_cols(A, pair_p(round, k), pair_q(round, k), c[k], sk[k]);
        rotate_cols(V, pair_p(round, k), pair_q(round, k), c[k], sk[k]);
      }
    }
  }
  if (lane < 6) {
#pragma unroll
    for (int c = 0; c < 6; ++c) s.Vf[6 * r + c] = (float)V[c];
    s.keep[r] = (pick(A, r) > floor && finite) ? 1.f : 0.f;
  }
  __syncwarp();
  if (lane < 6) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += (s.Vf[6 * r + k] * s.keep[k]) * s.Vf[6 * b + k];
      s.P[6 * r + b] = acc;
    }
  }
  __syncwarp();
}

// Warp 0 ends iteration `it` from the totals (lane l < 28 holds sum l):
// the update of the params, the stop test and the next rotation, into s.
__device__ __forceinline__ void finish_iteration(Shared& s, double tot, int it, int lane,
                                                 bool use_proj, double eig_floor, float damping,
                                                 int mc, float param_tol, double max_step) {
  const int r = min(lane, 5);  // lane r holds row r of H and of the system
  const float mr = s.mask[r];
  float h[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const int a = min(r, c), b = max(r, c);
    h[c] = (float)__shfl_sync(kFull, tot, 6 * a - a * (a - 1) / 2 + b - a);
    // masked dims: an identity block in H and a zero gradient
    h[c] = h[c] * (mr * s.mask[c]) + (r == c ? 1.f - mr : 0.f);
  }
  const float g = (float)__shfl_sync(kFull, tot, 21 + r);
  const double count = __shfl_sync(kFull, tot, 27);
  if (it == 0 && use_proj) projector(h, r, lane, eig_floor, s);
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (c == r) h[c] = h[c] + damping;
  float x = g * mr;

  // LU with partial pivoting, lane a holding row a (lu_solve6's order)
  bool solved = true;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float col[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) col[i] = __shfl_sync(kFull, h[k], i);
    int piv = k;
    float best = fabsf(col[k]), pv = col[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i <= k) continue;
      const float a = fabsf(col[i]);
      const bool more = a > best;
      best = choose(more, a, best);
      pv = choose(more, col[i], pv);
      piv = more ? i : piv;
    }
    if (pv == 0.f) {  // solve_ex's info != 0: no step
      solved = false;
      continue;
    }
    if (piv != k) {
      const int src = r == k ? piv : (r == piv ? k : r);
#pragma unroll
      for (int j = 0; j < 6; ++j) h[j] = __shfl_sync(kFull, h[j], src);
      x = __shfl_sync(kFull, x, src);
    }
    float rowk[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) rowk[j] = j < k ? 0.f : __shfl_sync(kFull, h[j], k);
    const float bk = __shfl_sync(kFull, x, k);
    if (r > k) {
      const float l = h[k] / rowk[k];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        if (j > k) h[j] -= l * rowk[j];
      x -= l * bk;
    }
  }
  float xs[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xs[k] = __shfl_sync(kFull, x, k);
#pragma unroll
  for (int k = 5; k >= 0; --k) {  // back substitution, on every lane
    float acc = xs[k];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      if (j > k) acc -= __shfl_sync(kFull, h[j], k) * xs[j];
    xs[k] = acc / __shfl_sync(kFull, h[k], k);
  }

  // the step: the min_count and finite tests, the projector, the cap
  float p[6], delta[6], d[6], pn[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    p[a] = s.p[a];
    delta[a] = -xs[a];
  }
  const bool ok = count >= (double)mc && solved && finite6(delta);
#pragma unroll
  for (int a = 0; a < 6; ++a) d[a] = (p[a] + (ok ? delta[a] : 0.f)) - p[a];
  if (use_proj) {
    float e[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float v = 0.f;
#pragma unroll
      for (int b = 0; b < 6; ++b) v += s.P[6 * a + b] * d[b];
      e[a] = v;
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) d[a] = e[a];
  }
  if (max_step > 0.0) {
    const float sc = fminf((float)max_step / fmaxf(absmax6(d), 1e-12f), 1.f);
#pragma unroll
    for (int a = 0; a < 6; ++a) d[a] = d[a] * sc;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) pn[a] = p[a] + d[a];
#pragma unroll
  for (int a = 0; a < 6; ++a) d[a] = pn[a] - p[a];
  const float step = absmax6(d);
  __syncwarp();  // every lane has read s.p
  if (lane == 4) {
#pragma unroll
    for (int a = 0; a < 6; ++a) s.p[a] = pn[a];
    s.live = step > param_tol;
    s.done = it + 1;
  }
  rotation(s, pn, lane);
}

__global__ void __launch_bounds__(kThreads, 1)
gn_solve(Rows g, int N, int chunk, int stage, const float* __restrict__ kind_cols,
         const uint8_t* __restrict__ dim_mask, const float* __restrict__ params0,
         float* __restrict__ out, int32_t* __restrict__ iters_out, int iters, float huber_delta,
         float damping, int min_count, float param_tol, double eig_floor, double prior_weight,
         double max_step) {
  extern __shared__ __align__(16) float dyn[];
  __shared__ Shared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool use_prior = prior_weight > 0.0, use_proj = eig_floor > 0.0;
  const float sw = sqrtf((float)prior_weight);
  const int mc = min_count + (use_prior ? 6 : 0);

  // this block's batch rows, in global memory and (the first `staged`) in
  // shared memory; the last block also takes the prior's rows
  const int first = min(rank * chunk, N), mine = min(first + chunk, N) - first;
  const int staged = min(mine, stage);
  const int rows = mine + (use_prior && rank == blocks - 1 ? 6 : 0);
  const Rows gl = {g.cp + 3 * first, g.pj + 3 * first, g.pl + 3 * first, g.pm + 3 * first,
                   g.scalar + first, g.weight + first, g.kind + first};
  const uint32_t bar = smem_addr(&s.bar);
  const Rows sh = stage_rows(gl, dyn, stage, staged, bar, tid);
  if (warp == 0) {
    float p[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) p[c] = params0[c];
    if (lane < 6) {
      s.p[lane] = s.p0[lane] = params0[lane];
      s.mask[lane] = dim_mask[lane] ? 1.f : 0.f;
    }
    if (lane < 18) s.cols[lane] = kind_cols ? kind_cols[lane] : 1.f;
    if (lane == 0) {
      s.live = 1;
      s.done = 0;
    }
    rotation(s, p, lane);
  }
  cluster.sync();  // every block runs (before any remote write) and is set up
  mbar_wait(bar);

  for (int it = 0; it < iters; ++it) {
    double acc[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0;
    for (int j = tid; j < rows; j += kThreads) {
      float r, J[6], w;
      if (j < mine) {
        Row row;
        if (j < staged)
          load_row(sh, j, row);
        else
          load_row(gl, j, row);
        eval_row(s, row, r, J);
        w = row.weight;
      } else {  // the prior's rows: sqrt(w) (p - params0), sqrt(w) I
        const int c = j - mine;
        r = sw * (s.p[c] - s.p0[c]);
#pragma unroll
        for (int b = 0; b < 6; ++b) J[b] = b == c ? sw : 0.f;
        w = 1.f / fmaxf(huber(r, huber_delta), 1e-12f);
      }
      const bool ok = isfinite(r) && finite6(J);
      if (!ok) {
        r = 0.f;
#pragma unroll
        for (int b = 0; b < 6; ++b) J[b] = 0.f;
      }
      w = w * (ok ? 1.f : 0.f);
      const float wh = w * huber(r, huber_delta);
      float Jw[6];
#pragma unroll
      for (int b = 0; b < 6; ++b) Jw[b] = J[b] * wh;
      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b)
          if (b >= a) acc[k++] += (double)J[a] * (double)Jw[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += (double)Jw[a] * (double)r;
      acc[27] += w > 0.f ? 1.0 : 0.0;
    }
    const double v = warp_sums(acc, lane);
    if (lane < kSums) s.part[warp][lane] = v;
    __syncthreads();
    double tot = 0.0;
    if (warp == 0 && lane < kSums) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += s.part[w][lane];
    }
    if (blocks > 1) {  // every block's sums to every block, then sum them in rank order
      double* mine_sums = &s.sums[it & 1][rank][0];
      if (warp == 0 && lane < kSums)
        for (int b = 0; b < blocks; ++b) cluster.map_shared_rank(mine_sums, b)[lane] = tot;
      cluster.sync();
      if (warp == 0 && lane < kSums) {
        tot = 0.0;
        for (int b = 0; b < blocks; ++b) tot += s.sums[it & 1][b][lane];
      }
    }
    if (warp == 0)
      finish_iteration(s, tot, it, lane, use_proj, eig_floor, damping, mc, param_tol, max_step);
    __syncthreads();
    if (!s.live) break;
  }
  if (rank == 0) {
    if (tid < 6) out[tid] = s.p[tid];
    if (tid == 0 && iters_out) *iters_out = s.done;
  }
}

}  // namespace

// cp, pj, pl, pm [N, 3] f32, scalar [N] f32, kind [N] int32, weight [N]
// f32 (the Correspondences fields, contiguous); blocks (1-8) and chunk (a
// multiple of 4, blocks * chunk >= N): the cluster and the batch rows of
// each block (gauss_newton.gn_plan); kind_cols [3, 6] f32 or null (no
// column mask); dim_mask [6] bool; params0 [6] f32; out [6] f32;
// iters_out [1] int32 or null (the iterations run).  Returns the launch's
// error (cudaLaunchKernelEx, then cudaGetLastError()), or -1 for a bad
// argument.
extern "C" int alego_gn_solve(const float* cp, const float* pj, const float* pl,
                              const float* pm, const float* scalar, const int32_t* kind,
                              const float* weight, int N, int blocks, int chunk,
                              const float* kind_cols, const uint8_t* dim_mask,
                              const float* params0, float* out, int32_t* iters_out, int iters,
                              double huber_delta, double damping, int min_count,
                              double param_tol, double eig_floor, double prior_weight,
                              double max_step, void* stream) {
  if (N < 0 || iters < 0 || blocks < 1 || blocks > kMaxBlocks || chunk < 0 || chunk % 4 != 0 ||
      (long long)blocks * chunk < N)
    return -1;
  // the largest staging this kernel asks for, allowed once per device
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 32 && !(configured >> dev & 1u)) {
    err = cudaFuncSetAttribute(gn_solve, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kStageRows * kRowFloats * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const int stage = chunk < kStageRows ? chunk : kStageRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)stage * kRowFloats * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const Rows g = {cp, pj, pl, pm, scalar, weight, kind};
  err = cudaLaunchKernelEx(&cfg, gn_solve, g, N, chunk, stage, kind_cols, dim_mask, params0, out,
                           iters_out, iters, (float)huber_delta, (float)damping, min_count,
                           (float)param_tol, eig_floor, prior_weight, max_step);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
