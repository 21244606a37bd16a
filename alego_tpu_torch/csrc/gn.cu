// One whole masked Gauss-Newton solve over a batch of kind-tagged residual
// rows (ops/residuals.py Correspondences), in one launch of one block.
//
// Replaces no TPU kernel.  The reference runs each solve as a
// lax.while_loop (alego_tpu/ops/gauss_newton.py solve_gn) that XLA fuses
// into a few device programs per iteration; the port ran the same loop op
// by op, some 300-500 small device ops per iteration, about 80% of a
// frame's device ops.  This kernel is the port's counterpart of that fused
// loop: ops/gauss_newton.py solve_correspondences_plain (solve_gn over
// eval_correspondences) is its plain version.
//
// What bounds it on this card: neither bytes (at most 4096 rows x 60 bytes,
// read once per iteration, from L2 after the first) nor operations
// (~200 per row and iteration) but the serial chain of each iteration:
// rows -> block reduction -> one thread's 6x6 solve -> the next
// iteration's rotation.  So it is one block of kThreads threads (the
// frame's solves have 512, 768 and 4096 rows; several blocks would need a
// grid-wide reduction per iteration), a thread per row in turn:
//   * thread 0 turns params into R and the three 3x3 matrices of
//     d(R cp)/d(roll, pitch, yaw) (se3.rpy_to_rot, se3.drotp_drpy) in
//     shared memory;
//   * each thread evaluates its rows' residual and Jacobian by kind
//     (0 line, 1 plane from 3 points, 2 fitted plane), multiplies the
//     Jacobian by its kind's column mask, drops a non-finite row, applies
//     the Huber weight, and accumulates its share of the 21 entries of H
//     (upper triangle), the 6 of g and the count of rows with weight > 0;
//   * a warp-shuffle then shared-memory reduction in a fixed order (the
//     answer does not change from run to run);
//   * thread 0 finishes the iteration as gauss_newton.gn_step and solve_gn
//     do: dim mask and identity block, damping, a 6x6 LU with partial
//     pivoting (a zero pivot means no step, as solve_ex's info), the
//     min_count and finite tests, the degeneracy projector, the max_step
//     cap and the param_tol stop, which ends the loop (past it the plain
//     loop's update is a masked no-op).
// The projector (eig_floor > 0) is built once, from the first iteration's
// H at params0: gauss_newton.eigh6's cyclic Jacobi in f64 (JACOBI_SWEEPS
// sweeps of the same 5 rounds of 3 disjoint rotations), by thread 0, then
// P = V diag(lam > floor) V^T in f32.  The prior rows (prior_weight > 0)
// are 6 rows after the batch's.
//
// Accumulation type: each row's residual, Jacobian and weights in f32, as
// the plain version computes them; the products of H and g and their sums
// in f64, rounded once to f32 before the solve, which is f32 as in the
// plain version.  The plain version's f32 matrix products sum in their own
// order, so the two agree to f32 rounding of the sums, not bit for bit.
//
// The kernel reads params0 and writes the answer in device memory and
// allocates nothing, so it is captured into the frame's CUDA graphs as it
// is.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // H upper triangle (21), g (6), count of weight > 0
constexpr float kEps = 1e-9f;  // residuals.EPS
constexpr int kJacobiSweeps = 6;  // gauss_newton.JACOBI_SWEEPS

// gauss_newton._JACOBI_ROUNDS: the 15 pairs of a 6x6 matrix in 5 rounds of
// 3 disjoint pairs
__constant__ int kRounds[5][3][2] = {{{0, 1}, {2, 5}, {3, 4}},
                                     {{0, 2}, {1, 3}, {4, 5}},
                                     {{0, 3}, {2, 4}, {1, 5}},
                                     {{0, 4}, {3, 5}, {1, 2}},
                                     {{0, 5}, {1, 4}, {2, 3}}};

struct Shared {
  float p[6];    // the current params
  float p0[6];   // params0 (the prior's anchor)
  float R[9];    // rpy_to_rot(p[3:6]), row-major
  float D[27];   // D[a][i][j]: d(R cp)_i / d rpy_a = sum_j D[a][i][j] cp_j
  float P[36];   // the degeneracy projector
  double part[kWarps][kSums];
  double tot[kSums];
  int live;
  int done;      // iterations run
};

__device__ bool finite6(const float* x) {
  bool ok = true;
#pragma unroll
  for (int c = 0; c < 6; ++c) ok = ok && isfinite(x[c]);
  return ok;
}

// max |x| over 6 that propagates NaN, as torch.max does
__device__ float absmax6(const float* x) {
  float m = fabsf(x[0]);
  for (int c = 1; c < 6; ++c) {
    const float a = fabsf(x[c]);
    if (a > m || a != a) m = (m != m) ? m : a;
  }
  return m;
}

__device__ float huber(float r, float delta) {
  const float a = fabsf(r);
  return a <= delta ? 1.f : delta / fmaxf(a, 1e-12f);
}

// R and its rpy partials at p (se3.rpy_to_rot, se3.drotp_drpy)
__device__ void rotation(Shared& s) {
  const float sr = sinf(s.p[3]), cr = cosf(s.p[3]);
  const float sp = sinf(s.p[4]), cp = cosf(s.p[4]);
  const float sy = sinf(s.p[5]), cy = cosf(s.p[5]);
  const float R[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                      sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                      -sp,     cp * sr,                cp * cr};
  const float D[27] = {
      // d/droll: rows x, y, z; columns px, py, pz
      0.f, cy * sp * cr + sr * sy, sy * cr - cy * sr * sp,
      0.f, -cy * sr + sy * sp * cr, -sr * sy * sp - cy * cr,
      0.f, cp * cr, -cp * sr,
      // d/dpitch
      -cy * sp, cy * cp * sr, cy * cr * cp,
      -sp * sy, sy * cp * sr, sy * cp * cr,
      -cp, -sp * sr, -sp * cr,
      // d/dyaw
      -sy * cp, -(sy * sp * sr + cr * cy), cy * sr - sy * cr * sp,
      cp * cy, -sy * cr + cy * sp * sr, cy * cr * sp + sy * sr,
      0.f, 0.f, 0.f};
  for (int k = 0; k < 9; ++k) s.R[k] = R[k];
  for (int k = 0; k < 27; ++k) s.D[k] = D[k];
}

__device__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ void load3(const float* __restrict__ src, int i, float* x) {
  x[0] = src[3 * i];
  x[1] = src[3 * i + 1];
  x[2] = src[3 * i + 2];
}

// Row i of the batch at the params in s: residual r and Jacobian J, the
// kind's column mask applied (eval_correspondences, solve_correspondences)
__device__ void batch_row(const Shared& s, int i, const float* __restrict__ cp_,
                          const float* __restrict__ pj_, const float* __restrict__ pl_,
                          const float* __restrict__ pm_, const float* __restrict__ scalar,
                          const int32_t* __restrict__ kind,
                          const float* __restrict__ kind_cols, float& r, float* J) {
  float cp[3], lp[3], dl[3][3];
  load3(cp_, i, cp);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lp[a] = (cp[0] * s.R[3 * a] + cp[1] * s.R[3 * a + 1] + cp[2] * s.R[3 * a + 2]) + s.p[a];
#pragma unroll
    for (int b = 0; b < 3; ++b) {  // d lp_a / d rpy_b
      const float* d = s.D + 9 * b + 3 * a;
      dl[a][b] = d[0] * cp[0] + d[1] * cp[1] + d[2] * cp[2];
    }
  }
  const int k = kind[i];
  float e[3], pj[3];
  load3(pj_, i, pj);
  float scale = 1.f;  // the line's 1 / |pj - pl|, as a quotient
  if (k == 0) {  // point to line
    float pl[3], u[3], v[3], w[3], c[3], wc[3];
    load3(pl_, i, pl);
    for (int a = 0; a < 3; ++a) {
      u[a] = lp[a] - pj[a];
      v[a] = lp[a] - pl[a];
      w[a] = pj[a] - pl[a];
    }
    const float kk = sqrtf(dot3(w, w) + kEps);
    cross(u, v, c);
    const float m = sqrtf(dot3(c, c) + kEps);
    r = m / kk;
    cross(w, c, wc);
    for (int a = 0; a < 3; ++a) e[a] = wc[a] / m;
    scale = kk;
  } else if (k == 1) {  // point to the plane of 3 points
    float pl[3], pm[3], a1[3], a2[3], n[3], d[3];
    load3(pl_, i, pl);
    load3(pm_, i, pm);
    for (int a = 0; a < 3; ++a) {
      a1[a] = pj[a] - pl[a];
      a2[a] = pj[a] - pm[a];
      d[a] = lp[a] - pj[a];
    }
    cross(a1, a2, n);
    const float nn = sqrtf(dot3(n, n) + kEps);
    const float signed_r = dot3(d, n) / nn;
    const float sg = signed_r > 0.f ? 1.f : (signed_r < 0.f ? -1.f : 0.f);
    for (int a = 0; a < 3; ++a) e[a] = sg * n[a] / nn;
    r = fabsf(signed_r);
  } else {  // point to a fitted plane: pj the unit normal, scalar d0
    r = dot3(pj, lp) + scalar[i];
    for (int a = 0; a < 3; ++a) e[a] = pj[a];
  }
  const float* cols = kind_cols ? kind_cols + 6 * (k == 0 ? 0 : (k == 1 ? 1 : 2)) : nullptr;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float j = c < 3 ? e[c] : (e[0] * dl[0][c - 3] + e[1] * dl[1][c - 3]) + e[2] * dl[2][c - 3];
    if (k == 0) j = j / scale;
    J[c] = cols ? j * cols[c] : j;
  }
}

// One 6x6 solve H x = b, LU with partial pivoting (in place).  Returns
// false where a pivot is exactly zero (solve_ex's info != 0).
__device__ bool lu_solve6(float* H, float* b) {
  bool ok = true;
  for (int k = 0; k < 6; ++k) {
    int piv = k;
    float best = fabsf(H[6 * k + k]);
    for (int i = k + 1; i < 6; ++i) {
      const float a = fabsf(H[6 * i + k]);
      if (a > best) {
        best = a;
        piv = i;
      }
    }
    if (H[6 * piv + k] == 0.f) {
      ok = false;
      continue;
    }
    if (piv != k) {
      for (int j = 0; j < 6; ++j) {
        const float t = H[6 * k + j];
        H[6 * k + j] = H[6 * piv + j];
        H[6 * piv + j] = t;
      }
      const float t = b[k];
      b[k] = b[piv];
      b[piv] = t;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = H[6 * i + k] / H[6 * k + k];
      for (int j = k + 1; j < 6; ++j) H[6 * i + j] -= l * H[6 * k + j];
      b[i] -= l * b[k];
    }
  }
  for (int k = 5; k >= 0; --k) {
    float acc = b[k];
    for (int j = k + 1; j < 6; ++j) acc -= H[6 * k + j] * b[j];
    b[k] = acc / H[6 * k + k];
  }
  return ok;
}

// X <- X J (columns p, q) or J^T X (rows p, q) for the rotation with
// J[p][p] = J[q][q] = c, J[p][q] = s, J[q][p] = -s
__device__ void rotate_cols(double* X, int p, int q, double c, double s) {
  for (int r = 0; r < 6; ++r) {
    const double xp = X[6 * r + p], xq = X[6 * r + q];
    X[6 * r + p] = xp * c - xq * s;
    X[6 * r + q] = xp * s + xq * c;
  }
}

__device__ void rotate_rows(double* X, int p, int q, double c, double s) {
  for (int j = 0; j < 6; ++j) {
    const double xp = X[6 * p + j], xq = X[6 * q + j];
    X[6 * p + j] = c * xp - s * xq;
    X[6 * q + j] = s * xp + c * xq;
  }
}

// degeneracy_projector(H0, floor) into P (gauss_newton.eigh6 in f64)
__device__ void projector(const float* H0, double floor, float* P) {
  bool finite = true;
  for (int k = 0; k < 36; ++k) finite = finite && isfinite(H0[k]);
  double A[36], V[36];
  for (int k = 0; k < 36; ++k) {
    const bool diag = k / 6 == k % 6;
    A[k] = finite ? (double)H0[k] : (diag ? 1.0 : 0.0);
    V[k] = diag ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < kJacobiSweeps; ++sweep) {
    for (int round = 0; round < 5; ++round) {
      double c[3], s[3];
      for (int k = 0; k < 3; ++k) {  // each angle from the round's A
        const int p = kRounds[round][k][0], q = kRounds[round][k][1];
        const double app = A[6 * p + p], aqq = A[6 * q + q], apq = A[6 * p + q];
        const double d = aqq - app;
        const double y = copysign(apq, apq * d);
        const double phi = atan2(y + y, fabs(d));
        sincos(0.5 * phi, &s[k], &c[k]);
      }
      for (int k = 0; k < 3; ++k) {
        const int p = kRounds[round][k][0], q = kRounds[round][k][1];
        rotate_cols(A, p, q, c[k], s[k]);
        rotate_rows(A, p, q, c[k], s[k]);
        rotate_cols(V, p, q, c[k], s[k]);
      }
    }
  }
  float Vf[36], keep[6];
  for (int k = 0; k < 36; ++k) Vf[k] = (float)V[k];
  for (int k = 0; k < 6; ++k) keep[k] = (A[7 * k] > floor && finite) ? 1.f : 0.f;
  for (int a = 0; a < 6; ++a)
    for (int b = 0; b < 6; ++b) {
      float acc = 0.f;
      for (int k = 0; k < 6; ++k) acc += (Vf[6 * a + k] * keep[k]) * Vf[6 * b + k];
      P[6 * a + b] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
gn_solve(const float* __restrict__ cp, const float* __restrict__ pj,
         const float* __restrict__ pl, const float* __restrict__ pm,
         const float* __restrict__ scalar, const int32_t* __restrict__ kind,
         const float* __restrict__ weight, int N, const float* __restrict__ kind_cols,
         const uint8_t* __restrict__ dim_mask, const float* __restrict__ params0,
         float* __restrict__ out, int32_t* __restrict__ iters_out, int iters,
         float huber_delta, float damping, int min_count, float param_tol,
         double eig_floor, double prior_weight, double max_step) {
  __shared__ Shared s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool use_prior = prior_weight > 0.0, use_proj = eig_floor > 0.0;
  const float sw = sqrtf((float)prior_weight);
  const int rows = N + (use_prior ? 6 : 0);
  if (tid == 0) {
    for (int c = 0; c < 6; ++c) s.p[c] = s.p0[c] = params0[c];
    rotation(s);
    s.live = 1;
    s.done = 0;
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    double acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0;
    for (int i = tid; i < rows; i += kThreads) {
      float r, J[6], w;
      if (i < N) {
        batch_row(s, i, cp, pj, pl, pm, scalar, kind, kind_cols, r, J);
        w = weight[i];
      } else {  // the prior's rows: sqrt(w) (p - params0), sqrt(w) I
        const int c = i - N;
        r = sw * (s.p[c] - s.p0[c]);
        for (int b = 0; b < 6; ++b) J[b] = b == c ? sw : 0.f;
        w = 1.f / fmaxf(huber(r, huber_delta), 1e-12f);
      }
      const bool ok = isfinite(r) && finite6(J);
      if (!ok) {
        r = 0.f;
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
        for (int b = a; b < 6; ++b) acc[k++] += (double)J[a] * (double)Jw[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += (double)Jw[a] * (double)r;
      acc[27] += w > 0.f ? 1.0 : 0.0;
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      double v = acc[k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, off);
      if (lane == 0) s.part[warp][k] = v;
    }
    __syncthreads();
    if (tid < kSums) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += s.part[w][tid];
      s.tot[tid] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float H[36], g[6], m[6];
      int k = 0;
      for (int a = 0; a < 6; ++a)
        for (int b = a; b < 6; ++b, ++k) H[6 * a + b] = H[6 * b + a] = (float)s.tot[k];
      for (int a = 0; a < 6; ++a) {
        g[a] = (float)s.tot[21 + a];
        m[a] = dim_mask[a] ? 1.f : 0.f;
      }
      // masked dims: an identity block in H and a zero gradient
      for (int a = 0; a < 6; ++a)
        for (int b = 0; b < 6; ++b)
          H[6 * a + b] = H[6 * a + b] * (m[a] * m[b]) + (a == b ? 1.f - m[a] : 0.f);
      if (it == 0 && use_proj) projector(H, eig_floor, s.P);
      float x[6];
      for (int a = 0; a < 6; ++a) {
        H[7 * a] = H[7 * a] + damping;
        x[a] = g[a] * m[a];
      }
      const bool solved = lu_solve6(H, x);
      float delta[6];
      for (int a = 0; a < 6; ++a) delta[a] = -x[a];
      const int mc = min_count + (use_prior ? 6 : 0);
      const bool ok = s.tot[27] >= (double)mc && solved && finite6(delta);
      float d[6], pn[6];
      for (int a = 0; a < 6; ++a) d[a] = (s.p[a] + (ok ? delta[a] : 0.f)) - s.p[a];
      if (use_proj) {
        float e[6];
        for (int a = 0; a < 6; ++a) {
          float v = 0.f;
          for (int b = 0; b < 6; ++b) v += s.P[6 * a + b] * d[b];
          e[a] = v;
        }
        for (int a = 0; a < 6; ++a) d[a] = e[a];
      }
      if (max_step > 0.0) {
        const float sc = fminf((float)max_step / fmaxf(absmax6(d), 1e-12f), 1.f);
        for (int a = 0; a < 6; ++a) d[a] = d[a] * sc;
      }
      for (int a = 0; a < 6; ++a) pn[a] = s.p[a] + d[a];
      for (int a = 0; a < 6; ++a) d[a] = pn[a] - s.p[a];
      const float step = absmax6(d);
      for (int a = 0; a < 6; ++a) s.p[a] = pn[a];
      s.live = step > param_tol;
      s.done = it + 1;
      if (s.live) rotation(s);
    }
    __syncthreads();
    if (!s.live) break;
  }
  if (tid < 6) out[tid] = s.p[tid];
  if (tid == 0 && iters_out) *iters_out = s.done;
}

}  // namespace

// cp, pj, pl, pm [N, 3] f32, scalar [N] f32, kind [N] int32, weight [N]
// f32 (the Correspondences fields, contiguous); kind_cols [3, 6] f32 or
// null (no column mask); dim_mask [6] bool; params0 [6] f32; out [6] f32;
// iters_out [1] int32 or null (the iterations run).  Returns
// cudaGetLastError() after the launch, or -1 for a bad argument.
extern "C" int alego_gn_solve(const float* cp, const float* pj, const float* pl,
                              const float* pm, const float* scalar, const int32_t* kind,
                              const float* weight, int N, const float* kind_cols,
                              const uint8_t* dim_mask, const float* params0, float* out,
                              int32_t* iters_out, int iters, double huber_delta,
                              double damping, int min_count, double param_tol,
                              double eig_floor, double prior_weight, double max_step,
                              void* stream) {
  if (N < 0 || iters < 0) return -1;
  gn_solve<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      cp, pj, pl, pm, scalar, kind, weight, N, kind_cols, dim_mask, params0, out,
      iters_out, iters, (float)huber_delta, (float)damping, min_count, (float)param_tol,
      eig_floor, prior_weight, max_step);
  return (int)cudaGetLastError();
}
