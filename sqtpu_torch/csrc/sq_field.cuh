// The superquadric inside-outside field and its 17-parameter gradient chain,
// shared by the loss kernels (implicit.cu: K1/K2, explicit.cu: K4/K5).
//
// Same arithmetic as sqtpu/ops/kernels/implicit.py::_field_terms, _occ and
// _frame_grad_step, which the Pallas kernels of both losses share:
//
//   body coordinates  u = (R0·(X, Y, z) − t_rot0) / a1   (v, w likewise)
//   F = ((x2^(1/e2) + y2^(1/e2))^(e2/e1) + z2^(1/e1))^e1, with the 1e-4
//       guard at exact zeros of x2, y2, z2 and FLT_MIN added to both sums,
//       every power taken as expf(logf(.) · k)
//   occupancy sigmoid(sharp (1 − F))
//
// The gradient of F with respect to the 17 frame scalars (a, e, R(q*)·t,
// R(q*)) is assembled in log space with the exponent clamped at 30: outside
// the occupancy shell the exponentials overflow while their cotangent is
// exactly 0, and inf·0 would give NaN. The clamp keeps a NaN, as
// jnp.minimum does. Accurate logf/expf (no fast-math), for parity with the
// reference.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kParStride = 24;  // floats per sample in the packed params
constexpr int kNPar = 17;       // frame scalars: a(3), e(2), t_rot(3), R(9)
constexpr int kSlotJLo = 17, kSlotJHi = 18;  // z window, lattice indices
constexpr float kTiny = 1.1754944e-38f;  // FLT_MIN
constexpr float kClamp = 30.0f;
constexpr float kExpClamp = 1.0686475e13f;  // exp(30)

struct Frame {
  float a1, a2, a3, e1, e2, t0, t1, t2;
  float r[9];
  float e21;  // e2 / e1
};

struct Terms {
  float u, v, w, x2g, y2g, z2g, lx, ly, lz, lg, lh, F;
};

__device__ __forceinline__ Frame load_frame(const float* p) {
  Frame f;
  f.a1 = p[0]; f.a2 = p[1]; f.a3 = p[2];
  f.e1 = p[3]; f.e2 = p[4];
  f.t0 = p[5]; f.t1 = p[6]; f.t2 = p[7];
#pragma unroll
  for (int i = 0; i < 9; ++i) f.r[i] = p[8 + i];
  f.e21 = f.e2 / f.e1;
  return f;
}

// Lattice index -> coordinate: 0 maps to 1e-4, k to k · inv (the spacing).
__device__ __forceinline__ float coord(int k, float inv) {
  return k == 0 ? 1e-4f : (float)k * inv;
}

__device__ __forceinline__ float guard(float s) {
  return s + (s == 0.0f ? 1e-4f : 0.0f);
}

__device__ __forceinline__ Terms field_terms(const Frame& f, float X,
                                             float Y, float z) {
  Terms t;
  t.u = (f.r[0] * X + f.r[1] * Y + f.r[2] * z - f.t0) / f.a1;
  t.v = (f.r[3] * X + f.r[4] * Y + f.r[5] * z - f.t1) / f.a2;
  t.w = (f.r[6] * X + f.r[7] * Y + f.r[8] * z - f.t2) / f.a3;
  t.x2g = guard(t.u * t.u);
  t.y2g = guard(t.v * t.v);
  t.z2g = guard(t.w * t.w);
  t.lx = logf(t.x2g);
  t.ly = logf(t.y2g);
  t.lz = logf(t.z2g);
  const float A = expf(t.lx / f.e2);
  const float B = expf(t.ly / f.e2);
  const float C = expf(t.lz / f.e1);
  t.lg = logf(A + B + kTiny);
  const float E = expf(t.lg * f.e21);
  t.lh = logf(E + C + kTiny);
  t.F = expf(t.lh * f.e1);
  return t;
}

__device__ __forceinline__ float occupancy(float F, float sharp) {
  return 1.0f / (1.0f + expf(-(sharp * (1.0f - F))));
}

// min(x, c) that keeps a NaN, like jnp.minimum
__device__ __forceinline__ float min_nan(float x, float c) {
  return x > c ? c : x;
}

__device__ __forceinline__ float ex(float logterm) {
  return expf(min_nan(logterm, kClamp));
}

// The 17-term chain of sqtpu/ops/kernels/implicit.py::_frame_grad_step: adds
// gF · dF/d(frame scalar) at one point to acc.
__device__ __forceinline__ void frame_grad_step(float* acc, const Terms& t,
                                                float gF, const Frame& f,
                                                float X, float Y, float z) {
  const float lfh = (f.e1 - 1.0f) * t.lh;
  const float dF_dx2 =
      ex(lfh + (f.e21 - 1.0f) * t.lg + (1.0f / f.e2 - 1.0f) * t.lx);
  const float dF_dy2 =
      ex(lfh + (f.e21 - 1.0f) * t.lg + (1.0f / f.e2 - 1.0f) * t.ly);
  const float dF_dz2 = ex(lfh + (1.0f / f.e1 - 1.0f) * t.lz);
  const float gx = gF * dF_dx2 * 2.0f * t.u;
  const float gy = gF * dF_dy2 * 2.0f * t.v;
  const float gz = gF * dF_dz2 * 2.0f * t.w;
  acc[0] += -gx * t.u / f.a1;
  acc[1] += -gy * t.v / f.a2;
  acc[2] += -gz * t.w / f.a3;
  const float le = f.e21 * t.lg;
  const float ex_le = ex(lfh + le);
  acc[3] += gF * (min_nan(t.F, kExpClamp) * t.lh -
                  (ex_le * t.lg * f.e2 + dF_dz2 * t.z2g * t.lz) / f.e1);
  acc[4] += gF * (ex_le * t.lg -
                  (dF_dx2 * t.x2g * t.lx + dF_dy2 * t.y2g * t.ly) / f.e2);
  acc[5] += -gx / f.a1;
  acc[6] += -gy / f.a2;
  acc[7] += -gz / f.a3;
  acc[8] += gx * X / f.a1;
  acc[9] += gx * Y / f.a1;
  acc[10] += gx * z / f.a1;
  acc[11] += gy * X / f.a2;
  acc[12] += gy * Y / f.a2;
  acc[13] += gy * z / f.a2;
  acc[14] += gz * X / f.a3;
  acc[15] += gz * Y / f.a3;
  acc[16] += gz * z / f.a3;
}

// Fixed-order sum over the 32 lanes; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// out[b * out_stride + c] = sum over k = 0 .. blocks-1, in order, of
// partial[(b * blocks + k) * width + c] for c < width, and 0 for the rest
// of the row.
__global__ void sum_partials(const float* __restrict__ partial,
                             float* __restrict__ out, int batch, int blocks,
                             int width, int out_stride) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= batch * out_stride) return;
  const int b = t / out_stride, c = t - b * out_stride;
  float s = 0.0f;
  if (c < width) {
    for (int k = 0; k < blocks; ++k) {
      s += partial[((size_t)b * blocks + k) * width + c];
    }
  }
  out[t] = s;
}

// ---------------------------------------------------------------------------
// K4's chain (explicit.cu explicit_fused_kernel): the field and gradient
// above, with every divisor replaced by a reciprocal computed once per
// sample and the body coordinates linear in z along a lattice column.
// ---------------------------------------------------------------------------

// Per-sample constants of one frame row.
struct Recip {
  float ia1, ia2, ia3;  // 1/a
  float cu, cv, cw;     // slopes in z of u, v, w: R[., 2]/a
  float icu, icv, icw;  // 1/cu, 1/cv, 1/cw (the cull's z interval)
  float e1, e2, ie1, ie2, e21;
  float e1m1, e21m1, ie1m1, ie2m1;  // e1 − 1, e2/e1 − 1, 1/e1 − 1, 1/e2 − 1
};

__device__ __forceinline__ Recip make_recip(const float* p) {
  Recip k;
  k.ia1 = 1.0f / p[0];
  k.ia2 = 1.0f / p[1];
  k.ia3 = 1.0f / p[2];
  k.cu = p[10] * k.ia1;
  k.cv = p[13] * k.ia2;
  k.cw = p[16] * k.ia3;
  k.icu = 1.0f / k.cu;
  k.icv = 1.0f / k.cv;
  k.icw = 1.0f / k.cw;
  k.e1 = p[3];
  k.e2 = p[4];
  k.ie1 = 1.0f / k.e1;
  k.ie2 = 1.0f / k.e2;
  k.e21 = k.e2 / k.e1;
  k.e1m1 = k.e1 - 1.0f;
  k.e21m1 = k.e21 - 1.0f;
  k.ie1m1 = k.ie1 - 1.0f;
  k.ie2m1 = k.ie2 - 1.0f;
  return k;
}

// field_terms on body coordinates the caller computed (u = u0 + cu·z).
__device__ __forceinline__ Terms field_terms_lin(const Recip& k, float u,
                                                 float v, float w) {
  Terms t;
  t.u = u;
  t.v = v;
  t.w = w;
  t.x2g = guard(u * u);
  t.y2g = guard(v * v);
  t.z2g = guard(w * w);
  t.lx = logf(t.x2g);
  t.ly = logf(t.y2g);
  t.lz = logf(t.z2g);
  const float A = expf(t.lx * k.ie2);
  const float B = expf(t.ly * k.ie2);
  const float C = expf(t.lz * k.ie1);
  t.lg = logf(A + B + kTiny);
  const float E = expf(t.lg * k.e21);
  t.lh = logf(E + C + kTiny);
  t.F = expf(t.lh * k.e1);
  return t;
}

// The gradient of frame_grad_step, summed along one column. Per axis the
// rotation and translation terms factor: acc[5] = −Σgx/a1 and acc[8..10]
// = Σgx·(X, Y, z)/a1, with X, Y and 1/a1 constant along the column, so
// Σg and Σg·z carry all four; the size terms need Σg·u. With the two
// exponent terms, 11 running sums stand for the 17.
struct SepAcc {
  float gu, gv, gw;     // Σ gx·u, Σ gy·v, Σ gz·w
  float de1, de2;       // the e1 and e2 terms
  float gx, gy, gz;     // Σ gx, Σ gy, Σ gz
  float gxz, gyz, gzz;  // Σ gx·z, Σ gy·z, Σ gz·z
};

__device__ __forceinline__ void sep_grad_step(SepAcc& s, const Terms& t,
                                              float gF, const Recip& k,
                                              float z) {
  const float lfh = k.e1m1 * t.lh;
  const float lxy = lfh + k.e21m1 * t.lg;
  const float dF_dx2 = ex(lxy + k.ie2m1 * t.lx);
  const float dF_dy2 = ex(lxy + k.ie2m1 * t.ly);
  const float dF_dz2 = ex(lfh + k.ie1m1 * t.lz);
  const float gx = gF * dF_dx2 * 2.0f * t.u;
  const float gy = gF * dF_dy2 * 2.0f * t.v;
  const float gz = gF * dF_dz2 * 2.0f * t.w;
  s.gu += gx * t.u;
  s.gv += gy * t.v;
  s.gw += gz * t.w;
  const float ex_le = ex(lfh + k.e21 * t.lg);
  s.de1 += gF * (min_nan(t.F, kExpClamp) * t.lh -
                 (ex_le * t.lg * k.e2 + dF_dz2 * t.z2g * t.lz) * k.ie1);
  s.de2 += gF * (ex_le * t.lg -
                 (dF_dx2 * t.x2g * t.lx + dF_dy2 * t.y2g * t.ly) * k.ie2);
  s.gx += gx;
  s.gy += gy;
  s.gz += gz;
  s.gxz += gx * z;
  s.gyz += gy * z;
  s.gzz += gz * z;
}

// The 17 frame-scalar terms of one column from its running sums, in
// frame_grad_step's order.
__device__ __forceinline__ void sep_finish(float* acc, const SepAcc& s,
                                           const Recip& k, float X,
                                           float Y) {
  acc[0] = -s.gu * k.ia1;
  acc[1] = -s.gv * k.ia2;
  acc[2] = -s.gw * k.ia3;
  acc[3] = s.de1;
  acc[4] = s.de2;
  acc[5] = -s.gx * k.ia1;
  acc[6] = -s.gy * k.ia2;
  acc[7] = -s.gz * k.ia3;
  acc[8] = s.gx * X * k.ia1;
  acc[9] = s.gx * Y * k.ia1;
  acc[10] = s.gxz * k.ia1;
  acc[11] = s.gy * X * k.ia2;
  acc[12] = s.gy * Y * k.ia2;
  acc[13] = s.gyz * k.ia2;
  acc[14] = s.gz * X * k.ia3;
  acc[15] = s.gz * Y * k.ia3;
  acc[16] = s.gzz * k.ia3;
}

}  // namespace
