// The superquadric inside-outside field, its 17-parameter gradient chain
// and the exact-zero cull, shared by the loss kernels (implicit.cu: K1/K2,
// explicit.cu: K4/K5).
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
//
// The kernels (K1, K2, K4, K5) use field_terms_lin, sep_grad_step and
// sep_finish below: per-sample reciprocals, body coordinates linear in z
// along a lattice column, and 11 running sums a column for the 17 terms.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kParStride = 24;  // floats per sample in the packed params
constexpr int kNPar = 17;       // frame scalars: a(3), e(2), t_rot(3), R(9)
constexpr int kSlotJLo = 17, kSlotJHi = 18;  // z window, lattice indices
constexpr float kTiny = 1.1754944e-38f;  // FLT_MIN
constexpr float kClamp = 30.0f;
constexpr float kExpClamp = 1.0686475e13f;  // exp(30)

struct Terms {
  float u, v, w, x2g, y2g, z2g, lx, ly, lz, lg, lh, F;
};

// Lattice index -> coordinate: 0 maps to 1e-4, k to k · inv (the spacing).
__device__ __forceinline__ float coord(int k, float inv) {
  return k == 0 ? 1e-4f : (float)k * inv;
}

__device__ __forceinline__ float guard(float s) {
  return s + (s == 0.0f ? 1e-4f : 0.0f);
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
// The chain of the kernels: the field and gradient of the comment at the
// top, with every divisor replaced by a reciprocal computed once per sample and the body
// coordinates linear in z along a lattice column.
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

// The field chain on body coordinates the caller computed (u = u0 + cu·z).
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

// The gradient of F in the 17 frame scalars, summed along one column:
// gx = gF·dF/dx2·2u (gy, gz likewise), and the terms −gx·u/a1 (size),
// −gx/a1 (translation), gx·(X, Y, z)/a1 (rotation), and the two exponent
// terms. Per axis the rotation and translation terms factor: acc[5] =
// −Σgx/a1 and acc[8..10]
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

// The 17 frame-scalar terms of one column from its running sums, in the
// frame row's order.
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

// ---------------------------------------------------------------------------
// The exact-zero cull (K1, K2, K4, K5). In exact arithmetic F ≥ max(x2g, y2g,
// z2g) ≥ max(u², v², w²) for every e > 0 (each power is monotone, every
// term is non-negative). Where sharp·(F − 1) > 88.73 > ln(FLT_MAX) =
// 88.7228, expf overflows and the occupancy 1/(1 + expf(.)) is exactly
// 0.0f. So a point outside the box |u|, |v|, |w| ≤ bb of a frame, with
//     bb² = 1.05 · (1 + 88.73/sharp),
// has occupancy exactly 0 under that frame, and where every gradient term
// is gF times a finite number (the dF terms and ex_le are clamped at e^30,
// min_nan clamps F, lg and lh are finite: below), a point whose gF is ±0
// adds ±0 to every running sum, which changes no bit of a sum that starts
// at +0. The 5% margin covers the float chain's rounding: every log-domain
// value stays below 87.7 in magnitude (below), each logf, expf and product
// adds a few 2^-24 of it, and e2/e1 ≤ 10, e1 ≤ 1 amplify that to well
// under 1e-3 of F; the interval's own rounding (|u0|, |cu| ≤ 70 in float)
// and the lattice's z_j = j·fl(1/last) move |u| by under 1e-4. Half the
// margin would do.
//
// The cull runs only for a row that proves those bounds (cull_sound):
// every value finite, a ≥ 0.05, e1 and e2 in [0.1, 1], and log(S)/min(e1,
// e2) ≤ 87, where S bounds x2g + y2g and z2g over the unit cube:
// |(u·a1, v·a2, w·a3)| = |R·p − t_rot| ≤ ‖R‖₂·√3 + |t_rot| = D for p in
// [0, 1]³, so u² + v² ≤ D²/min(a1, a2)² and w² ≤ D²/a3². As 1/e2 ≥ 1,
// A + B ≤ (x2g + y2g)^(1/e2), so lg ≤ log(S)/e2 and log E ≤ log(S)/e1,
// log C ≤ log(S)/e1, and lh ≤ ln 2 + 87 < 88.72: nothing overflows. Rows
// of clamped params (a ≥ 0.05, e in [0.1, 1], t in [0, 1]³, a rotation)
// give D ≤ 2√3 and log(S)/min(e) ≤ 84.8, so every row the wrappers pack
// is culled; any other row sweeps its whole window.
// ---------------------------------------------------------------------------

constexpr float kExpOverflow = 88.73f;  // > ln(FLT_MAX) = 88.7228
constexpr float kCullMargin = 1.05f;
constexpr float kFiniteLog = 87.0f;     // + ln 2 < ln(FLT_MAX)

// Whether a frame row proves the cull's bounds (above).
__device__ bool cull_sound(const float* p) {
  for (int i = 0; i < kNPar; ++i) {
    if (!isfinite(p[i])) return false;
  }
  const float a1 = p[0], a2 = p[1], a3 = p[2], e1 = p[3], e2 = p[4];
  if (!(fminf(a1, fminf(a2, a3)) >= 0.05f)) return false;
  if (!(e1 >= 0.1f && e1 <= 1.0f && e2 >= 0.1f && e2 <= 1.0f)) return false;
  const float* r = p + 8;
  float g2 = 0.0f;  // ‖R‖₂² ≤ the largest row sum of |RᵀR|
  for (int i = 0; i < 3; ++i) {
    float row = 0.0f;
    for (int j = 0; j < 3; ++j) {
      row += fabsf(r[i] * r[j] + r[3 + i] * r[3 + j] + r[6 + i] * r[6 + j]);
    }
    g2 = fmaxf(g2, row);
  }
  const float d = sqrtf(g2) * 1.7320509f +
                  sqrtf(p[5] * p[5] + p[6] * p[6] + p[7] * p[7]);
  const float amin = fminf(a1, a2);
  const float s = fmaxf(d * d / (amin * amin) + 2e-4f, d * d / (a3 * a3) +
                        1e-4f);
  return logf(s) <= kFiniteLog * fminf(e1, e2);
}

// The box half-width bb for this sharpness.
__device__ __forceinline__ float box_half_width(float sharp) {
  return sqrtf(kCullMargin * (1.0f + kExpOverflow / sharp));
}

// Narrow [zl, zu] to the z where |u0 + c·z| ≤ bb, given ic = 1/c.
__device__ __forceinline__ void clip_axis(float u0, float ic, float bb,
                                          float& zl, float& zu) {
  if (!(fabsf(ic) <= FLT_MAX)) {  // c is 0 or subnormal: u = u0 at every z
    if (!(fabsf(u0) <= bb)) {
      zl = INFINITY;
      zu = -INFINITY;
    }
    return;
  }
  const float za = (-bb - u0) * ic, zb = (bb - u0) * ic;
  zl = fmaxf(zl, fminf(za, zb));
  zu = fminf(zu, fmaxf(za, zb));
}

// The lattice planes [j0, j1] whose z (z_0 = 1e-4, z_j = j/last, last the
// lattice's last index: N on the explicit lattice, n − 1 on the implicit
// one) lies in the z interval where one frame's |u|, |v|, |w| ≤ bb; j0 >
// j1 when none.
__device__ __forceinline__ void box_planes(const Recip& k, float u0,
                                           float v0, float w0, float bb,
                                           int last, int& j0, int& j1) {
  float zl = -INFINITY, zu = INFINITY;
  clip_axis(u0, k.icu, bb, zl, zu);
  clip_axis(v0, k.icv, bb, zl, zu);
  clip_axis(w0, k.icw, bb, zl, zu);
  const float fn = (float)last;
  j0 = zl <= 1e-4f ? 0 : (int)ceilf(fminf(zl * fn, fn + 1.0f));
  j1 = zu < 1e-4f ? -1 : (int)floorf(fminf(zu * fn, fn));
}

}  // namespace
