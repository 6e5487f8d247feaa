// Voxel IoU counts for Hopper (sm_90a): K7.
//
// The port's own kernel: the JAX package scores the IoU with plain jnp
// (sqtpu/ops/metrics.py:25-52), so no TPU kernel is replaced. Per sample it
// counts, for each pair (f, g) of a pair table, the voxels of the N³ "iou"
// lattice (geometry.make_axis(N, "iou"): linspace(0, 1, N), no nudge) where
// occupancy f AND g holds, and where f OR g holds. Occupancy is
// F^(e1) <= 1 with no clamp and no guard, the plain path's
// (sqtpu_torch/ops/metrics.py::_binary_voxels). No grid reaches device
// memory: the output is (batch, pairs, 2) int64 counts.
//
// The plain path's arithmetic, one operation for one. On the card the plain
// path runs one ATen elementwise kernel per operation, each rounding on its
// own, so here every product and sum is __fmul_rn / __fadd_rn (no FMA
// contraction) in the plain path's order:
//   c = (r0·X + r1·Y) + r2·Z;  u = (c − tr) / a (IEEE division);  s = u·u
//   (ATen takes ** 2 as a product); A = pow(s_x, 1/e2), B = pow(s_y, 1/e2),
//   C = pow(s_z, 1/e1), E = pow((A + B) + tiny, e2/e1),
//   F = pow((E + C) + tiny, e1);  occupied where F <= 1.
// pow is the accurate powf (pow for double), ATen's pow of two tensors; no
// fast-math. The per-sample constants (a, the exponents, R(q*)·t, R(q*))
// come packed from torch, computed by the plain path's own expressions, so
// F has the plain path's bits and the counts equal its counts. The double
// instantiation does the same in double (tiny = DBL_MIN). A bfloat16 field
// (a bf16 network's prediction, scored against float32 labels in
// validation) runs the same chain on its own bfloat16 lattice axis, each
// result rounded to bfloat16, as ATen computes a bf16 operation in float
// and rounds it; the z cull is off for it (its proof bounds float32
// roundings).
//
// The design for this card:
// * One warp a tile of 8 × 4 (x, y) columns of one sample, all fields and
//   pairs at once: a field shared by two pairs (the truth of iou_full's
//   first two) is evaluated once per voxel. A block is 16 × 8 columns
//   (2 × 2 warps) and reads its sample's packed rows and the pair table
//   into shared memory once.
// * The z cull (below): each lane finds, for each field, the z interval of
//   its column where the field can be occupied; elsewhere the field's
//   occupancy is false and it is not evaluated.
// * The warp's voxels dealt out to its lanes: the hulls of the lanes'
//   intervals, laid end to end by a prefix sum, are taken 32 voxels at a
//   time, each lane finding its voxel's column by a binary search over
//   the prefix (shuffles) and the column's field intervals in shared
//   memory. So the lanes stay busy whatever the lengths of their own
//   columns. On iou_full's fields at N = 128, B = 125 (one NVIDIA H100
//   80GB HBM3, 700.00 W) a thread per column looping over its own
//   intervals took 3.91 ms, the dealt voxels with the field loop unrolled
//   3.06, and rolled (as here: 48 registers, not 56) 2.28.
// * Counting: a voxel's occupancies form a bit per field; for each pair a
//   warp ballot of (f AND g) and of (f OR g) over its 32 voxels and __popc
//   add to the warp's counters, and one lane adds them into the output
//   with integer atomics: integer sums do not depend on their order, so
//   the counts are exact and repeat from run to run.
//
// What bounds it: operations. A field evaluation is 3 × 5 rounded
// operations (one an IEEE division) and 5 accurate pows; the bytes are a
// few packed rows in and 16 bytes a sample and pair out.
//
// The z cull and why it is exact. Write x, y, z for the body coordinates
// u of the three axes as computed. Claim: if |x|, |y| or |z| > 1 + δ, then
// F > 1 as computed. Let L = ln(s) ≥ 2·ln(1 + δ) ≥ 1.9·δ for the large
// coordinate (s rounds to at most one ulp below (1 + δ)²). If it is x (or
// y), A = pow(s, 1/e2) has ln A ≈ L/e2 > 0; (A + B) + tiny ≥ A since B ≥ 0
// and rounding is monotone; E has ln E ≈ (e2/e1)·ln A = L/e1; (E + C) +
// tiny ≥ E; F has ln F ≈ e1·ln E = L. If it is z, ln C ≈ L/e1 and again
// ln F ≈ L. Every intermediate's log is at least L·min(1, 1/e1, 1/e2), and
// with δ = 5e-4·max(1, e1, e2) that is ≥ 9.5e-4; an accurate pow is off by
// a few ulps (a log error of ~1e-6 a stage, scaled through the later
// exponents as the excess is), so each intermediate stays above 1 by far
// more than its rounding and F > 1. A base above 1 may overflow to inf on
// the way; pow(inf, k > 0) = inf > 1 as well. The proof needs
// ln(1 + δ) ≥ 0.95·δ (δ ≤ 0.05, so e1, e2 ≤ 100) and exponents that are
// positive and finite; it is applied to a sample's field only when its
// packed row is finite, each a ≠ 0 and 1e-3 ≤ e1, e2 ≤ 100. Any other
// field (non-positive or NaN exponents, a = 0, an infinite value) is
// evaluated on every voxel of every column, as the full sweep does.
//
// The interval. Along a column u = (P + r2·Z − tr)/a with P = r0·X + r1·Y
// (the kernel's own float P). In double, |u| ≤ b is the interval between
// (±b − u0)·(a/r2) where u0 = (P − tr)/a, with
//   b = 1 + δ + 2^-20·(M/|a| + 1),  M = |P| + |r2|·zmax + |tr|,
// zmax the largest |Z| of the axis. The float chain c = P + r2·Z, c − tr,
// / a rounds four times, each within 2^-24 of a value at most M/|a| in
// u's units, so |u − u_exact| ≤ 2^-22·M/|a|: the allowance is four times
// that, and the double arithmetic of the interval (the per-field
// reciprocals 1/a, 1/|a|, a/r2 included) adds ~1e-15 relative. A voxel
// whose Z lies outside the interval of one axis has |u| > 1 + δ there, so
// it is not occupied. The interval is intersected over the three axes and
// turned into lattice indices by a walk on the axis itself from a guess
// (the lattice is make_axis's, ascending, its end point exactly 1), so no
// index rounding enters. An axis whose bounds come out non-finite adds no
// constraint (wider is always safe); a column whose P is not finite takes
// the full sweep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kStride = 24;   // values per field and sample in the packed rows
constexpr int kUsed = 21;     // a(3) e1 e2 1/e2 e2/e1 1/e1 tr(3) R(9) bf16
constexpr int kMaxFields = 8;
constexpr int kMaxPairs = 8;
constexpr int kMaxN = 2048;   // a column's field interval packs into 16 bits
constexpr int kThreads = 128;
constexpr int kTileY = 16, kTileX = 8;   // a block's columns: 2 × 2 warps
constexpr double kEMin = 1e-3, kEMax = 100.0;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float pow(float a, float b) {
    return powf(a, b);
  }
  static __device__ __forceinline__ float tiny() { return FLT_MIN; }
  // a bfloat16 field: ATen computes each of its operations in float and
  // rounds the result to bfloat16
  template <bool B16>
  static __device__ __forceinline__ float keep(float v) {
    return B16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
};

template <>
struct Arith<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double pow(double a, double b) {
    return ::pow(a, b);
  }
  static __device__ __forceinline__ double tiny() { return DBL_MIN; }
  template <bool B16>
  static __device__ __forceinline__ double keep(double v) {
    return v;
  }
};

// The packed row of one field: a 0-2, e1 3, e2 4, 1/e2 5, e2/e1 6, 1/e1 7,
// R(q*)·t 8-10, R(q*) 11-19 (row-major), 1 at 20 for a bfloat16 field
// (its values exact in float, each operation rounded to bfloat16).

// P = r0·X + r1·Y of each axis, the column's part of c. B16: a bfloat16
// field (each result rounded to bfloat16).
template <typename T, bool B16>
__device__ __forceinline__ void column_terms(const T* r, T X, T Y, T* P) {
  using A = Arith<T>;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    P[i] = A::template keep<B16>(
        A::add(A::template keep<B16>(A::mul(r[11 + 3 * i], X)),
               A::template keep<B16>(A::mul(r[12 + 3 * i], Y))));
  }
}

template <typename T, bool B16>
__device__ __forceinline__ bool occupied(const T* r, const T* P, T Z) {
  using A = Arith<T>;
  const auto k = [](T v) { return A::template keep<B16>(v); };
  T s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T c = k(A::add(P[i], k(A::mul(r[13 + 3 * i], Z))));
    const T u = k(A::div(k(A::sub(c, r[8 + i])), r[i]));
    s[i] = k(A::mul(u, u));
  }
  const T pa = k(A::pow(s[0], r[5]));
  const T pb = k(A::pow(s[1], r[5]));
  const T pc = k(A::pow(s[2], r[7]));
  const T e = k(A::pow(k(A::add(k(A::add(pa, pb)), A::tiny())), r[6]));
  const T f = k(A::pow(k(A::add(k(A::add(e, pc)), A::tiny())), r[3]));
  return f <= (T)1;
}

// One field at one voxel of the column (x, y), z = index k of its axis.
template <typename T>
__device__ __forceinline__ bool field_at(const T* r, const T* axf, int x,
                                         int y, int k) {
  T P[3];
  if (r[20] != (T)0) {
    column_terms<T, true>(r, __ldg(axf + x), __ldg(axf + y), P);
    return occupied<T, true>(r, P, __ldg(axf + k));
  }
  column_terms<T, false>(r, __ldg(axf + x), __ldg(axf + y), P);
  return occupied<T, false>(r, P, __ldg(axf + k));
}

// A field's per-sample constants of the z interval, in double, computed
// once a block: the reciprocals make the per-column interval free of
// divisions (their rounding, ~1e-16 relative, is far inside the
// allowance).
struct Cull {
  double ia[3];      // 1/a
  double iabs[3];    // 1/|a|
  double islope[3];  // a/r2, the reciprocal of u's slope in Z
  bool flat[3];      // r2 = 0: u does not move along the column
  double t[3];       // R(q*)·t
  double cz[3];      // |r2|·zmax
  double base;       // 1 + δ + 2^-20
  int on;            // 0: the field is evaluated on every voxel
};

// Whether the cull's proof holds for a field's row, and its constants.
template <typename T>
__device__ Cull make_cull(const T* r, double zmax) {
  Cull k;
  bool finite = true;
  for (int i = 0; i < kUsed; ++i) finite = finite && isfinite(r[i]);
  const double e1 = r[3], e2 = r[4];
  k.on = finite && r[20] == (T)0 && r[0] != (T)0 && r[1] != (T)0 &&
         r[2] != (T)0 && e1 >= kEMin && e1 <= kEMax && e2 >= kEMin &&
         e2 <= kEMax;
  const double delta = 5e-4 * fmax(1.0, fmax(e1, e2));
  k.base = 1.0 + delta + 0x1p-20;
  for (int i = 0; i < 3; ++i) {
    const double a = r[i], c = r[13 + 3 * i];
    k.ia[i] = 1.0 / a;
    k.iabs[i] = 1.0 / fabs(a);
    k.flat[i] = c == 0.0;
    k.islope[i] = k.flat[i] ? 0.0 : a / c;
    k.t[i] = r[8 + i];
    k.cz[i] = fabs(c) * zmax;
  }
  return k;
}

// First index k with ax[k] >= v (upper = false) or ax[k] > v (upper =
// true): a guess from the lattice's spacing, then a walk on the axis
// itself, so the index is exact for any ascending axis.
template <typename T>
__device__ __forceinline__ int search(const T* ax, int n, double v,
                                      bool upper) {
  int k = (int)fmin(fmax(v * (double)(n - 1), 0.0), (double)n);
  while (k > 0 && (upper ? (double)__ldg(ax + k - 1) > v
                         : (double)__ldg(ax + k - 1) >= v)) {
    --k;
  }
  while (k < n && (upper ? (double)__ldg(ax + k) <= v
                         : (double)__ldg(ax + k) < v)) {
    ++k;
  }
  return k;
}

// The lattice indices [k0, k1] of the column where the field is evaluated;
// k0 > k1 when it is occupied nowhere on the column.
template <typename T>
__device__ void z_range(const Cull& k, const T* P, const T* ax, int n,
                        int& k0, int& k1) {
  k0 = 0;
  k1 = n - 1;
  if (!k.on || !(isfinite(P[0]) && isfinite(P[1]) && isfinite(P[2]))) return;
  double lo = -INFINITY, hi = INFINITY;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double p = P[i];
    const double b =
        k.base + 0x1p-20 * ((fabs(p) + k.cz[i] + fabs(k.t[i])) * k.iabs[i]);
    const double u0 = (p - k.t[i]) * k.ia[i];
    if (k.flat[i]) {
      if (!(fabs(u0) <= b) && isfinite(b) && isfinite(u0)) {
        k1 = -1;
        return;
      }
      continue;
    }
    const double za = (-b - u0) * k.islope[i], zb = (b - u0) * k.islope[i];
    if (!(isfinite(za) && isfinite(zb))) continue;
    lo = fmax(lo, fmin(za, zb));
    hi = fmin(hi, fmax(za, zb));
  }
  if (!(lo <= hi)) {
    k1 = -1;
    return;
  }
  k0 = search(ax, n, lo, false);
  k1 = search(ax, n, hi, true) - 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
voxel_iou_kernel(const T* __restrict__ par, const T* __restrict__ ax,
                 const int* __restrict__ pairs,
                 unsigned long long* __restrict__ out, int n_fields,
                 int n_pairs, int n, int tiles_y, int tiles) {
  __shared__ T row[kMaxFields][kUsed];
  __shared__ Cull cull[kMaxFields];
  __shared__ int pair_f[kMaxPairs], pair_g[kMaxPairs];
  __shared__ int ranges[kThreads / 32][kMaxFields][32];
  const int b = blockIdx.x / tiles, tile = blockIdx.x % tiles;
  for (int i = threadIdx.x; i < n_fields * kUsed; i += kThreads) {
    row[i / kUsed][i % kUsed] =
        par[((size_t)b * n_fields + i / kUsed) * kStride + i % kUsed];
  }
  if (threadIdx.x < n_pairs) {
    pair_f[threadIdx.x] = pairs[2 * threadIdx.x];
    pair_g[threadIdx.x] = pairs[2 * threadIdx.x + 1];
  }
  __syncthreads();
  if (threadIdx.x < n_fields) {
    const T* axf = ax + (size_t)threadIdx.x * n;
    const double zmax = fmax(fabs((double)axf[0]), fabs((double)axf[n - 1]));
    cull[threadIdx.x] = make_cull(row[threadIdx.x], zmax);
  }
  __syncthreads();

  // this thread's column: warps are 8 (y) × 4 (x) tiles, 2 × 2 a block
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y = (tile % tiles_y) * kTileY + (warp & 1) * 8 + (lane & 7);
  const int x = (tile / tiles_y) * kTileX + (warp >> 1) * 4 + (lane >> 3);
  unsigned inter[kMaxPairs], uni[kMaxPairs];   // the warp's, on every lane
#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) inter[p] = uni[p] = 0u;

  // each lane's column: its fields' intervals (packed k0 << 16 | k1 + 1)
  // and their hull
  int zlo = 0, len = 0;
  if (x < n && y < n) {
    int lo = n, hi = -1;
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) {
      int k0 = 0, k1 = -1;
      if (f < n_fields) {
        const T* axf = ax + (size_t)f * n;
        T P[3];   // the interval is the cull's, off for a bfloat16 field
        column_terms<T, false>(row[f], __ldg(axf + x), __ldg(axf + y), P);
        z_range(cull[f], P, axf, n, k0, k1);
        if (k0 <= k1) {
          lo = min(lo, k0);
          hi = max(hi, k1);
        }
      }
      ranges[warp][f][lane] = (k0 << 16) | (k1 + 1);
    }
    if (lo <= hi) {
      zlo = lo;
      len = hi - lo + 1;
    }
  } else {
#pragma unroll
    for (int f = 0; f < kMaxFields; ++f) ranges[warp][f][lane] = 0;
  }
  __syncwarp();
  // the warp's voxels, lane by lane, dealt out 32 at a time: the lanes
  // stay busy whatever the lengths of their own columns
  int incl = len;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  for (int base = 0; base < total; base += 32) {
    const int item = base + lane;
    int src = 0;   // the lane whose column holds this item
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(0xffffffffu, incl, src + step - 1) <= item) src += step;
    }
    src = min(src, 31);
    const int k = __shfl_sync(0xffffffffu, zlo, src) + item -
                  (__shfl_sync(0xffffffffu, incl, src) -
                   __shfl_sync(0xffffffffu, len, src));
    const int xs = __shfl_sync(0xffffffffu, x, src);
    const int ys = __shfl_sync(0xffffffffu, y, src);
    unsigned bits = 0u;
    if (item < total) {
#pragma unroll 1
      for (int f = 0; f < n_fields; ++f) {
        const int r = ranges[warp][f][src];
        if (k >= (r >> 16) && k < (r & 0xffff) &&
            field_at(row[f], ax + (size_t)f * n, xs, ys, k)) {
          bits |= 1u << f;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < kMaxPairs; ++p) {
      if (p < n_pairs) {
        const unsigned bf = bits >> pair_f[p] & 1u;
        const unsigned bg = bits >> pair_g[p] & 1u;
        inter[p] += __popc(__ballot_sync(0xffffffffu, bf & bg));
        uni[p] += __popc(__ballot_sync(0xffffffffu, bf | bg));
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kMaxPairs; ++p) {
    if (p < n_pairs && lane == 0) {
      unsigned long long* o = out + ((size_t)b * n_pairs + p) * 2;
      if (inter[p]) atomicAdd(o, (unsigned long long)inter[p]);
      if (uni[p]) atomicAdd(o + 1, (unsigned long long)uni[p]);
    }
  }
}

}  // namespace

extern "C" {

// par: (batch, n_fields, 24) packed rows, ax: (n_fields, n) each field's
// lattice axis, both float32 (is_double = 0; a bfloat16 field's values
// converted exactly) or float64 (is_double = 1); pairs: (n_pairs, 2)
// int32 field indices; out: (batch, n_pairs, 2) int64 set to 0 by the
// caller, into which the kernel adds [intersection, union]. All on the
// device. Launches on `stream` and returns cudaGetLastError() as an int
// (0 = ok); 1 (cudaErrorInvalidValue) for sizes outside the kernel's.
int sqtpu_voxel_iou(const void* par, const void* ax, const void* pairs,
                    void* out, int batch, int n_fields, int n_pairs, int n,
                    int is_double, void* stream) {
  if (batch < 1 || n < 1 || n > kMaxN || n_fields < 1 ||
      n_fields > kMaxFields || n_pairs < 1 || n_pairs > kMaxPairs) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles_y = (n + kTileY - 1) / kTileY;
  const int tiles = tiles_y * ((n + kTileX - 1) / kTileX);
  if ((long long)batch * tiles > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) {
    voxel_iou_kernel<double><<<batch * tiles, kThreads, 0, s>>>(
        (const double*)par, (const double*)ax, (const int*)pairs,
        (unsigned long long*)out, n_fields, n_pairs, n, tiles_y, tiles);
  } else {
    voxel_iou_kernel<float><<<batch * tiles, kThreads, 0, s>>>(
        (const float*)par, (const float*)ax, (const int*)pairs,
        (unsigned long long*)out, n_fields, n_pairs, n, tiles_y, tiles);
  }
  return (int)cudaGetLastError();
}

const char* sqtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
