// Hard ray-cast depth renderer for Hopper (sm_90a).
//
// Replaces sqtpu/ops/kernels/hardrender.py::_kernel (the Pallas TPU kernel
// behind render_depth_hard_pallas). Same arithmetic: per pixel, a far->near
// sweep of n_sweep z-slabs over the superquadric's z support window finds
// the first slab inside the shape, then n_bisect bisection steps refine the
// crossing. The inside test omits the outer ^e1 power (monotone for e1 > 0):
//     (A + B)^(e2/e1) + C <= 1,  A = (u^2)^(1/e2), B = (v^2)^(1/e2), C = (w^2)^(1/e1)
// with each power taken as exp(log(x + FLT_MIN) * k), as on the TPU.
//
// What bounds it on this card: arithmetic, not bytes. An inside test is 4
// logf + 4 expf and about 20 other fp32 operations; the only traffic is 96
// bytes of parameters in and a 256 KB image out per sample. The first port
// (one thread per pixel, every pixel sweeping from z_hi; 4.6 ms on one
// H100 for 125 images at (64, 16)) spent most of its tests on background
// pixels, which sweep all n_sweep slabs. This design makes only the tests
// that can succeed, and gives every output bit of that full sweep:
//
// * Ray-box interval per pixel. u, v and w are linear in z along a pixel's
//   ray. If |u| > 1 + δ at a slab, the test fails there (proof below), and
//   the same for v and w. So each pixel computes, once, the slabs j whose z
//   lies in the z interval where |u|, |v|, |w| ≤ 1 + δ + (a rounding
//   allowance), and sweeps only those, from the first. A pixel whose ray
//   misses the box writes depth 0 and makes no test. Slabs above the
//   interval cannot be inside, so the first inside slab, the bisection and
//   the output are the full sweep's, bit for bit: the sweep's and the
//   bisection's arithmetic (inside(), z = z_hi − j·step) is unchanged.
// * 2-D pixel tiles: a warp is 8 columns × 4 rows and a block 32 × 8, so
//   a warp's pixels tend to hit, miss and leave the sweep together. Each
//   warp stores 4 row segments of 32 bytes.
//
// Why |u| > 1 + δ fails the test. Let x = u·u + FLT_MIN ≥ 1 + δ (as computed:
// (1 + δ)² rounded down is still ≥ 1 + δ). With 0 < δ ≤ 0.1, logf(x) ≥
// 0.95·δ, so A = expf(logf(x)·ie2) ≥ expf(0.95·δ·ie2) > 1 when δ·ie2 ≥
// 1e-3; then A + B + FLT_MIN ≥ A and E = expf(logf(A + B + FLT_MIN)·e21) ≥
// expf(0.9·δ·ie2·e21) > 1 when δ·ie2·e21 ≥ 1e-3, and E + C > 1 as C ≥ 0.
// For w: C ≥ expf(0.95·δ·ie1) > 1 when δ·ie1 ≥ 1e-3, and E ≥ 0. So
//     δ = 1e-3 · max(1, 1/ie1, 1/ie2, 1/(ie2·e21))
// per sample (each product ≥ 1e-3 then exceeds 2^-23 by far more than the
// few ulps logf and expf may be off). The proof needs δ ≤ 0.1, so a sample
// whose ie1, ie2 or ie2·e21 is below 0.01 (an exponent above 100), or whose
// frame scalars are not finite, or whose step is not positive, sweeps
// every slab as before. pack_frames does not clamp, so this holds for
// every e > 0 the wrapper takes.
//
// The rounding allowance. The interval is computed in double from the
// pixel's float ux and slope cux. The float sweep computes z_j = z_hi −
// j·step and u_j = ux + cux·z_j with at most two roundings each (fused or
// not), so |u_j − (ux + cux·(z_hi − j·step))| ≤ 2^-22·(|ux| + |cux|·zmax),
// zmax = |z_hi| + (n_sweep − 1)·step; the allowance is four times that,
// 2^-20·(|ux| + |cux|·zmax), and the double arithmetic of the interval
// and of its slab indices adds ~1e-13. So a slab left out has |u_j| > 1 + δ.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kParStride = 24;   // floats per sample in the packed params
constexpr int kParUsed = 20;
constexpr int kThreads = 256;
constexpr int kTileW = 32, kTileH = 8;  // a block's pixels: 4 × 2 warps
constexpr float kTiny = 1.1754944e-38f;  // FLT_MIN

struct Frame {
  float ux, vy, wz;     // body coordinates at z = 0
  float cux, cvy, cwz;  // their slopes in z
  float ie2, e21, ie1;
};

// Per-sample constants of the ray-box interval, computed once a block.
struct Box {
  double ic[3];  // 1/cux, 1/cvy, 1/cwz (0 where the slope is 0)
  double delta;  // δ
  double zmax;   // bound of |z| over the sweep's slabs
  double istep;  // 1/step
  int on;        // 0: the sample sweeps every slab
};

__device__ __forceinline__ bool inside(const Frame& f, float z) {
  const float u = f.ux + f.cux * z;
  const float v = f.vy + f.cvy * z;
  const float w = f.wz + f.cwz * z;
  const float A = expf(logf(u * u + kTiny) * f.ie2);
  const float B = expf(logf(v * v + kTiny) * f.ie2);
  const float C = expf(logf(w * w + kTiny) * f.ie1);
  const float E = expf(logf(A + B + kTiny) * f.e21);
  return E + C <= 1.0f;
}

__device__ Box make_box(const float* p, int n_sweep) {
  Box k;
  bool finite = true;
  for (int i = 0; i < kParUsed; ++i) finite = finite && isfinite(p[i]);
  const double ie2 = p[3], e21 = p[4], ie1 = p[5];
  const double lo = fmin(fmin(ie1, ie2), ie2 * e21);
  k.on = finite && lo >= 0.01 && p[0] > 0.0f && p[1] > 0.0f &&
         p[2] > 0.0f && p[19] > 0.0f;
  k.delta = 1e-3 * fmax(1.0, 1.0 / lo);
  const float c[3] = {p[11] / p[0], p[14] / p[1], p[17] / p[2]};
  for (int i = 0; i < 3; ++i) k.ic[i] = c[i] != 0.0f ? 1.0 / c[i] : 0.0;
  k.zmax = fabs((double)p[18]) + (double)(n_sweep - 1) * p[19];
  k.istep = 1.0 / (double)p[19];
  return k;
}

// Narrow [lo, hi] to the z where |u0 + c·z| is within the box; false when
// the interval is empty.
__device__ __forceinline__ bool clip_axis(const Box& k, float u0, float c,
                                          double ic, double& lo,
                                          double& hi) {
  const double b = 1.0 + k.delta +
                   0x1p-20 * (fabs((double)u0) + fabs((double)c) * k.zmax);
  if (c == 0.0f) return fabs((double)u0) <= b;
  const double za = (-b - u0) * ic, zb = (b - u0) * ic;
  lo = fmax(lo, fmin(za, zb));
  hi = fmin(hi, fmax(za, zb));
  return lo <= hi;
}

// The slabs [j0, j1] this pixel sweeps; j0 > j1 when its ray misses.
__device__ __forceinline__ void slab_range(const Box& k, const Frame& f,
                                           float z_hi, int n_sweep, int& j0,
                                           int& j1) {
  j0 = 0;
  j1 = n_sweep - 1;
  if (!k.on || !(fabsf(f.ux) <= FLT_MAX && fabsf(f.vy) <= FLT_MAX &&
                 fabsf(f.wz) <= FLT_MAX)) {
    return;
  }
  double lo = -INFINITY, hi = INFINITY;
  if (!(clip_axis(k, f.ux, f.cux, k.ic[0], lo, hi) &&
        clip_axis(k, f.vy, f.cvy, k.ic[1], lo, hi) &&
        clip_axis(k, f.wz, f.cwz, k.ic[2], lo, hi))) {
    j1 = -1;
    return;
  }
  // slab j is at z_hi − j·step
  const double first = ceil((z_hi - hi) * k.istep);
  const double last = floor((z_hi - lo) * k.istep);
  j0 = first > 0.0 ? (int)fmin(first, (double)n_sweep) : 0;
  j1 = last < n_sweep - 1 ? (int)fmax(last, -1.0) : n_sweep - 1;
}

__global__ void __launch_bounds__(kThreads)
hardrender_kernel(const float* __restrict__ par, float* __restrict__ out,
                  int s, int n_sweep, int n_bisect, int quantize) {
  __shared__ float p[kParUsed];
  __shared__ Box box;
  const int b = blockIdx.y;
  if (threadIdx.x < kParUsed) {
    p[threadIdx.x] = par[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) box = make_box(p, n_sweep);
  __syncthreads();

  // this thread's pixel: warps are 8 × 4 tiles, 4 × 2 of them a block
  const int tiles_w = (s + kTileW - 1) / kTileW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (blockIdx.x % tiles_w) * kTileW + (warp & 3) * 8 +
                  (lane & 7);
  const int row = (blockIdx.x / tiles_w) * kTileH + (warp >> 2) * 4 +
                  (lane >> 3);
  if (col >= s || row >= s) return;
  const float inv = 1.0f / (float)(s - 1);
  const float X = (float)col * inv;            // col = x
  const float Y = (float)(s - 1 - row) * inv;  // row = s-1-y

  const float a1 = p[0], a2 = p[1], a3 = p[2];
  Frame f;
  f.ie2 = p[3];
  f.e21 = p[4];
  f.ie1 = p[5];
  const float t0 = p[6], t1 = p[7], t2 = p[8];
  f.ux = (p[9] * X + p[10] * Y - t0) / a1;
  f.vy = (p[12] * X + p[13] * Y - t1) / a2;
  f.wz = (p[15] * X + p[16] * Y - t2) / a3;
  f.cux = p[11] / a1;
  f.cvy = p[14] / a2;
  f.cwz = p[17] / a3;
  const float z_hi = p[18];
  const float step = p[19];

  int j0, j1;
  slab_range(box, f, z_hi, n_sweep, j0, j1);
  float lo = 0.0f;
  bool hit = false;
  for (int j = j0; j <= j1; ++j) {
    const float z = z_hi - (float)j * step;
    if (inside(f, z)) {
      lo = z;
      hit = true;
      break;
    }
  }
  float depth = 0.0f;
  if (hit) {
    float hi = lo + step;
    for (int k = 0; k < n_bisect; ++k) {
      const float mid = 0.5f * (lo + hi);
      if (inside(f, mid)) {
        lo = mid;
      } else {
        hi = mid;
      }
    }
    depth = lo;
  }
  if (quantize) depth = floorf(depth * 255.0f) / 255.0f;
  out[(size_t)b * s * s + (size_t)row * s + col] = depth;
}

}  // namespace

extern "C" {

// par: (batch, 24) float32, out: (batch, s, s) float32, both on the device.
// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int sqtpu_hardrender(const void* par, void* out, int batch, int s,
                     int n_sweep, int n_bisect, int quantize, void* stream) {
  const int tiles = ((s + kTileW - 1) / kTileW) * ((s + kTileH - 1) / kTileH);
  hardrender_kernel<<<dim3(tiles, batch), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)par, (float*)out, s, n_sweep, n_bisect, quantize);
  return (int)cudaGetLastError();
}

const char* sqtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
