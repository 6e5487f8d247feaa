// The implicit (self-supervised depth) loss for Hopper (sm_90a): forward K1
// and analytic backward K2.
//
// K1 replaces sqtpu/ops/kernels/implicit.py::_fwd_kernel and K2 replaces
// sqtpu/ops/kernels/implicit.py::_bwd_kernel (the Pallas TPU kernels behind
// implicit_loss_pallas). K6 replaces implicit_sums_pallas_slab, the
// grid-sharded loss's slab: the same two kernels launched on n_cols < n
// image columns from the x offset in slot 19, as the TPU launches its own
// pallas_call on a slab. The algorithm is the TPU kernels':
//
//   occupancy sigmoid(sharp (1 − F)) with F as in sq_field.cuh,
//   S = running sum far→near, Tacc = c_pre + Σ_window exp(−τ S)
//   + c_post exp(−τ S_end), loss sum = Σ_pixels |img − (1 − Tacc / n)|
//
// K2 sweeps the window once more, far→near, recomputing S_j and T_j, and
// recovers the prefix sum W_j = Tacc − V + T_j (V starts at c_pre); with
// φ = −sign(img − depth) g τ / n it forms gF = φ W (−sharp) occ (1 − occ)
// and accumulates the 17 frame-parameter gradients through the log-space
// dF chain with its exponent clamped at 30 (without the clamp, inf·0 gives
// NaN outside the occupancy shell). It writes the image cotangent sign·g.
//
// What bounds them on this card: operations. K1 makes 12 accurate
// logf/expf a point it evaluates, K2 16, and the bytes are a few B·n²
// floats (image, Tacc, cotangent). The first port (a thread per pixel
// sweeping its whole window, the field with 6 divisions a point, K2's
// 17-term chain with about 20 more and 17 accumulators: 78 registers, 3
// blocks a SM) took 1.0 and 4.7 ms at B=512, N=64 on one H100. This
// design, K4's (explicit.cu) carried over:
// * Per-sample constants once. The block prologue computes the row's
//   reciprocals and slopes (sq_field.cuh make_recip) and the cull's box
//   into shared memory; the per-point chain (field_terms_lin,
//   sep_grad_step) multiplies by them and divides only in the sigmoid.
// * Body coordinates linear in z along a pixel's ray: u = u0 + cu·z.
// * K2's separable sums: 11 running sums a pixel (SepAcc) instead of 17,
//   scaled once at the ray's end (sep_finish); __launch_bounds__(256, 4)
//   caps a thread at 64 registers for 4 blocks a SM.
// * The exact-zero cull (sq_field.cuh). Each pixel sweeps only the planes
//   [a, b] of its window inside the frame's box, where a point can have a
//   non-zero occupancy. Every other plane has occupancy exactly 0.0f, so:
//   the far planes b < j ≤ j_hi, swept first, keep S = 0 and add T = 1
//   each, which t_in (K1) and V (K2) take as the integer hi − b, exactly
//   what adds of 1.0 from 0 give; the near planes j_lo ≤ j < a each add
//   T_end = exp(−τ S_end) to t_in, kept as a loop of adds (a product
//   would round differently); in K2 they add ±0 to every gradient sum and
//   are not read. Inside [a, b], K2 skips sep_grad_step where gF is ±0
//   (occupancy exactly 1.0f deep inside the body), which adds ±0 to every
//   sum too (4.5% of K2's time on one H100). So Tacc, the sums and the
//   gradient are the bits of the same algorithm swept over the whole
//   window. The cull runs for a row that cull_sound proves, with 0 < sharp
//   and 0 ≤ τ finite (S and T stay in [0, n] and [0, 1]); in K2 also only
//   for a pixel whose φ and Tacc are finite: a NaN cotangent or image
//   pixel turns every point of the uncut sweep into NaN (NaN·0), and the
//   cull must not hide that. Any other pixel sweeps its whole window.
// * A warp is an 8 (y) × 4 (x) tile of pixels and a block a 16 × 16 tile
//   (2 × 4 warps), so that a warp's lanes have similar intervals; y runs
//   fastest, so 8 lanes read 8 consecutive floats of the (x_local·n + y)
//   plane. The last tiles mask pixels beyond n and n_cols (slabs).
// Reductions are deterministic: a fixed shuffle tree inside each warp, the
// warps in order inside the block into a (batch, blocks[, 17]) partial
// buffer, then sum_partials in block order. No float atomics, and accurate
// logf/expf (no fast-math, for parity with the reference): two runs give
// the same bits.

#include "sq_field.cuh"

// Built with -DSQTPU_IMPLICIT_CULL=0, every pixel sweeps its whole window
// and K2 skips no point: the uncut sweep that `kernel_ab.py` holds the
// culled one against, bit for bit.
#ifndef SQTPU_IMPLICIT_CULL
#define SQTPU_IMPLICIT_CULL 1
#endif

namespace {

constexpr int kSlotX0 = 19;  // x offset of the plane slab
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks a SM: 64 registers a thread
constexpr int kTile = 16;      // a block's pixels: 16 (y) × 16 (x)

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // 0 -> 0, NaN -> NaN
}

// A sample's constants, computed once a block into shared memory.
struct Sample {
  float p[kParStride];
  Recip k;
  float bb;  // the cull's box half-width; 0: no cull for this row
};

__device__ __forceinline__ void load_sample(Sample& s,
                                            const float* __restrict__ par,
                                            int b, float tau, float sharp) {
  if (threadIdx.x < kParStride) {
    s.p[threadIdx.x] = par[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) s.k = make_recip(s.p);
  if (threadIdx.x == 32) {
    const bool ok = SQTPU_IMPLICIT_CULL && sharp > 0.0f &&
                    sharp <= FLT_MAX && tau >= 0.0f && tau <= FLT_MAX &&
                    cull_sound(s.p);
    s.bb = ok ? box_half_width(sharp) : 0.0f;
  }
  __syncthreads();
}

struct Pixel {
  bool live;
  size_t at;        // offset of the pixel in the (batch, plane) arrays
  float X, Y;
  float u0, v0, w0;  // body coordinates at z = 0
};

__device__ __forceinline__ Pixel pixel(const Sample& s, int b, int n,
                                       int n_cols, float inv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles_y = (n + kTile - 1) / kTile;
  const int y = (blockIdx.x % tiles_y) * kTile + (warp & 1) * 8 +
                (lane & 7);
  const int x = (blockIdx.x / tiles_y) * kTile + (warp >> 1) * 4 +
                (lane >> 3);
  Pixel px;
  px.live = x < n_cols && y < n;
  px.at = ((size_t)b * n_cols + x) * n + y;
  px.X = coord(x + (int)s.p[kSlotX0], inv);
  px.Y = coord(y, inv);
  px.u0 = (s.p[8] * px.X + s.p[9] * px.Y - s.p[5]) * s.k.ia1;
  px.v0 = (s.p[11] * px.X + s.p[12] * px.Y - s.p[6]) * s.k.ia2;
  px.w0 = (s.p[14] * px.X + s.p[15] * px.Y - s.p[7]) * s.k.ia3;
  return px;
}

// The planes a pixel sweeps, from b down to a: the window [lo, hi], cut to
// the frame's box when `cull`; a = lo, b = lo − 1 when no plane is left.
__device__ __forceinline__ void sweep_range(const Sample& s, const Pixel& px,
                                            int n, int lo, int hi, bool cull,
                                            int& a, int& b) {
  a = lo;
  b = hi;
  if (cull) {
    int j0, j1;
    box_planes(s.k, px.u0, px.v0, px.w0, s.bb, n - 1, j0, j1);
    a = max(lo, j0);
    b = min(hi, j1);
    if (a > b) {
      a = lo;
      b = lo - 1;
    }
  }
}

__device__ __forceinline__ Terms field_at(const Recip& k, const Pixel& px,
                                          float z) {
  return field_terms_lin(k, px.u0 + k.cu * z, px.v0 + k.cv * z,
                         px.w0 + k.cw * z);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
implicit_fwd_kernel(const float* __restrict__ par,
                    const float* __restrict__ img, float* __restrict__ tacc,
                    float* __restrict__ partial, int n, int n_cols, float tau,
                    float sharp) {
  __shared__ Sample s;
  __shared__ float red[kWarps];
  const int b = blockIdx.y;
  load_sample(s, par, b, tau, sharp);
  const int lo = (int)s.p[kSlotJLo], hi = (int)s.p[kSlotJHi];
  const float inv = (float)(1.0 / (double)(n - 1));
  const Pixel px = pixel(s, b, n, n_cols, inv);

  float diff = 0.0f;
  if (px.live) {
    int ja, jb;
    sweep_range(s, px, n, lo, hi, s.bb > 0.0f, ja, jb);
    float S = 0.0f;
    float t_in = (float)(hi - jb);  // the far planes: T = 1 each
    for (int j = jb; j >= ja; --j) {
      S += occupancy(field_at(s.k, px, coord(j, inv)).F, sharp);
      t_in += expf(-tau * S);
    }
    const float t_end = expf(-tau * S);
    for (int j = ja - 1; j >= lo; --j) t_in += t_end;  // the near planes
    const float c_pre = (float)(n - 1) - (float)hi;
    const float T = c_pre + t_in + (float)lo * t_end;
    tacc[px.at] = T;
    diff = fabsf(img[px.at] - (1.0f - T / (float)n));
  }
  diff = warp_sum(diff);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = diff;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int k = 0; k < kWarps; ++k) t += red[k];
    partial[(size_t)b * gridDim.x + blockIdx.x] = t;
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
implicit_bwd_kernel(const float* __restrict__ par, const float* __restrict__ g,
                    const float* __restrict__ img,
                    const float* __restrict__ tacc, float* __restrict__ dimg,
                    float* __restrict__ partial, int n, int n_cols, float tau,
                    float sharp, float tau_n) {
  __shared__ Sample s;
  __shared__ float red[kNPar][kWarps];
  const int b = blockIdx.y;
  load_sample(s, par, b, tau, sharp);
  const int lo = (int)s.p[kSlotJLo], hi = (int)s.p[kSlotJHi];
  const float inv = (float)(1.0 / (double)(n - 1));
  const Pixel px = pixel(s, b, n, n_cols, inv);

  SepAcc sa = {};
  if (px.live) {
    const float Tacc = tacc[px.at];
    const float depth = 1.0f - Tacc / (float)n;
    const float sgn = sign_of(img[px.at] - depth);
    const float gb = g[b];
    dimg[px.at] = sgn * gb;
    const float phi = -sgn * gb * tau_n;
    int ja, jb;
    sweep_range(s, px, n, lo, hi,
                s.bb > 0.0f && isfinite(phi) && isfinite(Tacc), ja, jb);
    float S = 0.0f;
    float V = (float)(n - 1) - (float)hi;  // c_pre
    V += (float)(hi - jb);                 // the far planes: T = 1 each
    for (int j = jb; j >= ja; --j) {
      const float z = coord(j, inv);
      const Terms t = field_at(s.k, px, z);
      const float occ = occupancy(t.F, sharp);
      S += occ;
      const float Tj = expf(-tau * S);
      V += Tj;
      const float W = Tacc - V + Tj;
      const float gF = phi * W * (-sharp) * occ * (1.0f - occ);
      // gF = ±0 (occupancy 1.0f deep inside, or 0.0f) adds ±0 to every
      // sum of a row cull_sound proves: skipped. A NaN gF is not.
      if (gF != 0.0f || s.bb == 0.0f) sep_grad_step(sa, t, gF, s.k, z);
    }
  }
  float acc[kNPar];
  sep_finish(acc, sa, s.k, px.X, px.Y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kNPar; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) red[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNPar) {
    float t = 0.0f;
    for (int k = 0; k < kWarps; ++k) t += red[threadIdx.x][k];
    partial[((size_t)b * gridDim.x + blockIdx.x) * kNPar + threadIdx.x] = t;
  }
}

int blocks_per_sample(int n, int n_cols) {
  return ((n + kTile - 1) / kTile) * ((n_cols + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// Thread blocks per sample: the width of the wrapper's partial buffers.
int sqtpu_implicit_blocks(int n, int n_cols) {
  return blocks_per_sample(n, n_cols);
}

// K1. par: (batch, 24), img and tacc: (batch, n * n_cols), partial:
// (batch, blocks), sums: (batch,), all float32 on the device. Launches on
// `stream`; returns the first cudaGetLastError() code (0 = ok).
int sqtpu_implicit_fwd(const void* par, const void* img, void* tacc,
                       void* partial, void* sums, int batch, int n,
                       int n_cols, double tau, double sharp, void* stream) {
  const int blocks = blocks_per_sample(n, n_cols);
  cudaStream_t s = (cudaStream_t)stream;
  implicit_fwd_kernel<<<dim3(blocks, batch), kThreads, 0, s>>>(
      (const float*)par, (const float*)img, (float*)tacc, (float*)partial,
      n, n_cols, (float)tau, (float)sharp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(batch + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial, (float*)sums, batch, blocks, 1, 1);
  return (int)cudaGetLastError();
}

// K2. g: (batch,), dimg: (batch, n * n_cols), partial: (batch, blocks, 17),
// dpar: (batch, 24) with slots 17-23 written as 0.
int sqtpu_implicit_bwd(const void* par, const void* g, const void* img,
                       const void* tacc, void* dimg, void* partial,
                       void* dpar, int batch, int n, int n_cols, double tau,
                       double sharp, void* stream) {
  const int blocks = blocks_per_sample(n, n_cols);
  cudaStream_t s = (cudaStream_t)stream;
  implicit_bwd_kernel<<<dim3(blocks, batch), kThreads, 0, s>>>(
      (const float*)par, (const float*)g, (const float*)img,
      (const float*)tacc, (float*)dimg, (float*)partial, n, n_cols,
      (float)tau, (float)sharp, (float)(tau / n));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = batch * kParStride;
  sum_partials<<<(outs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial, (float*)dpar, batch, blocks, kNPar, kParStride);
  return (int)cudaGetLastError();
}

const char* sqtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
