// The implicit (self-supervised depth) loss for Hopper (sm_90a): forward K1
// and analytic backward K2.
//
// K1 replaces sqtpu/ops/kernels/implicit.py::_fwd_kernel and K2 replaces
// sqtpu/ops/kernels/implicit.py::_bwd_kernel (the Pallas TPU kernels behind
// implicit_loss_pallas). K6 replaces implicit_sums_pallas_slab, the
// grid-sharded loss's slab: the same two kernels launched on n_cols < n
// image columns from the x offset in slot 19, as the TPU launches its own
// pallas_call on a slab. Same arithmetic as those kernels, point for point:
//
//   body coordinates  u = (R0·(X, Y, z) − t_rot0) / a1   (v, w likewise)
//   F = ((x2^(1/e2) + y2^(1/e2))^(e2/e1) + z2^(1/e1))^e1, with the 1e-4
//       guard at exact zeros of x2, y2, z2 and FLT_MIN added to both sums,
//       every power taken as expf(logf(.) · k)
//   occupancy sigmoid(sharp (1 − F)), S = running sum far→near,
//   Tacc = c_pre + Σ_window exp(−τ S) + c_post exp(−τ S_end)
//   loss sum = Σ_pixels |img − (1 − Tacc / n)|
//
// K2 sweeps the window once more, far→near, recomputing S_j and T_j, and
// recovers the prefix sum W_j = Tacc − V + T_j (V starts at c_pre); with
// φ = −sign(img − depth) g τ / n it forms gF = φ W (−sharp) occ (1 − occ)
// and accumulates the 17 frame-parameter gradients through the log-space
// dF chain with its exponent clamped at 30 (without the clamp, inf·0 gives
// NaN outside the occupancy shell). It writes the image cotangent sign·g.
// The field and its gradient chain live in sq_field.cuh, shared with the
// explicit-loss kernels (explicit.cu).
//
// Design. One thread per (x, y) pixel of one sample; the grid is (pixel
// blocks, batch). A block reads its sample's 24 packed scalars (a, e,
// R(q*)·t, R(q*), window [j_lo, j_hi], x offset) into shared memory once;
// each thread sweeps j = j_hi .. j_lo with S, Tacc (K1) or S, V and 17
// gradient accumulators (K2) in registers. The plane is x_local·n + y with x
// offset by slot 19 and n_cols columns, so a slab of image columns (K6)
// needs only another wrapper; the last block of a plane whose n·n_cols is
// not a multiple of the block masks its idle threads. Reductions are
// deterministic: a fixed shuffle tree inside each warp, the warps in order
// inside the block into a (batch, blocks[, 17]) partial buffer, then a
// second kernel that sums each sample's partials in block order. No float
// atomics, so two runs give the same bits.
//
// What bounds it on this card: operations. Per in-window point K1 makes 12
// transcendentals (5 logf, 7 expf incl. the sigmoid and the transmittance)
// and about 47 other fp32 operations; K2 recomputes those and adds 4 more
// expf (the clamped dF factors), about 20 divisions and about 90 other
// operations of the gradient chain. The bytes are a few B·n² floats
// (image, Tacc, cotangent). This is the simple version that is right
// first: accurate logf/expf (no fast-math, for parity with the reference),
// no sharing of work between pixels. Making it fast is later work.

#include "sq_field.cuh"

namespace {

constexpr int kSlotX0 = 19;  // x offset of the plane slab
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);  // 0 -> 0, NaN -> NaN
}

struct Pixel {
  bool live;
  size_t at;  // offset of the pixel in the (batch, plane) arrays
  float X, Y;
};

__device__ __forceinline__ Pixel pixel(int b, int n, int n_cols, int x0) {
  Pixel px;
  const int plane = n * n_cols;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  px.live = idx < plane;
  px.at = (size_t)b * plane + idx;
  const float inv = (float)(1.0 / (double)(n - 1));
  const int xi = idx / n + x0;
  const int yi = idx - (idx / n) * n;
  px.X = coord(xi, inv);
  px.Y = coord(yi, inv);
  return px;
}

__global__ void __launch_bounds__(kThreads)
implicit_fwd_kernel(const float* __restrict__ par,
                    const float* __restrict__ img, float* __restrict__ tacc,
                    float* __restrict__ partial, int n, int n_cols, float tau,
                    float sharp) {
  __shared__ float sp[kParStride];
  __shared__ float red[kWarps];
  const int b = blockIdx.y;
  if (threadIdx.x < kParStride) {
    sp[threadIdx.x] = par[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();
  const int lo = (int)sp[kSlotJLo], hi = (int)sp[kSlotJHi];
  const Pixel px = pixel(b, n, n_cols, (int)sp[kSlotX0]);
  const float inv = (float)(1.0 / (double)(n - 1));

  float diff = 0.0f;
  if (px.live) {
    const Frame f = load_frame(sp);
    float S = 0.0f, t_in = 0.0f;
    for (int j = hi; j >= lo; --j) {
      const Terms t = field_terms(f, px.X, px.Y, coord(j, inv));
      S += occupancy(t.F, sharp);
      t_in += expf(-tau * S);
    }
    const float c_pre = (float)(n - 1) - (float)hi;
    const float c_post = (float)lo;
    const float T = c_pre + t_in + c_post * expf(-tau * S);
    tacc[px.at] = T;
    diff = fabsf(img[px.at] - (1.0f - T / (float)n));
  }
  diff = warp_sum(diff);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = diff;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[k];
    partial[(size_t)b * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
implicit_bwd_kernel(const float* __restrict__ par, const float* __restrict__ g,
                    const float* __restrict__ img,
                    const float* __restrict__ tacc, float* __restrict__ dimg,
                    float* __restrict__ partial, int n, int n_cols, float tau,
                    float sharp, float tau_n) {
  __shared__ float sp[kParStride];
  __shared__ float red[kNPar][kWarps];
  const int b = blockIdx.y;
  if (threadIdx.x < kParStride) {
    sp[threadIdx.x] = par[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();
  const int lo = (int)sp[kSlotJLo], hi = (int)sp[kSlotJHi];
  const Pixel px = pixel(b, n, n_cols, (int)sp[kSlotX0]);
  const float inv = (float)(1.0 / (double)(n - 1));

  float acc[kNPar];
#pragma unroll
  for (int i = 0; i < kNPar; ++i) acc[i] = 0.0f;
  if (px.live) {
    const Frame f = load_frame(sp);
    const float Tacc = tacc[px.at];
    const float depth = 1.0f - Tacc / (float)n;
    const float sgn = sign_of(img[px.at] - depth);
    const float gb = g[b];
    dimg[px.at] = sgn * gb;
    const float phi = -sgn * gb * tau_n;
    float S = 0.0f;
    float V = (float)(n - 1) - (float)hi;  // c_pre: far planes had T = 1
    for (int j = hi; j >= lo; --j) {
      const float z = coord(j, inv);
      const Terms t = field_terms(f, px.X, px.Y, z);
      const float occ = occupancy(t.F, sharp);
      S += occ;
      const float Tj = expf(-tau * S);
      V += Tj;
      const float W = Tacc - V + Tj;
      const float gF = phi * W * (-sharp) * occ * (1.0f - occ);
      frame_grad_step(acc, t, gF, f, px.X, px.Y, z);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kNPar; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) red[i][warp] = v;
  }
  __syncthreads();
  if (threadIdx.x < kNPar) {
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s += red[threadIdx.x][k];
    partial[((size_t)b * gridDim.x + blockIdx.x) * kNPar + threadIdx.x] = s;
  }
}

int blocks_per_sample(int n, int n_cols) {
  return (n * n_cols + kThreads - 1) / kThreads;
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
