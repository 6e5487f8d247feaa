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
// Design. One thread per pixel; the grid is (pixel tiles, B). Each block
// reads its sample's frame scalars (packed by the Python wrapper: a,
// 1/e2, e2/e1, 1/e1, t_rot, R(q*), z_hi, step) into shared memory once.
// A thread leaves the sweep at its first inside slab (the result is the
// same as finishing it) and skips bisection when it found nothing. The
// thread index is the output position (row, col), so the y flip and the
// floor(255 z)/255 quantization are fused into one coalesced store:
// row = s-1-y, col = x.
//
// What bounds it on this card: arithmetic, not bytes. At eval settings a
// pixel makes up to 64 + 16 = 80 inside tests of 4 logf + 4 expf and about
// 20 other fp32 operations each, which land on the special-function units
// and the FMA pipes; the only traffic is 96 bytes of parameters in and a
// 256 KB image out per sample. This is the simple version that is right
// first (no fast-math intrinsics, no shared work across pixels); making it
// fast is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kParStride = 24;   // floats per sample in the packed params
constexpr int kParUsed = 20;
constexpr int kThreads = 256;
constexpr float kTiny = 1.1754944e-38f;  // FLT_MIN

struct Frame {
  float ux, vy, wz;     // body coordinates at z = 0
  float cux, cvy, cwz;  // their slopes in z
  float ie2, e21, ie1;
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

__global__ void __launch_bounds__(kThreads)
hardrender_kernel(const float* __restrict__ par, float* __restrict__ out,
                  int s, int n_sweep, int n_bisect, int quantize) {
  __shared__ float p[kParUsed];
  const int b = blockIdx.y;
  if (threadIdx.x < kParUsed) {
    p[threadIdx.x] = par[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();

  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= s * s) return;
  const int row = idx / s;
  const int col = idx - row * s;
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

  float lo = 0.0f;
  bool hit = false;
  for (int j = 0; j < n_sweep; ++j) {
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
  out[(size_t)b * s * s + idx] = depth;
}

}  // namespace

extern "C" {

// par: (batch, 24) float32, out: (batch, s, s) float32, both on the device.
// Launches on `stream` and returns cudaGetLastError() as an int (0 = ok).
int sqtpu_hardrender(const void* par, void* out, int batch, int s,
                     int n_sweep, int n_bisect, int quantize, void* stream) {
  const dim3 grid((s * s + kThreads - 1) / kThreads, batch);
  hardrender_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)par, (float*)out, s, n_sweep, n_bisect, quantize);
  return (int)cudaGetLastError();
}

const char* sqtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
