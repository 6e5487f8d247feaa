// The explicit (occupancy-grid MSE) loss for Hopper (sm_90a): the fused value
// and gradient K4, and the loss alone K5.
//
// K4 replaces sqtpu/ops/kernels/explicit.py::_fused_kernel and K5 replaces
// sqtpu/ops/kernels/explicit.py::_fwd_kernel (the Pallas TPU kernels behind
// explicit_loss_pallas). Same arithmetic as those kernels, point for point,
// on the (N+1)³ explicit lattice (coordinates k/N, index 0 nudged to 1e-4):
//
//   occ = sigmoid(sharp (1 − F)) of the true and of the predicted
//   superquadric, F as in sq_field.cuh; d = occ_t − occ_p
//   K5: sum = Σ_points d²
//   K4: the same sum, and the gradient of the 17 frame scalars of pred
//       (a, e, R(q*)·t, R(q*)) with gF = dd²/dF_p = 2 d sharp occ_p (1 − occ_p)
//       through the dF chain the implicit-loss kernels share
//       (sq_field.cuh), summed per column (sep_grad_step)
//
// The wrapper scales the sums by 100/(N+1)³ and applies the upstream
// cotangent, a scalar per sample, to K4's gradient; the true side gets no
// gradient. Each sample sweeps the planes j = j_lo .. j_hi that its pred
// parameters carry in slots 17-18 (the union of both shapes' z windows, or
// the full [0, N]).
//
// The design for this card, one body for both kernels (explicit_body,
// templated on whether the gradient is taken; the first port's K4, a
// thread per column that divided at every point, took 36 ms on one H100
// 80GB HBM3, 700.00 W at the c4c shape, and its K5 6.9 ms):
// * One thread per (x, y) lattice column of one sample; the grid is
//   (column blocks, batch). A block reads its sample's two 24-float
//   parameter rows into shared memory once. The TPU kernel's 128-lane
//   padding, its validity mask, its tiling of several samples per program
//   and its 256-sample chunks (limits of the TPU's vector and scalar
//   memories) have no counterpart: one launch covers any batch.
// * Per-sample constants once. The block prologue computes both rows'
//   reciprocals and slopes (sq_field.cuh make_recip) into shared memory;
//   the per-point chain (field_terms_lin, and K4's sep_grad_step)
//   multiplies by them and divides only in the two sigmoids.
// * Body coordinates linear in z along a column: u = u0 + cu·z.
// * K4's separable sums: 11 running sums a column (SepAcc) instead of 17,
//   scaled by X/a, Y/a and −1/a once at the column's end (sep_finish).
// * The exact-zero cull (below): a column sweeps only the planes where a
//   point can add anything.
// * A warp is an 8 × 4 tile of columns and a block a 16 × 16 tile (2 × 4
//   warps), so that a warp's columns, and a block's, have similar z
//   intervals.
// * K5 is the body without the gradient: the same columns, planes and
//   per-point arithmetic in the same order, so its per-sample sums are
//   K4's.
// Reductions are deterministic, as in implicit.cu: a fixed shuffle tree
// inside each warp, the warps in order into a (batch, blocks[, 17])
// partial buffer, then sum_partials in block order. No float atomics, so
// two runs give the same bits.
//
// What bounds them on this card: operations. Per evaluated point both
// evaluate two fields and two sigmoids (11 logf/expf) and K4 adds the
// 17-term gradient chain (4 more expf); the bytes are two (B, 24)
// parameter rows in and B or B·24 floats out. Accurate logf/expf (no
// fast-math, for parity with the reference).
//
// The exact-zero cull (sq_field.cuh, shared with K1/K2): where both
// shapes' occupancies are exactly 0.0f at a point, d = 0 and gF = 2·d·
// sharp·occ_p·(1 − occ_p) = 0, so the point adds ±0 to every sum and
// skipping it changes no bit. So each column sweeps only the planes of its
// window where |u|, |v| and |w| ≤ bb for the true OR the pred frame (the
// hull of the two z intervals, box_planes with the lattice's last index N),
// for a sample whose two rows prove the bounds (cull_sound); any other
// sample sweeps its whole window.

#include "sq_field.cuh"

// Built with -DSQTPU_EXPLICIT_CULL=0, every column sweeps its sample's
// whole window in both kernels: the uncut sweep that `kernel_ab.py` holds
// the culled one against, bit for bit.
#ifndef SQTPU_EXPLICIT_CULL
#define SQTPU_EXPLICIT_CULL 1
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockTile = 16;      // a block's columns: 16 × 16
constexpr int kFusedMinBlocks = 4;  // K4's blocks a SM: 64 registers
constexpr int kFwdMinBlocks = 4;    // K5's: 8 ran slower on one H100

__device__ __forceinline__ void load_rows(const float* __restrict__ par_t,
                                          const float* __restrict__ par_p,
                                          float* st, float* sp, int b) {
  if (threadIdx.x < kParStride) {
    st[threadIdx.x] = par_t[(size_t)b * kParStride + threadIdx.x];
    sp[threadIdx.x] = par_p[(size_t)b * kParStride + threadIdx.x];
  }
  __syncthreads();
}

// One block of K4 (kGrad) or K5: the sums of d² over its 16 × 16 columns
// into partial_sum[b, block], and with kGrad the 17 gradient sums into
// partial_grad[b, block, :].
template <bool kGrad>
__device__ __forceinline__ void explicit_body(
    const float* __restrict__ par_t, const float* __restrict__ par_p,
    float* __restrict__ partial_sum, float* __restrict__ partial_grad,
    int n, float sharp) {
  constexpr int kSums = kGrad ? kNPar + 1 : 1;  // the sum last
  __shared__ float st[kParStride], sp[kParStride];
  __shared__ Recip kr[2];
  __shared__ float s_bb;  // the cull's box half-width; 0: no cull
  __shared__ float red[kSums][kWarps];
  const int b = blockIdx.y;
  load_rows(par_t, par_p, st, sp, b);
  if (threadIdx.x < 2) kr[threadIdx.x] = make_recip(threadIdx.x ? sp : st);
  if (threadIdx.x == 2) {
    const bool ok = SQTPU_EXPLICIT_CULL && sharp > 0.0f && sharp <= FLT_MAX &&
                    cull_sound(st) && cull_sound(sp);
    s_bb = ok ? box_half_width(sharp) : 0.0f;
  }
  __syncthreads();
  const Recip& kt = kr[0];
  const Recip& kp = kr[1];
  const int lo = (int)sp[kSlotJLo], hi = (int)sp[kSlotJHi];
  const float inv = (float)(1.0 / (double)n);

  // this thread's column: warps are 8 × 4 tiles, 2 × 4 of them a block
  const int m = n + 1;
  const int tiles = (m + kBlockTile - 1) / kBlockTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int xi = (blockIdx.x % tiles) * kBlockTile + (warp & 1) * 8 +
                 (lane & 7);
  const int yi = (blockIdx.x / tiles) * kBlockTile + (warp >> 1) * 4 +
                 (lane >> 3);
  const float X = coord(xi, inv), Y = coord(yi, inv);

  float sum = 0.0f;
  SepAcc s = {};
  if (xi < m && yi < m) {
    const float u0t = (st[8] * X + st[9] * Y - st[5]) * kt.ia1;
    const float v0t = (st[11] * X + st[12] * Y - st[6]) * kt.ia2;
    const float w0t = (st[14] * X + st[15] * Y - st[7]) * kt.ia3;
    const float u0p = (sp[8] * X + sp[9] * Y - sp[5]) * kp.ia1;
    const float v0p = (sp[11] * X + sp[12] * Y - sp[6]) * kp.ia2;
    const float w0p = (sp[14] * X + sp[15] * Y - sp[7]) * kp.ia3;
    int j0 = lo, j1 = hi;
    const float bb = s_bb;
    if (bb > 0.0f) {
      int jt0, jt1, jp0, jp1;
      box_planes(kt, u0t, v0t, w0t, bb, n, jt0, jt1);
      box_planes(kp, u0p, v0p, w0p, bb, n, jp0, jp1);
      j0 = max(lo, min(jt0, jp0));
      j1 = min(hi, max(jt1, jp1));
    }
    for (int j = j0; j <= j1; ++j) {
      const float z = coord(j, inv);
      const float occ_t = occupancy(
          field_terms_lin(kt, u0t + kt.cu * z, v0t + kt.cv * z,
                          w0t + kt.cw * z).F, sharp);
      const Terms t = field_terms_lin(kp, u0p + kp.cu * z, v0p + kp.cv * z,
                                      w0p + kp.cw * z);
      const float occ_p = occupancy(t.F, sharp);
      const float d = occ_t - occ_p;
      sum += d * d;
      if constexpr (kGrad) {
        const float gF = 2.0f * d * sharp * occ_p * (1.0f - occ_p);
        sep_grad_step(s, t, gF, kp, z);
      }
    }
  }
  if constexpr (kGrad) {
    float acc[kNPar];
    sep_finish(acc, s, kp, X, Y);
#pragma unroll
    for (int i = 0; i < kNPar; ++i) {
      const float v = warp_sum(acc[i]);
      if (lane == 0) red[i][warp] = v;
    }
  }
  sum = warp_sum(sum);
  if (lane == 0) red[kSums - 1][warp] = sum;
  __syncthreads();
  if (threadIdx.x < kSums) {
    float t = 0.0f;
    for (int k = 0; k < kWarps; ++k) t += red[threadIdx.x][k];
    const size_t blk = (size_t)b * gridDim.x + blockIdx.x;
    if (kGrad && threadIdx.x < kNPar) {
      partial_grad[blk * kNPar + threadIdx.x] = t;
    } else {
      partial_sum[blk] = t;
    }
  }
}

// K4: the sums and the gradient.
__global__ void __launch_bounds__(kThreads, kFusedMinBlocks)
explicit_fused_kernel(const float* __restrict__ par_t,
                      const float* __restrict__ par_p,
                      float* __restrict__ partial_sum,
                      float* __restrict__ partial_grad, int n, float sharp) {
  explicit_body<true>(par_t, par_p, partial_sum, partial_grad, n, sharp);
}

// K5: the sums alone.
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
explicit_fwd_kernel(const float* __restrict__ par_t,
                    const float* __restrict__ par_p,
                    float* __restrict__ partial_sum, int n, float sharp) {
  explicit_body<false>(par_t, par_p, partial_sum, nullptr, n, sharp);
}

int column_blocks(int n) {
  const int tiles = (n + 1 + kBlockTile - 1) / kBlockTile;
  return tiles * tiles;
}

}  // namespace

extern "C" {

// Thread blocks per sample of K5 and of K4 (the same tiling): the widths
// of the wrapper's partial buffers.
int sqtpu_explicit_blocks(int n) { return column_blocks(n); }
int sqtpu_explicit_fused_blocks(int n) { return column_blocks(n); }

// K5. par_t, par_p: (batch, 24), partial: (batch, blocks), sums: (batch,),
// all float32 on the device. Launches on `stream`; returns the first
// cudaGetLastError() code (0 = ok).
int sqtpu_explicit_fwd(const void* par_t, const void* par_p, void* partial,
                       void* sums, int batch, int n, double sharp,
                       void* stream) {
  const int blocks = column_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  explicit_fwd_kernel<<<dim3(blocks, batch), kThreads, 0, s>>>(
      (const float*)par_t, (const float*)par_p, (float*)partial, n,
      (float)sharp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(batch + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial, (float*)sums, batch, blocks, 1, 1);
  return (int)cudaGetLastError();
}

// K4. partial_sum: (batch, fused blocks), partial_grad: (batch, fused
// blocks, 17), sums: (batch,), dpar: (batch, 24) with slots 17-23 written
// as 0.
int sqtpu_explicit_fused(const void* par_t, const void* par_p,
                         void* partial_sum, void* partial_grad, void* sums,
                         void* dpar, int batch, int n, double sharp,
                         void* stream) {
  const int blocks = column_blocks(n);
  cudaStream_t s = (cudaStream_t)stream;
  explicit_fused_kernel<<<dim3(blocks, batch), kThreads, 0, s>>>(
      (const float*)par_t, (const float*)par_p, (float*)partial_sum,
      (float*)partial_grad, n, (float)sharp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials<<<(batch + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial_sum, (float*)sums, batch, blocks, 1, 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int outs = batch * kParStride;
  sum_partials<<<(outs + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      (const float*)partial_grad, (float*)dpar, batch, blocks, kNPar,
      kParStride);
  return (int)cudaGetLastError();
}

const char* sqtpu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
