// Truncated-mode complex contraction of the FFT-path spectral conv, and its
// two backward contractions:
//
//     forward  y[b, o, m]  = sum_i x[b, i, m] * w[i, o, m]
//     dx       gx[b, i, m] = sum_o g[b, o, m] * conj(w[i, o, m])
//     dw       gw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]
//
// All complex64: (B, Ci, M) x, (Ci, Co, M) w, (B, Co, M) y and g, stored as
// interleaved complex (float2: re, im), contiguous, M fastest.  One
// independent (B x Ci) @ (Ci x Co) complex product per Fourier mode m.
//
// Replaces the TPU kernel uno_tpu/ops/pallas/cmul.py: _contract_kernel
// (launched by lane_contract), which put the mode axis in the TPU's 128
// lanes and contracted channels with broadcast multiply-adds.  uno_tpu runs
// that one kernel three times (cmul.py:139, :158, :162): forward, dx with w
// transposed and dw with x transposed.  Here each use has its own kernel,
// which reads its operands in place (no transposed copy of w or x).
//
// Gradient convention: the backward kernels return what torch autograd
// expects for a real loss, the conjugate-Wirtinger gradient, so they
// conjugate w (dx) and x (dw).  uno_tpu's backward returns the plain
// transposes (JAX's convention) and its Adam conjugates later; the port's
// Adam does not.
//
// What bounds them on an H100.  By bytes they would be short: at the Darcy
// S=211 shapes the weights (and dw) are Ci*Co*M complex values (8.4-21 MB
// per block), each taking part in only B (16) multiply-adds, and x, y and g
// are a few MB, so each call moves 11-35 MB, 3-10 us at the card's
// bandwidth.  Measured, they take 0.03-0.16 ms (0.07-0.6 TB/s): in the
// forward and dx each thread runs a serial loop over a channel axis (Ci or
// Co, up to 128 steps, each waiting on a global load) and the grid holds
// only 16K-170K threads, too few warps per SM to hide that latency.  Both
// lose to cuBLAS's batched complex GEMM by about 2x; splitting the channel
// loop across threads is the next design.  The present one keeps every
// access coalesced and touches each weight-sized element once:
//   * forward: one thread per (o, m), m fastest across the 32 lanes of a
//     warp, so every load of x and w and store of y is coalesced (256 B per
//     warp); BT batch rows of accumulators in registers, a loop over i, so
//     one load of w[i, o, m] feeds BT complex multiply-adds; the TO output
//     channels of a block read the same x[b, i, m-tile] slab, which the L1
//     cache serves after the first warp's load;
//   * dx: the same design with the roles of i and o swapped: one thread per
//     (i, m), BT batch rows, a loop over o reading w[i, o, m] in place;
//   * dw: one thread per (o, m) and IT input channels, a loop over the short
//     batch axis; each thread writes its IT outputs once.  No atomics, so
//     the result does not depend on scheduling.
// Accumulation is in f32 with the plain 4-multiply complex product.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;  // modes per block (one warp along m)
constexpr int TO = 4;   // channels per block along y (warps per block)
constexpr int BT = 8;   // batch rows accumulated per thread (forward, dx)
constexpr int IT = 4;   // input channels accumulated per thread (dw)

__global__ void __launch_bounds__(TM * TO)
cmul_fwd_kernel(const float2* __restrict__ x, const float2* __restrict__ w,
                float2* __restrict__ y, int B, int Ci, int Co, int M) {
  const int m = blockIdx.x * TM + threadIdx.x;
  const int o = blockIdx.y * TO + threadIdx.y;
  const int b0 = blockIdx.z * BT;
  if (m >= M || o >= Co) return;
  const int nb = min(BT, B - b0);
  const size_t x_bstride = (size_t)Ci * M;

  float acc_r[BT], acc_i[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    acc_r[j] = 0.f;
    acc_i[j] = 0.f;
  }

  const float2* xp = x + (size_t)b0 * x_bstride + m;
  const float2* wp = w + (size_t)o * M + m;
  for (int i = 0; i < Ci; ++i) {
    const float2 wv = __ldg(wp + (size_t)i * Co * M);
    const float2* xi = xp + (size_t)i * M;
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const float2 xv = __ldg(xi + j * x_bstride);
        acc_r[j] = fmaf(xv.x, wv.x, fmaf(-xv.y, wv.y, acc_r[j]));
        acc_i[j] = fmaf(xv.x, wv.y, fmaf(xv.y, wv.x, acc_i[j]));
      }
    }
  }

  float2* yp = y + (size_t)b0 * Co * M + (size_t)o * M + m;
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j < nb) yp[(size_t)j * Co * M] = make_float2(acc_r[j], acc_i[j]);
  }
}

// gx[b, i, m] = sum_o g[b, o, m] * conj(w[i, o, m])
__global__ void __launch_bounds__(TM * TO)
cmul_bwd_x_kernel(const float2* __restrict__ g, const float2* __restrict__ w,
                  float2* __restrict__ gx, int B, int Ci, int Co, int M) {
  const int m = blockIdx.x * TM + threadIdx.x;
  const int i = blockIdx.y * TO + threadIdx.y;
  const int b0 = blockIdx.z * BT;
  if (m >= M || i >= Ci) return;
  const int nb = min(BT, B - b0);
  const size_t g_bstride = (size_t)Co * M;

  float acc_r[BT], acc_i[BT];
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    acc_r[j] = 0.f;
    acc_i[j] = 0.f;
  }

  const float2* gp = g + (size_t)b0 * g_bstride + m;
  const float2* wp = w + (size_t)i * Co * M + m;
  for (int o = 0; o < Co; ++o) {
    const float2 wv = __ldg(wp + (size_t)o * M);
    const float2* go = gp + (size_t)o * M;
#pragma unroll
    for (int j = 0; j < BT; ++j) {
      if (j < nb) {
        const float2 gv = __ldg(go + j * g_bstride);
        // (gr + i gi)(wr - i wi) = (gr wr + gi wi) + i (gi wr - gr wi)
        acc_r[j] = fmaf(gv.x, wv.x, fmaf(gv.y, wv.y, acc_r[j]));
        acc_i[j] = fmaf(gv.y, wv.x, fmaf(-gv.x, wv.y, acc_i[j]));
      }
    }
  }

  float2* xp = gx + (size_t)b0 * Ci * M + (size_t)i * M + m;
#pragma unroll
  for (int j = 0; j < BT; ++j) {
    if (j < nb) xp[(size_t)j * Ci * M] = make_float2(acc_r[j], acc_i[j]);
  }
}

// gw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]
__global__ void __launch_bounds__(TM * TO)
cmul_bwd_w_kernel(const float2* __restrict__ x, const float2* __restrict__ g,
                  float2* __restrict__ gw, int B, int Ci, int Co, int M) {
  const int m = blockIdx.x * TM + threadIdx.x;
  const int o = blockIdx.y * TO + threadIdx.y;
  const int i0 = blockIdx.z * IT;
  if (m >= M || o >= Co) return;
  const int ni = min(IT, Ci - i0);

  float acc_r[IT], acc_i[IT];
#pragma unroll
  for (int t = 0; t < IT; ++t) {
    acc_r[t] = 0.f;
    acc_i[t] = 0.f;
  }

  for (int b = 0; b < B; ++b) {
    const float2 gv = __ldg(g + ((size_t)b * Co + o) * M + m);
    const float2* xb = x + ((size_t)b * Ci + i0) * M + m;
#pragma unroll
    for (int t = 0; t < IT; ++t) {
      if (t < ni) {
        const float2 xv = __ldg(xb + (size_t)t * M);
        // (xr - i xi)(gr + i gi) = (xr gr + xi gi) + i (xr gi - xi gr)
        acc_r[t] = fmaf(xv.x, gv.x, fmaf(xv.y, gv.y, acc_r[t]));
        acc_i[t] = fmaf(xv.x, gv.y, fmaf(-xv.y, gv.x, acc_i[t]));
      }
    }
  }

  float2* wp = gw + ((size_t)i0 * Co + o) * M + m;
#pragma unroll
  for (int t = 0; t < IT; ++t) {
    if (t < ni) wp[(size_t)t * Co * M] = make_float2(acc_r[t], acc_i[t]);
  }
}

}  // namespace

extern "C" int uno_cmul_fwd(const void* x, const void* w, void* y, int B,
                            int Ci, int Co, int M, void* stream) {
  const dim3 block(TM, TO);
  const dim3 grid((M + TM - 1) / TM, (Co + TO - 1) / TO, (B + BT - 1) / BT);
  cmul_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(w),
      static_cast<float2*>(y), B, Ci, Co, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uno_cmul_bwd_x(const void* g, const void* w, void* gx, int B,
                              int Ci, int Co, int M, void* stream) {
  const dim3 block(TM, TO);
  const dim3 grid((M + TM - 1) / TM, (Ci + TO - 1) / TO, (B + BT - 1) / BT);
  cmul_bwd_x_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(g), static_cast<const float2*>(w),
      static_cast<float2*>(gx), B, Ci, Co, M);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uno_cmul_bwd_w(const void* x, const void* g, void* gw, int B,
                              int Ci, int Co, int M, void* stream) {
  const dim3 block(TM, TO);
  const dim3 grid((M + TM - 1) / TM, (Co + TO - 1) / TO, (Ci + IT - 1) / IT);
  cmul_bwd_w_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), static_cast<const float2*>(g),
      static_cast<float2*>(gw), B, Ci, Co, M);
  return static_cast<int>(cudaGetLastError());
}
