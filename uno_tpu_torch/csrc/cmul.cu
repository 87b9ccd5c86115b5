// Truncated-mode complex contraction of the FFT-path spectral conv:
//
//     y[b, o, m] = sum_i x[b, i, m] * w[i, o, m]        (complex64)
//
// x is (B, Ci, M), w is (Ci, Co, M), y is (B, Co, M), all interleaved
// complex (float2: re, im), contiguous, M fastest.  One independent
// (B x Ci) @ (Ci x Co) complex product per Fourier mode m.
//
// Replaces the TPU kernel uno_tpu/ops/pallas/cmul.py: _contract_kernel
// (launched by lane_contract), which put the mode axis in the TPU's 128
// lanes and contracted channels with broadcast multiply-adds.
//
// What bounds it on an H100: device-memory bytes.  At the Darcy S=211
// shapes the weights are Ci*Co*M complex values (8.4-21 MB per block) and
// each is used by only B (16) multiply-adds; x and y are a few MB.  So the
// design reads every weight once per batch chunk:
//   * one thread per (o, m), m fastest across the 32 lanes of a warp, so
//     every load of x, w and store of y is coalesced (256 B per warp);
//   * each thread keeps BT batch rows of accumulators in registers and
//     loops over i, so one load of w[i, o, m] feeds BT complex multiply-adds;
//   * the TO output channels of a block read the same x[b, i, m-tile]
//     slab, which the L1 cache serves after the first warp's load.
// Accumulation is in f32 with the plain 4-multiply complex product.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;  // modes per block (one warp along m)
constexpr int TO = 4;   // output channels per block (warps per block)
constexpr int BT = 8;   // batch rows accumulated per thread

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
