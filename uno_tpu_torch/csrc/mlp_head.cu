// Fused projection head, forward:
//
//     out[b, o, n] = sum_h k2[h, o] * gelu(sum_c k1[c, h] * x[b, c, n] + b1[h])
//                    + b2[o]
//
// x is (B, C, N) bf16, channels-first with the spatial grid flattened into
// N; k1 (C, H), b1 (H), k2 (H, O), b2 (O) and out (B, O, N) are f32.  GELU is
// the exact erf form; dots, GELU and output run in f32.
//
// Replaces the TPU kernel uno_tpu/ops/pallas/mlp_head.py: _fwd_kernel
// (launched by _fwd_call).  Like it, the hidden activation never reaches
// device memory.  The TPU version computed erf from a polynomial because
// Pallas had no erf; this one calls erff.
//
// What bounds it on an H100: the bf16 read of x (B*C*N*2 bytes, 91 MB at the
// Darcy S=211 shapes) against ~2*C*H FLOPs per grid point (2.9 GFLOP there),
// i.e. ~32 FLOP per byte: memory-bound for a kernel that keeps the hidden
// layer on chip, where the unfused path would also write and re-read an f32
// (B, N, H) hidden tensor.  The design:
//   * one thread per (b, n), n fastest, so each load of x[b, c, n] and store
//     of out[b, o, n] is coalesced;
//   * the weights (C*H + H + H*O + O floats, 8.4 KB here) sit in shared
//     memory; every thread of a warp reads the same weight, a broadcast;
//   * HT hidden pre-activations live in registers: for each c, one x value
//     feeds HT multiply-adds; then each z goes through GELU and into at most
//     OMAX output accumulators.  H > HT takes several passes over x;
//   * the tail of N is masked by an early return after the weights load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int HT = 32;   // hidden units per pass, held in registers
constexpr int OMAX = 4;  // output channels the accumulators cover

__global__ void __launch_bounds__(THREADS)
mlp_head_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ k1, const float* __restrict__ b1,
                    const float* __restrict__ k2, const float* __restrict__ b2,
                    float* __restrict__ out, int C, int N, int H, int O) {
  extern __shared__ float smem[];
  float* sk1 = smem;         // [C, H]
  float* sb1 = sk1 + C * H;  // [H]
  float* sk2 = sb1 + H;      // [H, O]
  float* sb2 = sk2 + H * O;  // [O]
  for (int t = threadIdx.x; t < C * H; t += THREADS) sk1[t] = k1[t];
  for (int t = threadIdx.x; t < H; t += THREADS) sb1[t] = b1[t];
  for (int t = threadIdx.x; t < H * O; t += THREADS) sk2[t] = k2[t];
  for (int t = threadIdx.x; t < O; t += THREADS) sb2[t] = b2[t];
  __syncthreads();

  const int b = blockIdx.y;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const __nv_bfloat16* xp = x + (size_t)b * C * N + n;

  float acc[OMAX];
#pragma unroll
  for (int o = 0; o < OMAX; ++o) acc[o] = 0.f;

  for (int h0 = 0; h0 < H; h0 += HT) {
    float z[HT];
#pragma unroll
    for (int t = 0; t < HT; ++t) z[t] = (h0 + t < H) ? sb1[h0 + t] : 0.f;
    for (int c = 0; c < C; ++c) {
      const float xc = __bfloat162float(xp[(size_t)c * N]);
      const float* kr = sk1 + c * H + h0;
#pragma unroll
      for (int t = 0; t < HT; ++t) {
        if (h0 + t < H) z[t] = fmaf(kr[t], xc, z[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < HT; ++t) {
      if (h0 + t < H) {
        const float a = 0.5f * z[t] * (1.f + erff(z[t] * 0.70710678118654752f));
        const float* k2r = sk2 + (h0 + t) * O;
#pragma unroll
        for (int o = 0; o < OMAX; ++o) {
          if (o < O) acc[o] = fmaf(a, k2r[o], acc[o]);
        }
      }
    }
  }

  float* op = out + (size_t)b * O * N + n;
#pragma unroll
  for (int o = 0; o < OMAX; ++o) {
    if (o < O) op[(size_t)o * N] = acc[o] + sb2[o];
  }
}

}  // namespace

extern "C" int uno_mlp_head_fwd(const void* x, const void* k1, const void* b1,
                                const void* k2, const void* b2, void* out,
                                int B, int C, int N, int H, int O,
                                void* stream) {
  const size_t smem = sizeof(float) * ((size_t)C * H + H + (size_t)H * O + O);
  const dim3 grid((N + THREADS - 1) / THREADS, B);
  mlp_head_fwd_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<float*>(out), C, N, H, O);
  return static_cast<int>(cudaGetLastError());
}
