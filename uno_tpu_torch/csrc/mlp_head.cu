// Fused projection head, forward and backward:
//
//     z[b, h, n]   = sum_c k1[c, h] * x[b, c, n] + b1[h]
//     out[b, o, n] = sum_h k2[h, o] * gelu(z[b, h, n]) + b2[o]
//
// x is (B, C, N) bf16, channels-first with the spatial grid flattened into
// N; k1 (C, H), b1 (H), k2 (H, O), b2 (O) and out (B, O, N) are f32.  GELU is
// the exact erf form; dots, GELU and output run in f32.
//
// Replaces the TPU kernels uno_tpu/ops/pallas/mlp_head.py: _fwd_kernel
// (launched by _fwd_call) and _bwd_kernel (launched by _bwd_call).  Like
// them, the hidden activation never reaches device memory: the backward
// recomputes z from x.  The TPU versions computed erf from a polynomial
// because Pallas had no erf; these call erff and expf.
//
// Forward.  What bounds it on an H100: by bytes, the bf16 read of x
// (B*C*N*2 bytes, 91 MB at the Darcy S=211 shapes, ~30 us at the card's
// bandwidth) against ~2*C*H FLOPs per grid point (2.9 GFLOP there), ~32 FLOP
// per byte.  Measured, it takes 0.30 ms (~0.3 TB/s): every multiply-add
// also issues a shared-memory load of its weight, and those instructions
// most likely bound it (not profiled per instruction).  It beats the
// unfused path, which also writes and re-reads an f32 (B, N, H) hidden
// tensor.  The design:
//   * one thread per (b, n), n fastest, so each load of x[b, c, n] and store
//     of out[b, o, n] is coalesced;
//   * the weights (C*H + H + H*O + O floats, 8.4 KB here) sit in shared
//     memory; every thread of a warp reads the same weight, a broadcast;
//   * HT hidden pre-activations live in registers: for each c, one x value
//     feeds HT multiply-adds; then each z goes through GELU and into at most
//     OMAX output accumulators.  H > HT takes several passes over x;
//   * the tail of N is masked by an early return after the weights load.
//
// Backward, given g = dL/dout (B, O, N) f32:
//     dz[h] = (sum_o k2[h, o] g[o]) * gelu'(z[h])
//     gx[c] = sum_h k1[c, h] dz[h]                       (rounded to bf16)
//     gk1[c, h] = sum x[c] dz[h],  gb1[h] = sum dz[h],
//     gk2[h, o] = sum gelu(z[h]) g[o],  gb2[o] = sum g[o]
// with the weight-gradient sums over all B*N grid points.  It reads x (91
// MB) and g and writes gx (91 MB), and does ~3x the forward's multiply-adds
// (z, gx, and the gk1 outer products); measured, 1.63 ms (~0.11 TB/s), so
// bytes do not bound it either.  The TPU kernel summed the weight gradients
// in VMEM across its sequential grid; Hopper runs blocks in parallel and in
// no order, so the backward is two passes:
//   * pass 1, a fixed grid of `blocks` blocks of `threads` threads, each
//     block walking tiles of `threads` grid points (tile = block, block +
//     blocks, ...).  A thread recomputes its point's z from x and the
//     shared-memory weights, writes gx, and stages x, dz, gelu(z) and g in
//     shared memory.  After a barrier, each thread owns a fixed set of
//     weight-gradient entries and adds the tile's points to them in order,
//     into the block's running sums in shared memory.  Points past B*N
//     contribute zeros (x = g = 0 gives dz = 0), and no thread leaves the
//     loop early, so every barrier is reached by the whole block.  At the
//     end each block writes its sums to one row of `partial`;
//   * pass 2, one thread per entry, sums the `blocks` rows in order.
// No atomics: the same inputs give the same bits.  Staging takes
// 4*threads*(C + 2H + O + 3) bytes of shared memory, the weights and the
// running sums 4*(2(CH + H + HO) + O) more: 84 KB at threads=128, C=64,
// H=32, O=1.  That is above the 48 KB a block gets without opting in, so the
// launcher raises the kernel's dynamic shared-memory limit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int HT = 32;   // hidden units per pass, held in registers
constexpr int OMAX = 4;  // output channels the accumulators cover
constexpr int BWD_MAX_THREADS = 256;

__device__ __forceinline__ float gelu_f(float z) {
  return 0.5f * z * (1.f + erff(z * 0.70710678118654752f));
}

// d/dz [z * Phi(z)] = Phi(z) + z * phi(z)
__device__ __forceinline__ float dgelu_f(float z) {
  const float cdf = 0.5f * (1.f + erff(z * 0.70710678118654752f));
  return fmaf(z, expf(-0.5f * z * z) * 0.39894228040143268f, cdf);
}

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
        const float a = gelu_f(z[t]);
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

// Pass 1 of the backward: gx, and one row of per-block weight-gradient sums
// in `partial` (gridDim.x rows of E = C*H + H + H*O + O floats, laid out as
// [gk1 | gb1 | gk2 | gb2]).
__global__ void __launch_bounds__(BWD_MAX_THREADS)
mlp_head_bwd_partial_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ k1,
                            const float* __restrict__ b1,
                            const float* __restrict__ k2,
                            __nv_bfloat16* __restrict__ gx,
                            float* __restrict__ partial,
                            int B, int C, int N, int H, int O) {
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int CH = C * H, HO = H * O;
  const int E = CH + H + HO + O;
  const int XS = C + 1, HS = H + 1;  // padded rows: no bank conflicts
  extern __shared__ float smem[];
  float* sk1 = smem;           // [C, H]
  float* sb1 = sk1 + CH;       // [H]
  float* sk2 = sb1 + H;        // [H, O]
  float* sx = sk2 + HO;        // [T, C+1]  the tile's x, f32
  float* sdz = sx + T * XS;    // [T, H+1]  dz
  float* sa = sdz + T * HS;    // [T, H+1]  gelu(z)
  float* sg = sa + T * HS;     // [T, O]    g
  float* sacc = sg + T * O;    // [E]       this block's running sums
  for (int t = tid; t < CH; t += T) sk1[t] = k1[t];
  for (int t = tid; t < H; t += T) sb1[t] = b1[t];
  for (int t = tid; t < HO; t += T) sk2[t] = k2[t];
  for (int e = tid; e < E; e += T) sacc[e] = 0.f;
  __syncthreads();

  const long long P = (long long)B * N;
  const long long n_tiles = (P + T - 1) / T;
  float* xs = sx + tid * XS;
  float* dzs = sdz + tid * HS;
  float* as = sa + tid * HS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long p = tile * T + tid;
    const bool valid = p < P;
    const int b = valid ? (int)(p / N) : 0;
    const int n = valid ? (int)(p % N) : 0;

    const __nv_bfloat16* xp = x + (size_t)b * C * N + n;
    for (int c = 0; c < C; ++c) {
      xs[c] = valid ? __bfloat162float(xp[(size_t)c * N]) : 0.f;
    }
    float gv[OMAX];
#pragma unroll
    for (int o = 0; o < OMAX; ++o) {
      gv[o] = (valid && o < O) ? g[((size_t)b * O + o) * N + n] : 0.f;
      if (o < O) sg[tid * O + o] = gv[o];
    }

    // recompute z, HT hidden units at a time; dz and gelu(z) to shared
    for (int h0 = 0; h0 < H; h0 += HT) {
      float z[HT];
#pragma unroll
      for (int t = 0; t < HT; ++t) z[t] = (h0 + t < H) ? sb1[h0 + t] : 0.f;
      for (int c = 0; c < C; ++c) {
        const float xc = xs[c];
        const float* kr = sk1 + c * H + h0;
#pragma unroll
        for (int t = 0; t < HT; ++t) {
          if (h0 + t < H) z[t] = fmaf(kr[t], xc, z[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < HT; ++t) {
        if (h0 + t < H) {
          const float* k2r = sk2 + (h0 + t) * O;
          float dzp = 0.f;
#pragma unroll
          for (int o = 0; o < OMAX; ++o) {
            if (o < O) dzp = fmaf(k2r[o], gv[o], dzp);
          }
          dzs[h0 + t] = dzp * dgelu_f(z[t]);
          as[h0 + t] = gelu_f(z[t]);
        }
      }
    }

    // input gradient, rounded to x's dtype
    if (valid) {
      __nv_bfloat16* gp = gx + (size_t)b * C * N + n;
      for (int c = 0; c < C; ++c) {
        const float* kr = sk1 + c * H;
        float s = 0.f;
        for (int h = 0; h < H; ++h) s = fmaf(kr[h], dzs[h], s);
        gp[(size_t)c * N] = __float2bfloat16(s);
      }
    }
    __syncthreads();

    // weight gradients: thread tid owns entries tid, tid + T, ... and adds
    // the tile's points in order
    for (int e = tid; e < E; e += T) {
      float s = 0.f;
      if (e < CH) {
        const int c = e / H, h = e - (e / H) * H;
        for (int t = 0; t < T; ++t) s = fmaf(sx[t * XS + c], sdz[t * HS + h], s);
      } else if (e < CH + H) {
        const int h = e - CH;
        for (int t = 0; t < T; ++t) s += sdz[t * HS + h];
      } else if (e < CH + H + HO) {
        const int r = e - CH - H;
        const int h = r / O, o = r - (r / O) * O;
        for (int t = 0; t < T; ++t) s = fmaf(sa[t * HS + h], sg[t * O + o], s);
      } else {
        const int o = e - CH - H - HO;
        for (int t = 0; t < T; ++t) s += sg[t * O + o];
      }
      sacc[e] += s;
    }
    __syncthreads();
  }

  float* row = partial + (size_t)blockIdx.x * E;
  for (int e = tid; e < E; e += T) row[e] = sacc[e];
}

// Pass 2: sum the per-block rows in order, one thread per entry.
__global__ void mlp_head_bwd_reduce_kernel(const float* __restrict__ partial,
                                           int rows, int C, int H, int O,
                                           float* __restrict__ gk1,
                                           float* __restrict__ gb1,
                                           float* __restrict__ gk2,
                                           float* __restrict__ gb2) {
  const int CH = C * H, HO = H * O;
  const int E = CH + H + HO + O;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partial[(size_t)r * E + e];
  if (e < CH) gk1[e] = s;
  else if (e < CH + H) gb1[e - CH] = s;
  else if (e < CH + H + HO) gk2[e - CH - H] = s;
  else gb2[e - CH - H - HO] = s;
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

// partial: blocks x (C*H + H + H*O + O) f32 scratch, allocated by the caller.
extern "C" int uno_mlp_head_bwd(const void* x, const void* g, const void* k1,
                                const void* b1, const void* k2, void* gx,
                                void* gk1, void* gb1, void* gk2, void* gb2,
                                void* partial, int B, int C, int N, int H,
                                int O, int threads, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      sizeof(float) * (2 * ((size_t)C * H + H + (size_t)H * O) + O +
                       (size_t)threads * (C + 2 * H + O + 3));
  cudaError_t err = cudaFuncSetAttribute(
      mlp_head_bwd_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_head_bwd_partial_kernel<<<blocks, threads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<__nv_bfloat16*>(gx),
      static_cast<float*>(partial), B, C, N, H, O);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = C * H + H + H * O + O;
  constexpr int RT = 256;
  mlp_head_bwd_reduce_kernel<<<(E + RT - 1) / RT, RT, 0, st>>>(
      static_cast<const float*>(partial), blocks, C, H, O,
      static_cast<float*>(gk1), static_cast<float*>(gb1),
      static_cast<float*>(gk2), static_cast<float*>(gb2));
  return static_cast<int>(cudaGetLastError());
}
