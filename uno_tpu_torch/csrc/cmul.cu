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
// transposed and dw with x transposed.  Here the forward and dx are one
// kernel (contract_kernel) that reads w in place with either channel axis
// contracted, and dw has its own.
//
// Gradient convention: the backward kernels return what torch autograd
// expects for a real loss, the conjugate-Wirtinger gradient, so they
// conjugate w (dx) and x (dw).  uno_tpu's backward returns the plain
// transposes (JAX's convention) and its Adam conjugates later; the port's
// Adam does not.
//
// Forward and dx: contract_kernel.  Both are, per mode m,
//     out[b, n, m] = sum_k a[b, k, m] * op(w)[k, n, m]
// with (a, K, N) = (x, Ci, Co) and w's k and n strides (Co*M, M) for the
// forward, (g, Co, Ci) and (M, Co*M) with w conjugated for dx.
//
// What bounds them on an H100: bytes.  Each call reads a (B*K*M) and w
// (K*N*M, each element used by B multiply-adds) once and writes out once:
// 11.5-34.5 MB at the Darcy S=211 shapes, 97 MB summed over the five, 29 us
// at 3.35 TB/s.  The arithmetic, 8*B*K*N*M flops (1.05 GFLOP over the five),
// takes 16 us at the card's 67 TFLOP/s of f32 outside the tensor cores:
// about 11 flops per byte, under the f32 ridge but not far, so the FMAs have
// to overlap the loads.  A first design (one thread per output, a serial
// loop over K that waited on each load, too few warps, w read once per half
// of the batch) took 15-18x the bound and lost to the einsum.  This one:
//   * all B <= 16 rows in registers: a block owns TN = 16 outputs n by
//     TM2 = 4 modes for every batch row, so each w element is read from
//     device memory once.  A lane owns 4 rows by 4 outputs by two modes
//     (64 f32 accumulators); per channel it reads 4 a and 4 w float4 from
//     shared memory for 128 FMAs.  A larger batch loops over tiles of 16
//     rows inside the block, with the block's w tile kept in shared memory
//     when it fits (`resident`);
//   * the K reduction split over the `split` warps of a block, each warp on
//     its own contiguous slice of K (kpw channels).  At the end the warps'
//     partial sums go through shared memory and are added in warp order: no
//     atomics, the same bits on every run.  The launch plan (ops/kernels/
//     cmul.py: contract_plan) picks the split for about 8 warps per SM;
//     more warps made the partial sums and the opening burst of loads cost
//     more than they hid;
//   * each warp streams its slice one channel at a time through a ring of
//     STAGES shared-memory stages (the a slab and the w tile) with cp.async,
//     STAGES - 1 channels in flight while it computes on one; no block-wide
//     barrier in the loop.  16-byte copies where M and the pointers allow,
//     8-byte ones otherwise; rows, channels and modes past the edges are
//     zero-filled.
// Measured on an H100 80GB HBM3 (700 W), the L2 flushed before each launch,
// summed over the five shapes: forward 0.080 ms and dx 0.084 ms against
// 0.22 ms for the einsums, 2.2-3.2x faster at every shape; 2.8x the bound,
// of which a timed one-element add (the floor of that timing) is 0.028 ms.
// Accumulation is in f32 with the plain 4-multiply complex product.
//
// dw: one thread per (o, m) and IT input channels, a loop over the short
// batch axis; each thread writes its IT outputs once.  No atomics.

#include <cuda_runtime.h>

#include <atomic>

namespace {

// ---- the contraction (forward and dx) -------------------------------------
constexpr int CB = 16;     // batch rows per tile, all in the block's registers
constexpr int TN = 16;     // outputs n per block
constexpr int TM2 = 4;     // modes per block (two lanes along m, two modes each)
constexpr int STAGES = 4;  // ring of one-channel stages: STAGES - 1 in flight
constexpr int MAX_SPLIT = 8;
constexpr int LANES = 32;
constexpr int SLAB = CB * TM2;  // float2 of a per channel: [b][mode]
constexpr int WT = TN * TM2;    // float2 of w per channel: [n][mode]
// A lane owns 4 batch rows (bg + 4i) by 4 outputs (ng + 4j) by two modes:
// lane = (bg * 4 + ng) * 2 + p.  Per channel it loads 4 a and 4 w float4
// from shared memory (each a broadcast) for 128 FMAs.
constexpr int LB = 4, LN = 4;

// Shared memory, per warp: the a ring, then either the w ring or (resident)
// the warp's whole w slice; the warps' partial sums reuse the front.  The
// launch plan computes the same bytes (contract_smem in cmul.py).
constexpr int X_RING = STAGES * SLAB * 8;
constexpr int W_STAGE = WT * 8;
constexpr int RED = CB * TN * TM2 * 8;  // one warp's partial sums
__host__ __device__ inline int w_offset(int split, int resident) {
  return split * (resident && RED > X_RING ? RED : X_RING);
}
__host__ __device__ inline int contract_smem(int split, int kpw, int resident) {
  const int end = w_offset(split, resident) + split * (resident ? kpw : STAGES) * W_STAGE;
  return end > split * RED ? end : split * RED;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies BYTES from global to shared memory, or zeros when !ok (no read).
// The L2 fetches the whole 128-byte line: the blocks beside this one along
// m read the rest of it.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(n) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc += x * w, or x * conj(w), for two modes (x, y | z, w components)
template <bool CONJ>
__device__ __forceinline__ void cmac2(float4& acc, const float4 x, const float4 w) {
  if constexpr (CONJ) {  // (xr + i xi)(wr - i wi)
    acc.x = fmaf(x.x, w.x, fmaf(x.y, w.y, acc.x));
    acc.y = fmaf(x.y, w.x, fmaf(-x.x, w.y, acc.y));
    acc.z = fmaf(x.z, w.z, fmaf(x.w, w.w, acc.z));
    acc.w = fmaf(x.w, w.z, fmaf(-x.z, w.w, acc.w));
  } else {               // (xr + i xi)(wr + i wi)
    acc.x = fmaf(x.x, w.x, fmaf(-x.y, w.y, acc.x));
    acc.y = fmaf(x.x, w.y, fmaf(x.y, w.x, acc.y));
    acc.z = fmaf(x.z, w.z, fmaf(-x.w, w.w, acc.z));
    acc.w = fmaf(x.z, w.w, fmaf(x.w, w.z, acc.w));
  }
}

// out[b, n, m] = sum_k a[b, k, m] * op(w[k * wsk + n * wsn + m]), op = conj
// if CONJ.  Grid (ceil(M / TM2), ceil(N / TN)), 32 * split threads; warp kg
// contracts k in [kg * kpw, kg * kpw + kpw).
// VEC: bytes per copy, 16 (M even, pointers 16-byte aligned) or 8.
template <bool CONJ, int VEC>
__global__ void __launch_bounds__(LANES * MAX_SPLIT, 2)
contract_kernel(const float2* __restrict__ a, const float2* __restrict__ w,
                float2* __restrict__ out, int B, int K, int N, int M,
                long long wsk, long long wsn, int kpw, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % LANES;
  const int kg = threadIdx.x / LANES;
  const int split = blockDim.x / LANES;
  const int m0 = blockIdx.x * TM2;
  const int n0 = blockIdx.y * TN;
  const int kbeg = kg * kpw;

  float2* xs = reinterpret_cast<float2*>(smem + kg * X_RING);
  float2* ws = reinterpret_cast<float2*>(smem + w_offset(split, resident) +
                                         kg * (resident ? kpw : STAGES) * W_STAGE);
  float4* red = reinterpret_cast<float4*>(smem);
  const int p = lane % 2, ng = lane / 2 % 4, bg = lane / 8;

  for (int b0 = 0; b0 < B; b0 += CB) {
    const bool load_w = !resident || b0 == 0;

    // Stage channel kbeg + c: the a slab and the w tile, [row][mode] each,
    // the q-th copy by lane q % 32.
    auto load = [&](int c) {
      const int k = kbeg + c;
      const bool kin = k < K;
      constexpr int PER = VEC / 8;    // modes per copy
      constexpr int ROW = TM2 / PER;  // copies per row
      float2* xd = xs + (c % STAGES) * SLAB;
#pragma unroll
      for (int j = 0; j < SLAB / PER / LANES; ++j) {
        const int q = lane + j * LANES;
        const int b = b0 + q / ROW, m = m0 + (q % ROW) * PER;
        const bool ok = kin && b < B && m < M;
        cp_async<VEC>(xd + q * PER, ok ? a + ((size_t)b * K + k) * M + m : a, ok);
      }
      if (load_w) {
        float2* wd = ws + (resident ? c : c % STAGES) * WT;
#pragma unroll
        for (int j = 0; j < WT / PER / LANES; ++j) {
          const int q = lane + j * LANES;
          const int n = n0 + q / ROW, m = m0 + (q % ROW) * PER;
          const bool ok = kin && n < N && m < M;
          cp_async<VEC>(wd + q * PER, ok ? w + k * wsk + n * wsn + m : w, ok);
        }
      }
    };

    float4 acc[LB][LN];
#pragma unroll
    for (int i = 0; i < LB; ++i)
#pragma unroll
      for (int j = 0; j < LN; ++j) acc[i][j] = make_float4(0.f, 0.f, 0.f, 0.f);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < kpw) load(s);
      cp_async_commit();
    }
    for (int c = 0; c < kpw; ++c) {
      if (c + STAGES - 1 < kpw) load(c + STAGES - 1);
      cp_async_commit();
      cp_async_wait<STAGES - 1>();  // channel c has landed (this lane's copies)
      __syncwarp();                 // ... and every lane's
      const float4* xc = reinterpret_cast<const float4*>(xs + (c % STAGES) * SLAB);
      const float4* wc = reinterpret_cast<const float4*>(ws + (resident ? c : c % STAGES) * WT);
      float4 wv[LN];
#pragma unroll
      for (int j = 0; j < LN; ++j) wv[j] = wc[(ng + 4 * j) * 2 + p];
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const float4 xv = xc[(bg + 4 * i) * 2 + p];
#pragma unroll
        for (int j = 0; j < LN; ++j) cmac2<CONJ>(acc[i][j], xv, wv[j]);
      }
      __syncwarp();  // every lane is done with the slot before it is refilled
    }

    // The warps' partial sums, added in warp order.  Every copy has landed
    // (the groups still pending are empty), so the rings can be reused.
    __syncthreads();
#pragma unroll
    for (int i = 0; i < LB; ++i)
#pragma unroll
      for (int j = 0; j < LN; ++j) red[(kg * LB * LN + i * LN + j) * LANES + lane] = acc[i][j];
    __syncthreads();
    // e = (b * TN + n) * 2 + mode pair: consecutive threads, consecutive modes
    for (int e = threadIdx.x; e < CB * TN * 2; e += blockDim.x) {
      const int ep = e % 2, en = e / 2 % TN, eb = e / (2 * TN);
      const int slot = (eb / 4) * LN + en / 4;
      const int l = ((eb % 4) * 4 + en % 4) * 2 + ep;
      float4 s = red[slot * LANES + l];
      for (int g = 1; g < split; ++g) {
        const float4 v = red[(g * LB * LN + slot) * LANES + l];
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const int b = b0 + eb, n = n0 + en, m = m0 + 2 * ep;
      if (b < B && n < N) {
        float2* o = out + ((size_t)b * N + n) * M + m;
        if (VEC == 16) {  // M even: both modes in or both out
          if (m < M) *reinterpret_cast<float4*>(o) = s;
        } else {
          if (m < M) o[0] = make_float2(s.x, s.y);
          if (m + 1 < M) o[1] = make_float2(s.z, s.w);
        }
      }
    }
    __syncthreads();  // red is the next batch tile's ring
  }
}

// Opts contract_kernel<CONJ, VEC> in to all the shared memory a block may
// have on the current device, once per device (a bit each for devices 0-63;
// others ask every launch): no attribute call per launch, and no plan asks
// for more (contract_plan sizes it to the same limit).
template <bool CONJ, int VEC>
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(contract_kernel<CONJ, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The plan arguments (split .. grid_y) come from contract_plan in
// ops/kernels/cmul.py; a plan this file does not expect returns
// cudaErrorInvalidValue without launching.
template <bool CONJ>
int contract(const void* a, const void* w, void* out, int B, int K, int N, int M,
             long long wsk, long long wsn, int split, int kpw, int resident, int vec,
             int smem, int grid_x, int grid_y, void* stream) {
  if (split < 1 || split > MAX_SPLIT || kpw < 1 || (long long)split * kpw < K ||
      (vec != 8 && vec != 16) || grid_x != (M + TM2 - 1) / TM2 || grid_y != (N + TN - 1) / TN ||
      smem != contract_smem(split, kpw, resident))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec == 16 ? &contract_kernel<CONJ, 16> : &contract_kernel<CONJ, 8>;
  const cudaError_t err = vec == 16 ? opt_in_smem<CONJ, 16>() : opt_in_smem<CONJ, 8>();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y), LANES * split, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(w), static_cast<float2*>(out),
      B, K, N, M, wsk, wsn, kpw, resident);
  return static_cast<int>(cudaGetLastError());
}

// ---- dw --------------------------------------------------------------------
constexpr int TM = 32;  // modes per block (one warp along m)
constexpr int TO = 4;   // channels per block along gw's o (warps per block)
constexpr int IT = 4;   // input channels accumulated per thread

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

extern "C" int uno_cmul_fwd(const void* x, const void* w, void* y, int B, int Ci, int Co,
                            int M, int split, int kpw, int resident, int vec, int smem,
                            int grid_x, int grid_y, void* stream) {
  return contract<false>(x, w, y, B, Ci, Co, M, (long long)Co * M, M, split, kpw, resident,
                         vec, smem, grid_x, grid_y, stream);
}

extern "C" int uno_cmul_bwd_x(const void* g, const void* w, void* gx, int B, int Ci,
                              int Co, int M, int split, int kpw, int resident, int vec,
                              int smem, int grid_x, int grid_y, void* stream) {
  return contract<true>(g, w, gx, B, Co, Ci, M, M, (long long)Co * M, split, kpw, resident,
                        vec, smem, grid_x, grid_y, stream);
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
