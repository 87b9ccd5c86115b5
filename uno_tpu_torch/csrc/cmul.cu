// Truncated-mode complex contraction of the FFT-path spectral conv, and its
// two backward contractions:
//
//     forward  y[b, o, m]  = sum_i x[b, i, m] * w[i, o, m]
//     dx       gx[b, i, m] = sum_o g[b, o, m] * conj(w[i, o, m])
//     dw       gw[i, o, m] = sum_b conj(x[b, i, m]) * g[b, o, m]
//
// All complex64: (B, Ci, M) x, (Ci, Co, M) w, (B, Co, M) y and g, stored as
// interleaved complex (float2: re, im), contiguous, M fastest.  One
// independent complex matrix product per Fourier mode m.
//
// Replaces the TPU kernel uno_tpu/ops/pallas/cmul.py: _contract_kernel
// (launched by lane_contract), which put the mode axis in the TPU's 128
// lanes and contracted channels with broadcast multiply-adds.  uno_tpu runs
// that one kernel three times (cmul.py:139, :158, :162): forward, dx with w
// transposed and dw with x transposed.  Here too the three uses run one
// kernel, contract_kernel, which reads both operands in place through their
// strides.  Each use is, per mode m,
//     out[r, n, m] = sum_k op(a)[r, k, m] * op(w)[k, n, m]
// with
//     forward  (a, R, K, N) = (x, B, Ci, Co), a strides (Ci*M, M), w strides (Co*M, M)
//     dx       (g, B, Co, Ci), a strides (Co*M, M), w strides (M, Co*M), w conjugated
//     dw       (x, Ci, B, Co), a strides (M, Ci*M), w = g, strides (Co*M, M), a conjugated
//
// Gradient convention: the backward uses return what torch autograd
// expects for a real loss, the conjugate-Wirtinger gradient, so they
// conjugate w (dx) and x (dw).  uno_tpu's backward returns the plain
// transposes (JAX's convention) and its Adam conjugates later; the port's
// Adam does not.
//
// What bounds every use on an H100: bytes.  Each call reads a and w once and
// writes out once: 11.5-34.5 MB at the Darcy S=211 shapes, 97 MB summed
// over the five, 29 us at 3.35 TB/s.  The arithmetic, 8*R*K*N*M flops (1.05
// GFLOP over the five), takes 16 us at the card's 67 TFLOP/s of f32 outside
// the tensor cores: about 11 flops per byte, under the f32 ridge but not
// far, so the FMAs have to overlap the loads.  The design:
//   * a block owns CB = 16 rows by TN = 16 outputs n by TM2 = 4 modes; a
//     lane owns 4 rows by 4 outputs by two modes (64 f32 accumulators); per
//     channel it reads 4 a and 4 w float4 from shared memory for 128 FMAs.
//     The grid's z axis walks the row tiles, so with R <= 16 (the forward
//     and dx at batch 16) each w element is read from device memory once,
//     and dw (R = Ci = 32-128 rows) runs one block per row tile, reading g
//     once per row tile (from L2) instead of serially;
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
// Forward and dx, measured on an H100 80GB HBM3 (700 W), the L2 flushed
// before each launch, summed over the five shapes: 0.080 and 0.084 ms
// against 0.22 ms for the einsums, 2.2-3.2x faster at every shape; 2.8x the
// bound, of which a timed one-element add (the floor of that timing) is
// 0.028 ms.  A first design of each (one thread per output, a serial loop
// over K that waited on each load, too few warps) took 15-18x the bound.
//
// dw: the batch of 16 is its contracted axis.  Its first design (one thread
// per (o, m) and 4 input channels, a serial loop over the batch with 8-byte
// loads, nothing staged) re-read each x element once per 4 outputs and each
// g element once per 4 inputs, about 520 MB of L2 reads over the five
// shapes to write 65 MB; it took 0.156 ms, 5.4x the bound and 1.06x its
// einsum.  Through contract_kernel it reads x Co/16 and g Ci/16 times from
// L2 (about 150 MB), each from device memory once: 0.094 ms summed over the
// five shapes (H100 80GB HBM3, 700 W, L2 flushed), 3.2x the bound, against
// 0.149 ms for its einsum, 1.4-2.0x faster at every shape.
// Accumulation is in f32 with the plain 4-multiply complex product.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int CB = 16;     // rows per block (the batch for the forward and dx)
constexpr int TN = 16;     // outputs n per block
constexpr int TM2 = 4;     // modes per block (two lanes along m, two modes each)
constexpr int STAGES = 4;  // ring of one-channel stages: STAGES - 1 in flight
constexpr int MAX_SPLIT = 8;
constexpr int LANES = 32;
constexpr int SLAB = CB * TM2;  // float2 of a per channel: [row][mode]
constexpr int WT = TN * TM2;    // float2 of w per channel: [n][mode]
// A lane owns 4 rows (bg + 4i) by 4 outputs (ng + 4j) by two modes:
// lane = (bg * 4 + ng) * 2 + p.  Per channel it loads 4 a and 4 w float4
// from shared memory (each a broadcast) for 128 FMAs.
constexpr int LB = 4, LN = 4;

// Shared memory, per warp: the a ring and the w ring; the warps' partial
// sums reuse all of it.  The launch plan computes the same bytes
// (contract_smem in cmul.py).
constexpr int RINGS = STAGES * (SLAB + WT) * 8;  // one warp's a and w rings
constexpr int RED = CB * TN * TM2 * 8;           // one warp's partial sums
__host__ __device__ constexpr int contract_smem(int split) {
  return split * (RINGS > RED ? RINGS : RED);
}

// Which operand a use conjugates.
enum Conj { CONJ_NONE = 0, CONJ_W = 1, CONJ_A = 2 };

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

// acc += op(a) * op(w) for two modes (x, y | z, w components)
template <int CJ>
__device__ __forceinline__ void cmac2(float4& acc, const float4 a, const float4 w) {
  if constexpr (CJ == CONJ_W) {  // (ar + i ai)(wr - i wi)
    acc.x = fmaf(a.x, w.x, fmaf(a.y, w.y, acc.x));
    acc.y = fmaf(a.y, w.x, fmaf(-a.x, w.y, acc.y));
    acc.z = fmaf(a.z, w.z, fmaf(a.w, w.w, acc.z));
    acc.w = fmaf(a.w, w.z, fmaf(-a.z, w.w, acc.w));
  } else if constexpr (CJ == CONJ_A) {  // (ar - i ai)(wr + i wi)
    acc.x = fmaf(a.x, w.x, fmaf(a.y, w.y, acc.x));
    acc.y = fmaf(a.x, w.y, fmaf(-a.y, w.x, acc.y));
    acc.z = fmaf(a.z, w.z, fmaf(a.w, w.w, acc.z));
    acc.w = fmaf(a.z, w.w, fmaf(-a.w, w.z, acc.w));
  } else {  // (ar + i ai)(wr + i wi)
    acc.x = fmaf(a.x, w.x, fmaf(-a.y, w.y, acc.x));
    acc.y = fmaf(a.x, w.y, fmaf(a.y, w.x, acc.y));
    acc.z = fmaf(a.z, w.z, fmaf(-a.w, w.w, acc.z));
    acc.w = fmaf(a.z, w.w, fmaf(a.w, w.z, acc.w));
  }
}

// out[r, n, m] = sum_k op(a[r * asr + k * ask + m]) * op(w[k * wsk + n * wsn + m]).
// Grid (ceil(M / TM2), ceil(N / TN), ceil(R / CB)), 32 * split threads; warp
// kg contracts k in [kg * kpw, kg * kpw + kpw).
// VEC: bytes per copy, 16 (M even, pointers 16-byte aligned) or 8.
template <int CJ, int VEC>
__global__ void __launch_bounds__(LANES * MAX_SPLIT, 2)
contract_kernel(const float2* __restrict__ a, const float2* __restrict__ w,
                float2* __restrict__ out, int R, int K, int N, int M, long long asr,
                long long ask, long long wsk, long long wsn, int kpw) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x % LANES;
  const int kg = threadIdx.x / LANES;
  const int split = blockDim.x / LANES;
  const int m0 = blockIdx.x * TM2;
  const int n0 = blockIdx.y * TN;
  const int r0 = blockIdx.z * CB;
  const int kbeg = kg * kpw;

  float2* xs = reinterpret_cast<float2*>(smem + kg * RINGS);
  float2* ws = xs + STAGES * SLAB;
  float4* red = reinterpret_cast<float4*>(smem);
  const int p = lane % 2, ng = lane / 2 % 4, bg = lane / 8;

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
      const int r = r0 + q / ROW, m = m0 + (q % ROW) * PER;
      const bool ok = kin && r < R && m < M;
      cp_async<VEC>(xd + q * PER, ok ? a + r * asr + k * ask + m : a, ok);
    }
    float2* wd = ws + (c % STAGES) * WT;
#pragma unroll
    for (int j = 0; j < WT / PER / LANES; ++j) {
      const int q = lane + j * LANES;
      const int n = n0 + q / ROW, m = m0 + (q % ROW) * PER;
      const bool ok = kin && n < N && m < M;
      cp_async<VEC>(wd + q * PER, ok ? w + k * wsk + n * wsn + m : w, ok);
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
    const float4* wc = reinterpret_cast<const float4*>(ws + (c % STAGES) * WT);
    float4 wv[LN];
#pragma unroll
    for (int j = 0; j < LN; ++j) wv[j] = wc[(ng + 4 * j) * 2 + p];
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const float4 xv = xc[(bg + 4 * i) * 2 + p];
#pragma unroll
      for (int j = 0; j < LN; ++j) cmac2<CJ>(acc[i][j], xv, wv[j]);
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
  // e = (row * TN + n) * 2 + mode pair: consecutive threads, consecutive modes
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
    const int r = r0 + eb, n = n0 + en, m = m0 + 2 * ep;
    if (r < R && n < N) {
      float2* o = out + ((size_t)r * N + n) * M + m;
      if (VEC == 16) {  // M even: both modes in or both out
        if (m < M) *reinterpret_cast<float4*>(o) = s;
      } else {
        if (m < M) o[0] = make_float2(s.x, s.y);
        if (m + 1 < M) o[1] = make_float2(s.z, s.w);
      }
    }
  }
}

// Opts contract_kernel<CJ, VEC> in to all the shared memory a block may
// have on the current device, once per device (a bit each for devices 0-63;
// others ask every launch): no attribute call per launch.
template <int CJ, int VEC>
cudaError_t opt_in_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(contract_kernel<CJ, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

// The plan arguments (split .. grid_z) come from contract_plan in
// ops/kernels/cmul.py; a plan this file does not expect returns
// cudaErrorInvalidValue without launching.
template <int CJ>
int contract(const void* a, const void* w, void* out, int R, int K, int N, int M,
             long long asr, long long ask, long long wsk, long long wsn, int split, int kpw,
             int vec, int smem, int grid_x, int grid_y, int grid_z, void* stream) {
  if (split < 1 || split > MAX_SPLIT || kpw < 1 || (long long)split * kpw < K ||
      (split - 1) * kpw >= K || (vec != 8 && vec != 16) || grid_x != (M + TM2 - 1) / TM2 ||
      grid_y != (N + TN - 1) / TN || grid_z != (R + CB - 1) / CB || smem != contract_smem(split))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec == 16 ? &contract_kernel<CJ, 16> : &contract_kernel<CJ, 8>;
  const cudaError_t err = vec == 16 ? opt_in_smem<CJ, 16>() : opt_in_smem<CJ, 8>();
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(grid_x, grid_y, grid_z), LANES * split, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(a), static_cast<const float2*>(w), static_cast<float2*>(out),
      R, K, N, M, asr, ask, wsk, wsn, kpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point takes B, Ci, Co, M, then the plan's split, kpw, vec,
// smem, grid_x, grid_y, grid_z (cmul.py: ContractPlan.args).
extern "C" int uno_cmul_fwd(const void* x, const void* w, void* y, int B, int Ci, int Co,
                            int M, int split, int kpw, int vec, int smem, int grid_x,
                            int grid_y, int grid_z, void* stream) {
  return contract<CONJ_NONE>(x, w, y, B, Ci, Co, M, (long long)Ci * M, M, (long long)Co * M, M,
                             split, kpw, vec, smem, grid_x, grid_y, grid_z, stream);
}

extern "C" int uno_cmul_bwd_x(const void* g, const void* w, void* gx, int B, int Ci,
                              int Co, int M, int split, int kpw, int vec, int smem,
                              int grid_x, int grid_y, int grid_z, void* stream) {
  return contract<CONJ_W>(g, w, gx, B, Co, Ci, M, (long long)Co * M, M, M, (long long)Co * M,
                          split, kpw, vec, smem, grid_x, grid_y, grid_z, stream);
}

extern "C" int uno_cmul_bwd_w(const void* x, const void* g, void* gw, int B, int Ci,
                              int Co, int M, int split, int kpw, int vec, int smem,
                              int grid_x, int grid_y, int grid_z, void* stream) {
  return contract<CONJ_A>(x, g, gw, Ci, B, Co, M, M, (long long)Ci * M, (long long)Co * M, M,
                          split, kpw, vec, smem, grid_x, grid_y, grid_z, stream);
}
