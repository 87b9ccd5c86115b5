// One remap of a complex64 spectrum (ops/kernels/remap.py): every element
// of a fresh (BC, D1, D2, D3) destination, zeros included, from a (BC, S1,
// S2, S3) source through separable per-axis index maps:
//
//     T(i, j, k) = sum_q sum_p src[rows[i][p], cols[j][q], bins[k]]
//     dst[i, j, k] = scale[k] * (herm[k] ? (T(i, j, k) + conj(T(-i, -j, k))) / 2
//                                        : T(i, j, k))
//
// with up to two source indices a destination index on the first two axes
// (-1: none; the sum is over those present, and nothing present gives 0),
// one on the last (-1: the bin is 0), a real scale a bin of the last axis,
// and -i, -j taken modulo D1, D2.  The 3-D FFT path of ops/spectral.py
// lays each spectrum out once in each direction with it: the kept corner
// modes gathered out of an rfftn's half spectrum, the contraction's modes
// scattered into the half spectrum an irfftn inverts (where quadrants
// overlap, two sources summed or the later one kept), the truncation's mask
// and trim-or-pad, and in the backward their transposes with the adjoint
// weights of the r2c and c2r on the interior bins.  The `herm` bins (the DC
// plane and, for an even length, the Nyquist plane of a half spectrum that
// a c2r will invert) take their Hermitian part along the first two axes, so
// that any c2r plan answers as pocketfft does.
//
// Replaces no TPU kernel: uno_tpu slices and pads with jnp ops that XLA
// fuses.  In the port autograd laid the same spectra out with zero fills,
// slice copies and full-size adds, about 19 GB a uno3d_t40 training step
// at batch 16; this kernel writes each destination element once and reads
// only the sources it needs.
//
// What bounds it on an H100: bytes, 8 a destination element written and
// 8 a source element read; no arithmetic comes near that.  The design:
//   * a thread owns one (i, j, k) of the destination grid and walks the
//     channels bc = y, y + gridDim.y, ...: its index math and table reads
//     are paid once for all of them, and its loads of successive channels
//     are independent, so several stay in flight; the wrapper sizes
//     gridDim.y so that a launch still fills the card (remap.py: slices);
//   * neighbouring threads take neighbouring k (then j, then i), so the
//     writes, and the reads of a map that is an identity or a shift,
//     coalesce, and no block idles on a ragged row;
//   * no atomics: every destination element is one thread's, so a run
//     gives the same bits as any other.
// Rounding follows the plain version (remap_plain), op for op: the sum over
// p, then over q, then the Hermitian half, then the scale, each an IEEE f32
// operation (explicit intrinsics: nvcc contracts nothing).

#include <cuda_runtime.h>

namespace {

constexpr int GRID_MAX = 65535;  // CUDA's limit on the grid's y

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

// T at one destination (row sources r, column sources c) of one channel's
// source plane, already offset to the bin.
__device__ __forceinline__ float2 gather(const float2* __restrict__ p, int2 r, int2 c, int S2,
                                         int S3) {
  float2 t = make_float2(0.f, 0.f);
  const int cs[2] = {c.x, c.y};
  const int rs[2] = {r.x, r.y};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (cs[q] < 0) continue;
    float2 a = make_float2(0.f, 0.f);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (rs[u] < 0) continue;
      a = cadd(a, __ldg(p + ((long long)rs[u] * S2 + cs[q]) * S3));
    }
    t = cadd(t, a);
  }
  return t;
}

__global__ void remap_kernel(const float2* __restrict__ src, float2* __restrict__ dst,
                             const int* __restrict__ tab, const float* __restrict__ scale,
                             int BC, int S1, int S2, int S3, int D1, int D2, int D3) {
  const int* rows = tab;            // D1 x 2
  const int* cols = rows + 2 * D1;  // D2 x 2
  const int* bins = cols + 2 * D2;  // D3
  const int* herm = bins + D3;      // D3
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long plane = (long long)D1 * D2 * D3;
  if (t >= plane) return;
  const int i = (int)(t / ((long long)D2 * D3));
  const int jk = (int)(t - (long long)i * D2 * D3);
  const int j = jk / D3, k = jk - j * D3;
  const int b = bins[k];
  const int2 r = make_int2(rows[2 * i], rows[2 * i + 1]);
  const int2 c = make_int2(cols[2 * j], cols[2 * j + 1]);
  const bool h = herm[k] != 0;
  const int im = i ? D1 - i : 0, jm = j ? D2 - j : 0;
  const int2 rm = h ? make_int2(rows[2 * im], rows[2 * im + 1]) : r;
  const int2 cm = h ? make_int2(cols[2 * jm], cols[2 * jm + 1]) : c;
  const float s = scale[k];
  // one channel slice apart, in elements: the loop walks pointers, and a
  // bin with no source (b < 0) stores zeros in the same iterations as its
  // neighbours store sums, so a warp's stores stay together
  const long long in_step = (long long)gridDim.y * S1 * S2 * S3;
  const long long out_step = (long long)gridDim.y * plane;
  const float2* p = src + (long long)blockIdx.y * S1 * S2 * S3 + (b < 0 ? 0 : b);
  float2* q = dst + (long long)blockIdx.y * plane + t;
#pragma unroll 4
  for (int bc = blockIdx.y; bc < BC; bc += gridDim.y, p += in_step, q += out_step) {
    float2 v = make_float2(0.f, 0.f);
    if (b >= 0) {
      v = gather(p, r, c, S2, S3);
      if (h) {
        const float2 m = gather(p, rm, cm, S2, S3);
        v = make_float2(__fmul_rn(__fadd_rn(v.x, m.x), 0.5f),
                        __fmul_rn(__fsub_rn(v.y, m.y), 0.5f));
      }
      v = make_float2(__fmul_rn(v.x, s), __fmul_rn(v.y, s));
    }
    *q = v;
  }
}

}  // namespace

// src (BC, S1, S2, S3) and dst (BC, D1, D2, D3) complex64, contiguous; tab
// the int32 table (rows, cols, bins, herm) and scale the f32 one, on the
// card; `threads` a block (a multiple of 32, at most 1024) and `slices`
// blocks along y, each thread walking every slices-th channel.
extern "C" int uno_remap(const void* src, void* dst, const void* tab, const void* scale,
                         int BC, int S1, int S2, int S3, int D1, int D2, int D3, int threads,
                         int slices, void* stream) {
  const long long plane = (long long)D1 * D2 * D3;
  const long long blocks = (plane + threads - 1) / threads;
  if (BC < 1 || plane < 1 || threads < 32 || threads > 1024 || threads % 32 || slices < 1 ||
      slices > GRID_MAX || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((unsigned)blocks, (unsigned)slices);
  remap_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(src), static_cast<float2*>(dst), static_cast<const int*>(tab),
      static_cast<const float*>(scale), BC, S1, S2, S3, D1, D2, D3);
  return static_cast<int>(cudaGetLastError());
}
