// One step of ComplexAdam (uno_tpu_torch/optim.py) over a table of
// parameters in one launch:
//
//     g   = g + wd * p                       (non-decoupled L2, when wd != 0)
//     mu  = b1 * mu + (1 - b1) * g
//     nu  = b2 * nu + (1 - b2) * (re(g)^2 + im(g)^2)   (one real nu per element)
//     v   = amsgrad ? (max_nu = max(max_nu, nu)) : nu
//     p  += step_size * mu / (sqrt(v) / sqrt(bc2) + eps)
//
// for f32 and complex64 parameters (p, g and mu of the parameter's type;
// nu and max_nu f32), with each tensor's own step_size = -lr / bc1 and
// 1 / sqrt(bc2), computed on the host from that parameter's step count
// (ops/kernels/adam.py).  Gradients are torch's conjugate-Wirtinger ones,
// so nothing is conjugated.
//
// Replaces no TPU kernel: uno_tpu's complex_adam is an optax transform that
// XLA fuses.  In the port the same step was about twelve torch launches a
// parameter, 329 a step for uno9's 27 parameters, and the host spent
// 4.4-6.5 ms launching them while the card finished each in a few us; this
// kernel makes the step one launch.
//
// What bounds it on an H100: bytes.  Each element is read once (p, g, mu,
// nu, max_nu) and written once (p, mu, nu, max_nu): 48 bytes a complex
// element without amsgrad, 392 MB for uno9's 8.2 M, 0.117 ms at 3.35 TB/s.
// No arithmetic comes near that.  The design:
//   * the table (pointers, element count, complexness and the two f32
//     factors of each tensor) is the kernel's parameter, read in place
//     through __grid_constant__; MAX_TENSORS entries fit in 4 KB of
//     parameters, and the wrapper splits longer tables over launches;
//   * the tensors, laid end to end, are cut into chunks of CHUNK elements,
//     and each block walks the chunks grid-stride, so that uno9's five
//     spectral weights (8.18 M complex elements) spread over every SM and
//     the 22 small f32 tensors take one chunk each;
//   * a thread moves 16 bytes per load and store (two complex elements or
//     four reals of p, g and mu; nu as float2 or float4) and keeps UNROLL
//     vectors in flight; tensors whose pointers are not so aligned, and the
//     elements past the last whole vector, go element by element;
//   * no atomics and no reductions: every element is independent, so a run
//     gives the same bits as any other.
// Rounding follows the torch ops of the plain sequence on the card, op for
// op, with explicit intrinsics so that nvcc contracts nothing: a real
// add_(x, alpha=a) is one fused multiply-add; a complex one multiplies,
// then adds; mul_ and the square round once each; sqrt and the division of
// mu by the denominator are IEEE; div_ by a number multiplies by its
// reciprocal, taken in double and rounded to f32, as torch's CUDA kernel
// does; a complex mu divided by the real denominator is mu times the f32
// reciprocal of the denominator, as c10::complex divides by (d, 0).  On an
// H100 each of these matched torch 2.11's kernels in every element of a
// million-element probe.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_TENSORS = 40;  // ops/kernels/adam.py: MAX_TENSORS
constexpr int CHUNK = 4096;      // elements a chunk (ops/kernels/adam.py: CHUNK)
constexpr int THREADS = 256;     // threads a block
constexpr int UNROLL = 4;        // vectors a thread keeps in flight

// The step's hyperparameters as f32, as torch rounds the Python numbers.
struct Hyper {
  float b1, a1, b2, a2, eps, wd;  // a1 = 1 - b1, a2 = 1 - b2 (rounded from double)
  int amsgrad, has_wd;            // has_wd: weight_decay != 0 in double
};

// One tensor of the table (ops/kernels/adam.py: ENTRY, 64 bytes).
struct Entry {
  float* p;
  const float* g;
  float* mu;
  float* nu;
  float* max_nu;  // null without amsgrad
  long long n;    // elements (complex elements of a complex tensor)
  int is_complex;
  float step_size;     // -lr / bc1
  float inv_sqrt_bc2;  // 1 / sqrt(bc2)
  int pad;
};
static_assert(sizeof(Hyper) == 32, "Hyper must match adam.py's HYPER");
static_assert(sizeof(Entry) == 64, "Entry must match adam.py's ENTRY");

struct Args {
  Hyper h;
  Entry t[MAX_TENSORS];
  long long chunk_end[MAX_TENSORS];  // chunks of tensors 0..i, summed
  int count;
};

// torch.maximum: a NaN in either wins.
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// nu, the running maximum (mx, under amsgrad alone), and the denominator
// sqrt(v) / sqrt(bc2) + eps.
__device__ __forceinline__ float second(const Hyper& h, float abs2, float& nu, float* mx,
                                        float inv) {
  nu = __fmaf_rn(h.a2, abs2, __fmul_rn(nu, h.b2));
  float v = nu;
  if (h.amsgrad) {
    *mx = nan_max(*mx, nu);
    v = *mx;
  }
  return __fadd_rn(__fmul_rn(__fsqrt_rn(v), inv), h.eps);
}

__device__ __forceinline__ void real_step(const Hyper& h, float step, float inv, float& p,
                                          float g, float& mu, float& nu, float* mx) {
  if (h.has_wd) g = __fadd_rn(g, __fmul_rn(h.wd, p));
  mu = __fmaf_rn(h.a1, g, __fmul_rn(mu, h.b1));
  const float den = second(h, __fmul_rn(g, g), nu, mx, inv);
  p = __fmaf_rn(step, __fdiv_rn(mu, den), p);
}

__device__ __forceinline__ void complex_step(const Hyper& h, float step, float inv, float& pr,
                                             float& pi, float gr, float gi, float& mr,
                                             float& mi, float& nu, float* mx) {
  if (h.has_wd) {
    gr = __fadd_rn(gr, __fmul_rn(h.wd, pr));
    gi = __fadd_rn(gi, __fmul_rn(h.wd, pi));
  }
  mr = __fadd_rn(__fmul_rn(mr, h.b1), __fmul_rn(h.a1, gr));
  mi = __fadd_rn(__fmul_rn(mi, h.b1), __fmul_rn(h.a1, gi));
  const float den = second(h, __fadd_rn(__fmul_rn(gr, gr), __fmul_rn(gi, gi)), nu, mx, inv);
  const float r = __fdiv_rn(1.0f, den);
  pr = __fadd_rn(pr, __fmul_rn(step, __fmul_rn(mr, r)));
  pi = __fadd_rn(pi, __fmul_rn(step, __fmul_rn(mi, r)));
}

// Element k of tensor e, alone.
__device__ __forceinline__ void one(const Hyper& h, const Entry& e, long long k) {
  float* mx = h.amsgrad ? e.max_nu + k : nullptr;  // read only under amsgrad
  if (e.is_complex) {
    complex_step(h, e.step_size, e.inv_sqrt_bc2, e.p[2 * k], e.p[2 * k + 1], e.g[2 * k],
                 e.g[2 * k + 1], e.mu[2 * k], e.mu[2 * k + 1], e.nu[k], mx);
  } else {
    real_step(h, e.step_size, e.inv_sqrt_bc2, e.p[k], e.g[k], e.mu[k], e.nu[k], mx);
  }
}

// nu's vector: two floats beside two complex elements, four beside four reals.
template <bool CPLX> struct NuVec;
template <> struct NuVec<true> {
  float2 v;
  __device__ __forceinline__ float& operator[](int i) { return i ? v.y : v.x; }
};
template <> struct NuVec<false> {
  float4 v;
  __device__ __forceinline__ float& operator[](int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};

__device__ __forceinline__ float& lane(float4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

// Vectors [0, nvec) of the chunk starting at element lo of tensor e: each
// vector is 16 bytes of p, g and mu (EPV = 2 complex or 4 real elements).
template <bool CPLX>
__device__ __forceinline__ void vectors(const Hyper& h, const Entry& e, long long lo,
                                        long long nvec) {
  constexpr int EPV = CPLX ? 2 : 4;
  using NV = NuVec<CPLX>;
  using NT = decltype(NV::v);
  float4* p = reinterpret_cast<float4*>(e.p) + lo / EPV;
  const float4* g = reinterpret_cast<const float4*>(e.g) + lo / EPV;
  float4* mu = reinterpret_cast<float4*>(e.mu) + lo / EPV;
  NT* nu = reinterpret_cast<NT*>(e.nu) + lo / EPV;
  NT* mx = h.amsgrad ? reinterpret_cast<NT*>(e.max_nu) + lo / EPV : nullptr;
  for (long long base = threadIdx.x; base < nvec; base += THREADS * UNROLL) {
    float4 pv[UNROLL], gv[UNROLL], mv[UNROLL];
    NV nv[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = base + (long long)u * THREADS;
      if (k < nvec) {
        pv[u] = p[k];
        gv[u] = __ldcs(g + k);
        mv[u] = mu[k];
        nv[u].v = nu[k];
        if (mx) xv[u].v = mx[k];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long k = base + (long long)u * THREADS;
      if (k >= nvec) continue;
#pragma unroll
      for (int j = 0; j < EPV; ++j) {
        if (CPLX) {
          complex_step(h, e.step_size, e.inv_sqrt_bc2, lane(pv[u], 2 * j),
                       lane(pv[u], 2 * j + 1), lane(gv[u], 2 * j), lane(gv[u], 2 * j + 1),
                       lane(mv[u], 2 * j), lane(mv[u], 2 * j + 1), nv[u][j], &xv[u][j]);
        } else {
          real_step(h, e.step_size, e.inv_sqrt_bc2, lane(pv[u], j), lane(gv[u], j),
                    lane(mv[u], j), nv[u][j], &xv[u][j]);
        }
      }
      p[k] = pv[u];
      mu[k] = mv[u];
      nu[k] = nv[u].v;
      if (mx) mx[k] = xv[u].v;
    }
  }
}

__global__ void __launch_bounds__(THREADS) adam_kernel(const __grid_constant__ Args args) {
  const Hyper& h = args.h;
  const long long chunks = args.chunk_end[args.count - 1];
  int ti = 0;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    while (args.chunk_end[ti] <= c) ++ti;  // chunks rise, so ti only moves on
    const Entry& e = args.t[ti];
    const long long lo = (c - (ti ? args.chunk_end[ti - 1] : 0)) * CHUNK;
    const long long len = e.n - lo < CHUNK ? e.n - lo : CHUNK;
    const int epv = e.is_complex ? 2 : 4;
    const uintptr_t wide = reinterpret_cast<uintptr_t>(e.p) | reinterpret_cast<uintptr_t>(e.g) |
                           reinterpret_cast<uintptr_t>(e.mu);
    const uintptr_t narrow = reinterpret_cast<uintptr_t>(e.nu) |
                             reinterpret_cast<uintptr_t>(h.amsgrad ? e.max_nu : nullptr);
    long long done = 0;
    if (wide % 16 == 0 && narrow % (4 * epv) == 0) {
      done = len / epv * epv;
      if (e.is_complex)
        vectors<true>(h, e, lo, len / epv);
      else
        vectors<false>(h, e, lo, len / epv);
    }
    for (long long k = lo + done + threadIdx.x; k < lo + len; k += THREADS) one(h, e, k);
  }
}

}  // namespace

// table: the Hyper, then `count` Entry, in host memory (ops/kernels/adam.py:
// pack); blocks: the grid, at most the table's chunks.  A table or grid
// this file does not take returns cudaErrorInvalidValue without launching.
extern "C" int uno_adam_step(const void* table, int count, int blocks, void* stream) {
  if (table == nullptr || count < 1 || count > MAX_TENSORS || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args;
  std::memcpy(&args.h, table, sizeof(Hyper));
  std::memcpy(args.t, static_cast<const char*>(table) + sizeof(Hyper), count * sizeof(Entry));
  long long chunks = 0;
  for (int i = 0; i < count; ++i) {
    const Entry& e = args.t[i];
    if (e.n < 1 || !e.p || !e.g || !e.mu || !e.nu || (args.h.amsgrad && !e.max_nu))
      return static_cast<int>(cudaErrorInvalidValue);
    chunks += (e.n + CHUNK - 1) / CHUNK;
    args.chunk_end[i] = chunks;
  }
  if (blocks > chunks) return static_cast<int>(cudaErrorInvalidValue);
  args.count = count;
  adam_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}
