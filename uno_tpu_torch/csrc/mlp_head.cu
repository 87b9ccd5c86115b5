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
// Forward.  What bounds it on an H100: operations.  Per grid point it takes
// 2*C*H flops for z and 2*H*O for the output: 2.96 GFLOP at the Darcy S=211
// shapes (B=16, C=64, N=44521, H=32, O=1), 0.044 ms at 67 TFLOP/s of f32
// outside the tensor cores, against 0.028 ms for its bytes (the bf16 read
// of x, 91 MB, and the f32 out); plus 22.8 M exact-erf GELUs, which the
// bound leaves out.  The first design (one thread per point, every
// multiply-add fed by a shared-memory load of its weight, each x value
// read as one 2-byte load at an odd row offset, nothing staged, the
// weights copied into shared memory once per 256 points) took 0.300 ms,
// 6.8x the bound.  This one computes z from the backward's code (stage_x,
// unpack_x, z_tile below) over tiles of TP = 128 points of one batch row,
// with the weights in shared memory once per block and the blocks walking
// the tiles, and splits a block's warps by role:
//   * PW producer warps stage the x rows of tile k + 1 (16-byte cp.async
//     into a ring of two bf16 tiles) while they unpack tile k to one of two
//     f32 tiles, and hand it over through named barriers;
//   * CT compute threads take items of 8 points x 4 hidden units (two
//     float4 of x and one of k1 per channel for 32 FMAs), apply GELU and
//     k2 in registers, and the `lanes` neighbouring threads that share the
//     points (hidden groups hq = tid % lanes, + lanes, ..) add their partial
//     outputs by an xor butterfly of shuffles, a fixed order; b2 goes on as
//     the sums are stored.  No atomics: the same inputs give the same bits.
// Scratch builds timed on the card showed why: with every warp doing every
// phase between block barriers, the phases added up (Z, the unpack, the
// staging, GELU in turn), and a warp's float4 shared load delivers 512
// bytes at the SM's 128 bytes per clock, so 4 x 4 items were held by
// shared-memory bandwidth at twice their FMA time; 8 x 4 items need a
// third less of it.  The launch plan (ops/kernels/mlp_head.py: fwd_plan)
// picks TP, the shared memory (109 KB at the path's shapes: two blocks of
// 4 compute and 4 producer warps per SM) and the grid from the card's SMs
// and shared memory.
// Measured on an H100 80GB HBM3 (700 W), the L2 flushed before each
// launch: 0.150 ms, 3.4x the bound, against 0.301 ms for the first design
// in the same runs and 0.47 ms for the plain f32 version.
//
// Backward, given g = dL/dout (B, O, N) f32:
//     dz[h] = (sum_o k2[h, o] g[o]) * gelu'(z[h])
//     gx[c] = sum_h k1[c, h] dz[h]                       (rounded to bf16)
//     gk1[c, h] = sum x[c] dz[h],  gb1[h] = sum dz[h],
//     gk2[h, o] = sum gelu(z[h]) g[o],  gb2[o] = sum g[o]
// with the weight-gradient sums over all B*N grid points.  What bounds it
// on an H100: operations.  Per point it recomputes z (C*H multiply-adds),
// then gx (C*H) and the gk1 outer product (C*H), plus 2*H*O for dz and gk2:
// 8.84 GFLOP at the Darcy S=211 shapes (B=16, C=64, N=44521, H=32, O=1),
// 0.132 ms at 67 TFLOP/s of f32 outside the tensor cores, against 0.055 ms
// for its bytes (x read, gx written, both bf16, and g).  Tensor cores stay
// out: TF32 or bf16 operands would break the head's f32-dot contract.
//
// The first design (one thread per point, every multiply-add fed by a
// shared-memory load, the gk1 sums two shared loads per FMA in a dependent
// chain, running sums in shared memory, 8 warps per SM) took 1.61 ms, 12x
// the bound.  This one treats a tile of TP = 128 points of one batch row as
// three small matrix products, each from register micro-tiles in which one
// shared-memory load feeds 8 FMAs or more:
//   * Z[TP x H] = X^T K1 + b1: a thread item is 4 points x 4 hidden units
//     (one float4 of x and one of k1 per channel for 16 FMAs); then dz and
//     gelu(z) in registers, dz to shared memory, and the thread's running
//     sums of gb1, gk2 and gb2 for its fixed 4 hidden units in registers;
//   * GX[TP x C] = DZ K1^T: an item is 4 points x 8 channels (3 float4 per
//     hidden unit for 32 FMAs), rounded to bf16 into a staging tile;
//   * GK1[C x H] += X DZ^T: each thread keeps a fixed 4 x 4 (c, h) share of
//     gk1 (MT shares where C*H is larger) in registers across every tile its
//     block walks, over one half of each tile's points (8 float4 loads for
//     64 FMAs per 4 points); the halves are added at the end.
// The tiles run along n within one batch row.  N = 44521 is odd, so a row
// starts anywhere in a 16-byte vector: a warp copies each row of the x tile
// with 16-byte cp.async from the vector below its start (a lane per vector)
// into a bf16 ring of two tiles, so the next tile's loads overlap this
// tile's products; the row's offset goes to shared memory, and once the
// copy lands the tile is unpacked to f32 without it.  gx leaves the same
// way: a lane per whole 16-byte vector, then one lane per element of a
// row's first and last vectors where those are not whole.  Points past a
// row's end are zeros and add nothing.  Hidden units are padded to a
// power-of-two count of 4-unit groups with zero weights, so every thread
// owns whole groups.  At the end each block adds its threads' small sums in
// thread order and writes one row of `partial`; pass 2 adds the rows, each
// warp of a block over a fixed slice of them, in warp order.  No atomics:
// the same inputs give the same bits.  The launch plan (ops/kernels/
// mlp_head.py: bwd_plan) picks TP, MT, the shared memory (105 KB at the
// path's shapes: two blocks of 8 warps per SM, at 128 registers a thread)
// and the grid from the card's SMs and shared memory.
// Measured on an H100 80GB HBM3 (700 W), the L2 flushed before each launch:
// 0.453 ms, 3.4x the bound, against 1.61 ms for the first design and 2.00
// ms for the plain f32 version (0.496 ms before the staging and the unpack
// went to a warp per row with int offsets, shared with the forward).  A
// trial build without the three products still took a large share of that
// (copies, unpacking, GELU, stores), and one with a block per SM (more
// registers) ran slower: what holds it is instructions per clock and warps
// per SM, not bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int BT = 256;       // threads of a pass-1 block of the backward
constexpr int CT = 128;       // the forward's compute threads
constexpr int PW = 4;         // the forward's producer warps, which stage and unpack x
constexpr int FT = CT + 32 * PW;  // threads of a forward block
constexpr int FNP = 2;        // a forward item's points, in groups of 4
constexpr int OMAX = 4;       // output channels the accumulators cover
constexpr int MAX_MT = 4;     // gk1 shares per thread
constexpr int MAX_NHQ = 32;   // backward: 4-unit hidden groups (H <= 128)
constexpr int NS = 4 + 4 * OMAX + OMAX;  // a thread's small sums: gb1, gk2, gb2
constexpr float RSQRT2 = 0.70710678118654752f;
constexpr float RSQRT_2PI = 0.39894228040143268f;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int hidden_padded(int H) {  // 4 * the power of two >= H / 4
  int q = 1;
  while (4 * q < H) q *= 2;
  return 4 * q;
}
// gk1 shares of 4 channels x 4 hidden units per thread of each half block:
// (C rounded to 4) / 4 channel groups x hp / 4 hidden groups over BT / 2
// threads, rounded up to 1, 2 or 4 (more is past the kernel's registers)
__host__ __device__ constexpr int bwd_mt(int C, int hp) {
  const int need = (round_up(C, 4) / 4 * (hp / 4) + BT / 2 - 1) / (BT / 2);
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= MAX_MT ? MAX_MT : need;
}

// Shared-memory layout of the forward, byte offsets (all multiples of 16).
// The launch plan computes the same bytes (mlp_head.py: fwd_smem).
struct FwdSmem {
  int k1, b1, k2, b2, sh, raw, xf, bytes;
  __host__ __device__ FwdSmem(int C, int hp, int tp) {
    k1 = 0;                                          // [C][hp]        f32
    b1 = k1 + 4 * C * hp;                            // [hp]           f32
    k2 = b1 + 4 * hp;                                // [OMAX][hp]     f32
    b2 = k2 + 4 * OMAX * hp;                         // [OMAX]         f32
    sh = b2 + 4 * OMAX;                              // 2 x [C]        int: rows' offsets
    raw = sh + round_up(2 * 4 * C, 16);              // 2 x [C][tp+8]  bf16
    xf = raw + 2 * 2 * C * (tp + 8);                 // 2 x [C][tp+4]  f32
    bytes = xf + 2 * 4 * C * (tp + 4);
  }
};

// Shared-memory layout of pass 1 of the backward, byte offsets (all
// multiples of 16).  The launch plan computes the same bytes (mlp_head.py:
// bwd_smem).
struct BwdSmem {
  int k1, k1t, b1, k2, sh, raw, sg, xf, dz, end, bytes;
  __host__ __device__ BwdSmem(int C, int hp, int tp, int mt) {
    const int rs = tp + 8, xs = tp + 4;
    k1 = 0;                                          // [C][hp]        f32
    k1t = k1 + 4 * C * hp;                           // [hp][C8]       f32
    b1 = k1t + 4 * hp * round_up(C, 8);              // [hp]           f32
    k2 = b1 + 4 * hp;                                // [hp][OMAX]     f32
    sh = k2 + 4 * hp * OMAX;                         // 2 x [C]        int: rows' offsets
    raw = sh + round_up(2 * 4 * C, 16);              // 2 x [C][tp+8]  bf16
    sg = raw + 2 * 2 * C * rs;                       // 2 x [OMAX][tp] f32
    xf = sg + 2 * 4 * OMAX * tp;                     // [C4][tp+4]     f32
    dz = xf + 4 * round_up(C, 4) * xs;               // [hp][tp+4]     f32
    end = dz + 4 * hp * xs;
    // at the end: the threads' small sums, then the second half's gk1 shares
    const int red = raw + 4 * (BT * NS + mt * 16 * (BT / 2));
    bytes = end > red ? end : red;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// A 16- or 4-byte copy of which the first n bytes are read, the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
// Named barrier `id` of n threads: bar_sync waits for the n arrivals,
// bar_arrive counts one and goes on.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- the tile code of both kernels ------------------------------------------
// A tile is TP points [n0, n0 + len) of batch row b; x and the staged rows
// are bf16, x 16-byte aligned (the wrapper sees to it).

// Copy the tile's C rows of x into one ring slot rd ([C][RS] bf16): warp w
// of nw copies rows w, w + nw, .., a lane per 16-byte vector (TP <= 128,
// so a row's RS / 8 <= 17 vectors), from the vector below the row's start
// (its offset in that vector, s = e0 % 8 elements, goes to sh[c]); bytes
// past the end of x (`total` elements, < 2^31, so offsets are ints) are
// zeroed.
__device__ __forceinline__ void stage_x(__nv_bfloat16* rd, int* sh,
                                        const __nv_bfloat16* __restrict__ x, int total, int b,
                                        int n0, int len, int C, int N, int RS, int w, int nw) {
  const int lane = threadIdx.x % 32;
#pragma unroll 2
  for (int c = w; c < C; c += nw) {
    const int e0 = (b * C + c) * N + n0, s = e0 & 7;
    if (lane == 0) sh[c] = s;
    if (8 * lane < s + len) {  // s + len <= TP + 7 < RS
      const int src = e0 - s + 8 * lane;
      cp_async16(rd + c * RS + 8 * lane, x + src, total - src >= 8 ? 16 : 2 * (total - src));
    }
  }
}

// Unpack a landed slot to f32 xf[c][p] (row stride XS) without the rows'
// offsets, zero past the tile's len points: warp w of nw unpacks the rows
// it staged, so the row's offset is one broadcast load, a lane per point
// p, + 32, .. (TP / 32 independent loads; the staged row holds TP + 8
// elements, so reading past len stays inside it).
__device__ __forceinline__ void unpack_x(float* xf, const __nv_bfloat16* rd, const int* sh,
                                         int C, int TP, int len, int RS, int XS, int w, int nw) {
  const int lane = threadIdx.x % 32;
#pragma unroll 2
  for (int c = w; c < C; c += nw) {
    const __nv_bfloat16* src = rd + c * RS + sh[c];
    float* dst = xf + c * XS;
#pragma unroll 4
    for (int p = lane; p < TP; p += 32) {
      const float v = __bfloat162float(src[p]);
      dst[p] = p < len ? v : 0.f;
    }
  }
}

// z[p][k] = b1[4 hq + k] + sum_c xf[c][p0 + p] k1s[c][4 hq + k] for the item
// of 4 NP points from p0 (a multiple of 4) x 4 hidden units: NP float4 of x
// and one of k1 per channel for 16 NP FMAs, the channels in order, the
// first one's FMAs starting from b1.
template <int NP>
__device__ __forceinline__ void z_tile(float (&z)[4 * NP][4], const float* xf, const float* k1s,
                                       const float* b1s, int C, int XS, int hp, int p0,
                                       int hq) {
  auto channel = [&](int c, const float (&add)[4 * NP][4]) {
    const float4 kv = *reinterpret_cast<const float4*>(k1s + c * hp + 4 * hq);
    const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      const float4 xv = *reinterpret_cast<const float4*>(xf + c * XS + p0 + 4 * q);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int k = 0; k < 4; ++k) z[4 * q + p][k] = fmaf(xa[p], ka[k], add[4 * q + p][k]);
    }
  };
  const float4 bv = *reinterpret_cast<const float4*>(b1s + 4 * hq);
  float b[4 * NP][4];
#pragma unroll
  for (int p = 0; p < 4 * NP; ++p) {
    b[p][0] = bv.x, b[p][1] = bv.y, b[p][2] = bv.z, b[p][3] = bv.w;
  }
  channel(0, b);
  for (int c = 1; c < C; ++c) channel(c, z);
}

// ---- forward -----------------------------------------------------------------
// Tiles t = (b, n0) = (t / tpr, t % tpr * TP), the block's kt-th tile t =
// blockIdx.x + kt * gridDim.x in ring slot and f32 tile kt % 2.  Warps CT /
// 32 .. FT / 32 - 1 produce: they stage tile kt + 1 while they unpack tile
// kt, and hand each f32 tile to the compute threads 0 .. CT - 1 through
// named barriers (FULL + slot: unpacked; EMPTY + slot: the products are
// done with it).  OM: output channels held in registers (1, or OMAX for O >
// 1).  A compute thread's items are the groups of P = 4 FNP points pg =
// slot, + CT / lanes, .. by the hidden groups hq = hl, + lanes, .. (hl =
// tid % lanes).
constexpr int FULL = 1, EMPTY = 3;  // named barriers FULL + slot, EMPTY + slot
template <int OM>
__global__ void __launch_bounds__(FT, 2)
mlp_head_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ k1, const float* __restrict__ b1,
                    const float* __restrict__ k2, const float* __restrict__ b2,
                    float* __restrict__ out, int B, int C, int N, int H, int O, int TP,
                    int hp) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  const FwdSmem L(C, hp, TP);
  float* k1s = reinterpret_cast<float*>(fsmem + L.k1);
  float* b1s = reinterpret_cast<float*>(fsmem + L.b1);
  float* k2s = reinterpret_cast<float*>(fsmem + L.k2);
  float* b2s = reinterpret_cast<float*>(fsmem + L.b2);
  int* shs = reinterpret_cast<int*>(fsmem + L.sh);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(fsmem + L.raw);
  float* xf = reinterpret_cast<float*>(fsmem + L.xf);
  const int tid = threadIdx.x;
  const int RS = TP + 8, XS = TP + 4;
  const int total = B * C * N;  // < 2^31 (the wrapper checks)
  const int tpr = (N + TP - 1) / TP;  // tiles per batch row
  const int tiles = B * tpr;
  const int G = gridDim.x;

  // weights, zero-padded to hp hidden units and OMAX outputs
  for (int e = tid; e < C * hp; e += FT) {
    const int c = e / hp, h = e % hp;
    k1s[e] = h < H ? k1[c * H + h] : 0.f;
  }
  for (int h = tid; h < hp; h += FT) b1s[h] = h < H ? b1[h] : 0.f;
  for (int e = tid; e < OMAX * hp; e += FT) {
    const int o = e / hp, h = e % hp;
    k2s[e] = (h < H && o < O) ? k2[h * O + o] : 0.f;
  }
  if (tid < OMAX) b2s[tid] = tid < O ? b2[tid] : 0.f;
  __syncthreads();

  if (tid >= CT) {  // a producer warp: rows w, w + PW, .. of every tile
    const int w = (tid - CT) / 32;
    auto load = [&](int t, int buf) {
      const int n0 = t % tpr * TP;
      stage_x(raw + buf * C * RS, shs + buf * C, x, total, t / tpr, n0, min(TP, N - n0), C, N,
              RS, w, PW);
    };
    if ((int)blockIdx.x < tiles) load(blockIdx.x, 0);
    cp_async_commit();
    int kt = 0;
    for (int t = blockIdx.x; t < tiles; t += G, ++kt) {
      const int buf = kt & 1, len = min(TP, N - t % tpr * TP);
      __syncwarp();  // the warp's lanes are done reading slot buf ^ 1 (tile kt - 1)
      if (t + G < tiles) load(t + G, buf ^ 1);
      cp_async_commit();  // one group per tile, empty at the end
      cp_async_wait_all_but_last();
      __syncwarp();  // tile kt's rows of this warp have landed, from every lane
      if (kt >= 2) bar_sync(EMPTY + buf, FT);  // the products are done with tile kt - 2
      unpack_x(xf + buf * C * XS, raw + buf * C * RS, shs + buf * C, C, TP, len, RS, XS, w, PW);
      bar_arrive(FULL + buf, FT);
    }
    return;
  }

  constexpr int P = 4 * FNP;  // an item's points
  const int nhq = hp / 4, npg = TP / P;
  const int lanes = nhq < 32 ? nhq : 32;  // threads that share a point group
  const int hl = tid % lanes, slot = tid / lanes, nslot = CT / lanes;
  int kt = 0;
  for (int t = blockIdx.x; t < tiles; t += G, ++kt) {
    const int b = t / tpr, n0 = t % tpr * TP, len = min(TP, N - n0), buf = kt & 1;
    const float* xt = xf + buf * C * XS;
    bar_sync(FULL + buf, FT);  // tile kt is unpacked into xt
    float* ob = out + (long long)b * O * N + n0;
    for (int pg0 = 0; pg0 < npg; pg0 += nslot) {  // the same trips for every thread
      const int pg = pg0 + slot;
      float acc[P][OM];
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int o = 0; o < OM; ++o) acc[p][o] = 0.f;
      if (pg < npg) {
        for (int hq = hl; hq < nhq; hq += lanes) {
          float z[P][4];
          z_tile<FNP>(z, xt, k1s, b1s, C, XS, hp, P * pg, hq);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int k = 0; k < 4; ++k)  // gelu, exact erf
              z[p][k] = 0.5f * z[p][k] * (1.f + erff(z[p][k] * RSQRT2));
#pragma unroll
          for (int o = 0; o < OM; ++o) {
            const float4 kv = *reinterpret_cast<const float4*>(k2s + o * hp + 4 * hq);
            const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
            for (int p = 0; p < P; ++p)
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[p][o] = fmaf(z[p][k], ka[k], acc[p][o]);
          }
        }
      }
      // the lanes of a point group add their partial sums: an xor butterfly
      for (int m = 1; m < lanes; m <<= 1)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int o = 0; o < OM; ++o) acc[p][o] += __shfl_xor_sync(0xffffffffu, acc[p][o], m);
      // lane (P o + p) % lanes of the group stores out[o][P pg + p] (lanes is
      // a power of two)
      if (pg < npg) {
#pragma unroll
        for (int o = 0; o < OM; ++o)
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int n = P * pg + p;
            if (o < O && ((P * o + p) & (lanes - 1)) == hl && n < len)
              ob[(long long)o * N + n] = acc[p][o] + b2s[o];
          }
      }
    }
    if (t + 2 * G < tiles) bar_arrive(EMPTY + buf, FT);  // the producers refill xt
  }
}

// ---- backward ----------------------------------------------------------------
// Pass 1 of the backward: gx, and one row of per-block weight-gradient sums
// in `partial` (gridDim.x rows of E = C*H + H + H*O + O floats, laid out as
// [gk1 | gb1 | gk2 | gb2]).  Block tiles: TP points of one batch row, tile
// t = (b, n0) = (t / tpr, t % tpr * TP), walked t = blockIdx.x, + gridDim.x..
// x and gx are 16-byte aligned (the wrapper sees to it).  MT: gk1 shares per
// thread; OM: output channels held in registers (1, or OMAX for O > 1).
template <int MT, int OM>
__global__ void __launch_bounds__(BT, MT == MAX_MT ? 1 : 2)
mlp_head_bwd_partial_kernel(const __nv_bfloat16* __restrict__ x,
                            const float* __restrict__ g,
                            const float* __restrict__ k1,
                            const float* __restrict__ b1,
                            const float* __restrict__ k2,
                            __nv_bfloat16* __restrict__ gx,
                            float* __restrict__ partial,
                            int B, int C, int N, int H, int O, int TP, int hp) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  unsigned char* smem = bsmem;
  const BwdSmem L(C, hp, TP, MT);
  float* k1s = reinterpret_cast<float*>(smem + L.k1);
  float* k1t = reinterpret_cast<float*>(smem + L.k1t);
  float* b1s = reinterpret_cast<float*>(smem + L.b1);
  float* k2s = reinterpret_cast<float*>(smem + L.k2);
  int* shs = reinterpret_cast<int*>(smem + L.sh);
  __nv_bfloat16* raw = reinterpret_cast<__nv_bfloat16*>(smem + L.raw);
  float* sg = reinterpret_cast<float*>(smem + L.sg);
  float* xf = reinterpret_cast<float*>(smem + L.xf);
  float* dzs = reinterpret_cast<float*>(smem + L.dz);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int lg = __ffs(TP) - 1;       // TP is a power of two
  const int RS = TP + 8, XS = TP + 4, C8 = round_up(C, 8), C4 = round_up(C, 4);
  const int nhq = hp / 4, npq = TP / 4, nrq = C4 / 4;
  const int hq = tid % nhq;           // this thread's hidden group, in Z and GK1
  const int half = tid / (BT / 2), u = tid % (BT / 2);  // GK1: which half of the points
  const int total = B * C * N;  // < 2^31 (the wrapper checks)
  const int tpr = (N + TP - 1) / TP;  // tiles per batch row
  const int tiles = B * tpr;

  // weights, zero-padded to hp hidden units and C8 channels
  for (int e = tid; e < C * hp; e += BT) {
    const int c = e / hp, h = e % hp;
    k1s[e] = h < H ? k1[c * H + h] : 0.f;
  }
  for (int e = tid; e < hp * C8; e += BT) {
    const int h = e / C8, c = e % C8;
    k1t[e] = (h < H && c < C) ? k1[c * H + h] : 0.f;
  }
  for (int h = tid; h < hp; h += BT) b1s[h] = h < H ? b1[h] : 0.f;
  for (int e = tid; e < hp * OMAX; e += BT) {
    const int h = e / OMAX, o = e % OMAX;
    k2s[e] = (h < H && o < O) ? k2[h * O + o] : 0.f;
  }
  for (int e = C * XS + tid; e < C4 * XS; e += BT) xf[e] = 0.f;  // pad channels

  // Copy tile t into ring slot `buf`: the x rows (stage_x), then the g
  // rows, zero past the row's end.
  auto load = [&](int t, int buf) {
    const int b = t / tpr, n0 = t % tpr * TP, len = min(TP, N - n0);
    stage_x(raw + buf * C * RS, shs + buf * C, x, total, b, n0, len, C, N, RS, warp, BT / 32);
    float* gd = sg + buf * OMAX * TP;
    for (int q = tid; q < O * TP; q += BT) {
      const int o = q >> lg, p = q & (TP - 1);
      const bool ok = p < len;
      cp_async4(gd + o * TP + p, ok ? g + ((long long)b * O + o) * N + n0 + p : g, ok ? 4 : 0);
    }
  };

  float acc1[MT][4][4];  // this thread's gk1 shares over its half of every tile
  float sb1[4], sk2[4][OM], sb2[OM];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc1[j][r][k] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    sb1[k] = 0.f;
#pragma unroll
    for (int o = 0; o < OM; ++o) sk2[k][o] = 0.f;
  }
#pragma unroll
  for (int o = 0; o < OM; ++o) sb2[o] = 0.f;

  if ((int)blockIdx.x < tiles) load(blockIdx.x, 0);
  cp_async_commit();
  int cb = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, cb ^= 1) {
    const int b = t / tpr, n0 = t % tpr * TP, len = min(TP, N - n0);
    cp_async_wait_all();
    __syncthreads();  // tile t has landed; the last tile's gx has been stored
    if (t + (int)gridDim.x < tiles) {
      load(t + gridDim.x, cb ^ 1);
      cp_async_commit();
    }
    __nv_bfloat16* rd = raw + cb * C * RS;
    const int* sh = shs + cb * C;
    const float* gt = sg + cb * OMAX * TP;

    unpack_x(xf, rd, sh, C, TP, len, RS, XS, warp, BT / 32);
    __syncthreads();

    // Z: items of 4 points x the hidden group hq; dz to shared memory, the
    // small sums in registers
    for (int pq = tid / nhq; pq < npq; pq += BT / nhq) {
      float z[4][4];
      z_tile<1>(z, xf, k1s, b1s, C, XS, hp, 4 * pq, hq);
      float gv[OM][4];
#pragma unroll
      for (int o = 0; o < OM; ++o) {
        const float4 v = o < O ? *reinterpret_cast<const float4*>(gt + o * TP + 4 * pq)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
        gv[o][0] = v.x, gv[o][1] = v.y, gv[o][2] = v.z, gv[o][3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = 4 * hq + k;
        float d[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const float zz = z[p][k];
          const float cdf = 0.5f * (1.f + erff(zz * RSQRT2));
          const float a = zz * cdf;
          const float dg = fmaf(zz, expf(-0.5f * zz * zz) * RSQRT_2PI, cdf);
          float dzp = 0.f;
#pragma unroll
          for (int o = 0; o < OM; ++o) {
            dzp = fmaf(k2s[h * OMAX + o], gv[o][p], dzp);
            sk2[k][o] = fmaf(a, gv[o][p], sk2[k][o]);
          }
          d[p] = dzp * dg;
          sb1[k] += d[p];
        }
        *reinterpret_cast<float4*>(dzs + h * XS + 4 * pq) = make_float4(d[0], d[1], d[2], d[3]);
      }
      if (hq == 0) {
#pragma unroll
        for (int o = 0; o < OM; ++o)
#pragma unroll
          for (int p = 0; p < 4; ++p) sb2[o] += gv[o][p];
      }
    }
    __syncthreads();

    // GX: items of 4 points x 8 channels, rounded to bf16 into the x ring
    // slot (free since the unpack), at the row's offset
    const int nco = C8 / 8;
    for (int it = tid; it < npq * nco; it += BT) {
      const int co = it % nco, pq = it / nco;
      float a[4][8];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[p][j] = 0.f;
      for (int h = 0; h < hp; ++h) {
        const float4 dv = *reinterpret_cast<const float4*>(dzs + h * XS + 4 * pq);
        const float4 ka = *reinterpret_cast<const float4*>(k1t + h * C8 + 8 * co);
        const float4 kb = *reinterpret_cast<const float4*>(k1t + h * C8 + 8 * co + 4);
        const float da[4] = {dv.x, dv.y, dv.z, dv.w};
        const float kk[8] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) a[p][j] = fmaf(da[p], kk[j], a[p][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * co + j;
        if (c < C) {
          __nv_bfloat16* dst = rd + c * RS + sh[c] + 4 * pq;
#pragma unroll
          for (int p = 0; p < 4; ++p) dst[p] = __float2bfloat16(a[p][j]);
        }
      }
    }

    // GK1: this thread's shares, channels rq + nrq * r by hidden units
    // hq + nhq * k, over its half of the tile's points, 4 points at a time
    for (int p4 = half * npq / 2; p4 < (half + 1) * npq / 2; ++p4) {
      float4 dv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        dv[k] = *reinterpret_cast<const float4*>(dzs + (hq + nhq * k) * XS + 4 * p4);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const int rq = (u + j * (BT / 2)) / nhq;
        if (rq < nrq) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(xf + (rq + nrq * r) * XS + 4 * p4);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              float s = acc1[j][r][k];
              s = fmaf(xv.x, dv[k].x, s);
              s = fmaf(xv.y, dv[k].y, s);
              s = fmaf(xv.z, dv[k].z, s);
              acc1[j][r][k] = fmaf(xv.w, dv[k].w, s);
            }
          }
        }
      }
    }
    __syncthreads();

    // store gx: a warp per row, a lane per 16-byte vector inside the row's
    // positions [s, s + len) of the staged row; then the elements of its
    // first and last vectors where they are not whole, one per lane
    for (int c = warp; c < C; c += BT / 32) {
      const int s = sh[c], end = s + len, last = (end - 1) / 8;
      __nv_bfloat16* dst = gx + (((long long)b * C + c) * N + n0 - s);
      const __nv_bfloat16* src = rd + c * RS;
      const int lo = 8 * lane;
      if (lo >= s && lo + 8 <= end)
        *reinterpret_cast<uint4*>(dst + lo) = *reinterpret_cast<const uint4*>(src + lo);
      const int q = lane < 8 ? lane : 8 * last + lane - 8;  // lanes 0-7 first, 8-15 last
      const int v = q / 8;
      if (lane < 16 && q >= s && q < end && (lane < 8 || v > 0) && (8 * v < s || 8 * v + 8 > end))
        dst[q] = src[q];
    }
  }

  // This block's row of `partial`: the gk1 shares of the two halves added,
  // first half first; the small sums of the threads that share a hidden
  // group, added in thread order.
  cp_async_wait_all();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem + L.raw);  // [NS][BT]
  float* red1 = red + NS * BT;                          // [MT * 16][BT / 2]
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    red[k * BT + tid] = sb1[k];
#pragma unroll
    for (int o = 0; o < OM; ++o) red[(4 + k * OMAX + o) * BT + tid] = sk2[k][o];
  }
#pragma unroll
  for (int o = 0; o < OM; ++o) red[(4 + 4 * OMAX + o) * BT + tid] = sb2[o];
  if (half == 1) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) red1[(j * 16 + r * 4 + k) * (BT / 2) + u] = acc1[j][r][k];
  }
  __syncthreads();

  float* row = partial + (size_t)blockIdx.x * (C * H + H + H * O + O);
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int rq = (u + j * (BT / 2)) / nhq;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = rq + nrq * r, h = hq + nhq * k;
          if (rq < nrq && c < C && h < H)
            row[c * H + h] = acc1[j][r][k] + red1[(j * 16 + r * 4 + k) * (BT / 2) + u];
        }
    }
  }
  for (int e = tid; e < H + H * O + O; e += BT) {
    int slot, group;
    if (e < H) {
      slot = e % 4, group = e / 4;
    } else if (e < H + H * O) {
      const int h = (e - H) / O, o = (e - H) % O;
      slot = 4 + h % 4 * OMAX + o, group = h / 4;
    } else {
      slot = 4 + 4 * OMAX + (e - H - H * O), group = 0;
    }
    float s = 0.f;
    for (int v = group; v < BT; v += nhq) s += red[slot * BT + v];
    row[C * H + e] = s;
  }
}

// Pass 2: sum the per-block rows, a block per 32 entries: each of its RW
// warps adds its own contiguous slice of the rows in order, then the
// slices' sums are added in warp order.
constexpr int RW = 8;
__global__ void __launch_bounds__(32 * RW)
mlp_head_bwd_reduce_kernel(const float* __restrict__ partial, int rows, int C, int H, int O,
                           float* __restrict__ gk1, float* __restrict__ gb1,
                           float* __restrict__ gk2, float* __restrict__ gb2) {
  __shared__ float slice[RW][32];
  const int CH = C * H, HO = H * O;
  const int E = CH + H + HO + O;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  const int per = (rows + RW - 1) / RW, end = min(rows, (w + 1) * per);
  float s = 0.f;
  if (e < E) {
#pragma unroll 4
    for (int r = w * per; r < end; ++r) s += partial[(size_t)r * E + e];
  }
  slice[w][lane] = s;
  __syncthreads();
  if (w != 0 || e >= E) return;
  for (int k = 1; k < RW; ++k) s += slice[k][lane];
  if (e < CH) gk1[e] = s;
  else if (e < CH + H) gb1[e - CH] = s;
  else if (e < CH + H + HO) gk2[e - CH - H] = s;
  else gb2[e - CH - H - HO] = s;
}

// Opts `kernel` in to all the shared memory a block may have on the current
// device, once per device: `done` keeps a bit for each of devices 0-63
// (others ask every launch).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, std::atomic<unsigned long long>& done) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace

// The plan arguments (tile .. blocks) come from fwd_plan in
// ops/kernels/mlp_head.py; a plan this file does not expect, or x off a
// 16-byte boundary, returns cudaErrorInvalidValue without launching.
extern "C" int uno_mlp_head_fwd(const void* x, const void* k1, const void* b1,
                                const void* k2, const void* b2, void* out,
                                int B, int C, int N, int H, int O,
                                int tile, int threads, int hp, int smem, int blocks,
                                void* stream) {
  if ((tile != 32 && tile != 64 && tile != 128) || threads != FT || hp != hidden_padded(H) ||
      O < 1 || O > OMAX || smem != FwdSmem(C, hp, tile).bytes || blocks < 1 ||
      (long long)blocks > (long long)B * ((N + tile - 1) / tile) ||
      reinterpret_cast<std::uintptr_t>(x) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> done[2]{};  // per kernel: O == 1, O > 1
  const auto kernel = O == 1 ? &mlp_head_fwd_kernel<1> : &mlp_head_fwd_kernel<OMAX>;
  const cudaError_t err = opt_in_smem(kernel, done[O == 1 ? 0 : 1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, FT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(k1),
      static_cast<const float*>(b1), static_cast<const float*>(k2),
      static_cast<const float*>(b2), static_cast<float*>(out), B, C, N, H, O, tile, hp);
  return static_cast<int>(cudaGetLastError());
}

// partial: blocks x (C*H + H + H*O + O) f32 scratch, allocated by the caller.
// The plan arguments (tile .. blocks) come from bwd_plan in
// ops/kernels/mlp_head.py; a plan this file does not expect, or x or gx off
// a 16-byte boundary, returns cudaErrorInvalidValue without launching.
extern "C" int uno_mlp_head_bwd(const void* x, const void* g, const void* k1,
                                const void* b1, const void* k2, void* gx,
                                void* gk1, void* gb1, void* gk2, void* gb2,
                                void* partial, int B, int C, int N, int H, int O,
                                int tile, int threads, int hp, int mt, int smem,
                                int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hp_want = hidden_padded(H);
  if ((tile != 32 && tile != 64 && tile != 128) || threads != BT || hp != hp_want ||
      hp / 4 > MAX_NHQ || O < 1 || O > OMAX || mt != bwd_mt(C, hp) ||
      smem != BwdSmem(C, hp, tile, mt).bytes || blocks < 1 ||
      (long long)blocks > (long long)B * ((N + tile - 1) / tile) ||
      reinterpret_cast<std::uintptr_t>(x) % 16 || reinterpret_cast<std::uintptr_t>(gx) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  // one opt-in record per kernel: [O == 1, O > 1][mt = 1, 2, 4]
  static std::atomic<unsigned long long> done[2][3]{};
  const int om = O == 1 ? 0 : 1, mi = mt == 1 ? 0 : mt == 2 ? 1 : 2;
  using Kernel = decltype(&mlp_head_bwd_partial_kernel<1, 1>);
  const Kernel kernels[2][3] = {
      {&mlp_head_bwd_partial_kernel<1, 1>, &mlp_head_bwd_partial_kernel<2, 1>,
       &mlp_head_bwd_partial_kernel<4, 1>},
      {&mlp_head_bwd_partial_kernel<1, OMAX>, &mlp_head_bwd_partial_kernel<2, OMAX>,
       &mlp_head_bwd_partial_kernel<4, OMAX>}};
  const Kernel kernel = kernels[om][mi];
  cudaError_t err = opt_in_smem(kernel, done[om][mi]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, BT, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(k1), static_cast<const float*>(b1),
      static_cast<const float*>(k2), static_cast<__nv_bfloat16*>(gx),
      static_cast<float*>(partial), B, C, N, H, O, tile, hp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int E = C * H + H + H * O + O;
  mlp_head_bwd_reduce_kernel<<<(E + 31) / 32, 32 * RW, 0, st>>>(
      static_cast<const float*>(partial), blocks, C, H, O,
      static_cast<float*>(gk1), static_cast<float*>(gb1),
      static_cast<float*>(gk2), static_cast<float*>(gb2));
  return static_cast<int>(cudaGetLastError());
}
