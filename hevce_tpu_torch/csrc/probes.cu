// Probe kernels P1-P3 for Hopper (sm_90a): the counterparts of the three
// Pallas probes in tools/pallas_probe.py. They measure what decides the
// next kernels of the port (the cost of a launch, exact int8 products on the
// tensor cores, a fused 4x4 eval whose transforms run on the tensor cores).
// Each is bound through a plain C function (ctypes, hevce_tpu_torch/ops/
// probes.py) that launches on the caller's stream and returns
// cudaGetLastError().
//
// P1 add_one (replaces probe_launch_overhead, tools/pallas_probe.py:38).
//   x += 1 in place on an (8, 128) int32 buffer. 8 KB in and out, 2.4 ns at
//   3.35 TB/s: what bounds it is the launch itself, which is what it
//   measures. One thread per element, 256 threads a block.
//
// P2 int8_mm (replaces probe_int8_matmul, tools/pallas_probe.py:76).
//   out = a @ b, a (M, K) int8, b (K, N) int8 -> (M, N) int32, exact (no
//   .satfinite: |sum| <= K * 2^14 stays inside int32 for K < 2^17). At the
//   probe's shape (512, 64) x (64, 64) it moves 167,936 B (50 ns) for 4.2 M
//   operations (2 ns on the int8 tensor cores): bound by bytes, and at this
//   size by the launch and by how many SMs take part. At (4096, 4096, 4096)
//   it is bound by the tensor cores (1.4e11 operations, 69 us at 1,979
//   TOP/s; 100 MB, 30 us). Design: mma.sync m16n8k16 s8 x s8 -> s32
//   (mma_s8.cuh) on tiles staged in shared memory, 64 of K at a time,
//   double-buffered: the next tile's loads are in flight in registers while
//   the warps multiply the current one. A is staged with 16-byte loads into
//   rows of 80 bytes (20 words, so the fragment loads hit 32 banks). B is
//   K-major for the "col" operand: each thread loads 16 k-rows x 4 columns
//   as 4-byte words, transposes them 4x4 bytes at a time with __byte_perm,
//   and stores each column's 16 bytes as one 16-byte word (no byte scatter).
//   Edges are zero-filled past M, N and K; where K % 16 (A) or N % 4 (B) is
//   not 0, or a pointer is not aligned, those loads go byte by byte. Each
//   thread's accumulator holds two adjacent columns, stored as one int2.
//   Two tilings: 128 x 128 on 8 warps (64 x 32 each) once that fills the
//   card's 132 SMs; else 32 x 16 on 2 warps, so the probe's 512 x 64 output
//   runs as 64 blocks, not 8.
//
// P3 fused4 (replaces probe_fused_pipeline, tools/pallas_probe.py:120).
//   The 4x4 candidate eval of the probe, held to its op chain (pallas_probe
//   .py:279-288; hevce_tpu_torch/ops/probes.py::fused4_plain): residual ->
//   forward DST4 -> RDOQ with the CG kill -> dequant -> inverse (clip16 after
//   each stage) -> recon -> per-mode SSE. pred (rows, modes * 16) u8 and blk
//   (rows, 16) u8 -> q (rows, modes * 16) int32, sse (rows, modes) int32.
//   At 512 rows x 35 modes it moves 1.51 MB (0.45 us) and does ~84 int32
//   operations per coefficient outside the transforms (0.72 us on the
//   CUDA cores' int32 lanes): bound by the epilogue's integer operations.
//   Design: a thread block takes a tile of 16 candidate blocks, one thread
//   per coefficient (256 threads). Each transform stage is one product of
//   the (16 blocks x 16 coefficients) tile with a 16x16 Kronecker matrix
//   (ops/probes.py::kron_stage / kron_inv; out = X @ K^T, so K row-major is
//   the "col" operand as it stands). Its wide operand is split into
//   base-128 digits (low digits in [0, 127], the top digit signed; 2 digits
//   for the 10-bit residual, 3 for the 18-bit and 16-bit operands, as
//   hevce_tpu/ops/xform.py::exact_matmul), each digit an int8 mma.sync tile
//   (16 rows x 16 coefficients x 8 outputs; warps 0 and 1 take one half of
//   the outputs each), recombined by Horner's rule in the int32
//   accumulator: acc = acc * 128 + digit @ K^T. Every partial is the
//   product of a right-shifted operand, so it stays within the stage's
//   bound (< 2^30). The TPU kernel's block-diagonal kron(eye(35), .)
//   operators and segment matrices existed only because Mosaic could not
//   reshape; here a mode's block is a row of the tile. RDOQ, the kill,
//   dequant, recon and SSE run on the CUDA cores in int32 as K1 does
//   (csrc/fused_eval.cu); the CG of a 4x4 block is the block, so its kill
//   sum and the SSE are 16-lane shuffle reductions. Negative levels are
//   scaled by multiplication, never by a left shift.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

constexpr int kI32Max = 0x7FFFFFFF;

// ------------------------------------------------------------------ P1

__global__ void p1_add_one(int* __restrict__ x, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1;
}

// ------------------------------------------------------------------ P2

constexpr int P2_BK = 64;                // depth of a staged tile, bytes
constexpr int P2_STRIDE = P2_BK + 16;    // bytes a shared row: 20 words, so
                                         // a fragment load hits 32 banks

// a block tile of BM x BN outputs on WM x WN warps, each warp TM x TN
// mma tiles (16 x 8 each)
template <int BM, int BN, int WM, int WN>
struct P2Cfg {
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int TM = BM / WM / 16, TN = BN / WN / 8;
  static constexpr int A_TASKS = BM * (P2_BK / 16) / THREADS;  // 16 B each
  static constexpr int B_TASKS = (P2_BK / 16) * (BN / 4);      // 16 x 4 B
  static_assert(A_TASKS * THREADS == BM * (P2_BK / 16), "A tasks");
  static_assert(B_TASKS <= THREADS, "B tasks");
};

// 16 bytes of row-major src (rows x K) at (r, k .. k+15), zero past the
// edges; vec: K % 16 == 0 and src 16-byte aligned, so a chunk is all in or
// all out and one 16-byte load takes it
__device__ __forceinline__ int4 p2_load16(const int8_t* src, int r, int k,
                                          int rows, int K, bool vec) {
  if (vec)
    return r < rows && k < K
        ? *reinterpret_cast<const int4*>(src + (long long)r * K + k)
        : make_int4(0, 0, 0, 0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (r < rows)
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < K)
        w[i >> 2] |= (uint32_t)(uint8_t)src[(long long)r * K + k + i]
                     << (8 * (i & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

// 4 bytes of row-major src (K x N) at (k, n .. n+3), zero past the edges;
// vec: N % 4 == 0 and src 4-byte aligned
__device__ __forceinline__ uint32_t p2_load4(const int8_t* src, int k, int n,
                                             int K, int N, bool vec) {
  if (k >= K) return 0u;
  if (vec) return n < N ? ld_u32(src + (long long)k * N + n) : 0u;
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (n + i < N)
      w |= (uint32_t)(uint8_t)src[(long long)k * N + n + i] << (8 * i);
  return w;
}

// transpose a 4x4 byte block in registers: r[i] holds row i (4 columns),
// c[j] gets column j (4 rows, the lowest row lowest)
__device__ __forceinline__ void p2_transpose4(const uint32_t* r, uint32_t* c) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

template <int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(P2Cfg<BM, BN, WM, WN>::THREADS)
p2_int8_mm(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
           int* __restrict__ out, int M, int K, int N, bool a_vec,
           bool b_vec, bool out_vec) {
  using Cfg = P2Cfg<BM, BN, WM, WN>;
  __shared__ __align__(16) int8_t As[2][BM][P2_STRIDE];
  __shared__ __align__(16) int8_t Bt[2][BN][P2_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // B task: 16 rows of k (chunk kc) x 4 columns (chunk nc), kc fastest, so
  // the 16-byte stores of a quarter-warp fall on 32 distinct banks
  const bool b_task = tid < Cfg::B_TASKS;
  const int kc = tid & 3, nc = tid >> 2;

  int4 ra[Cfg::A_TASKS];
  uint32_t rb[16];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < Cfg::A_TASKS; ++i) {
      const int task = tid + i * Cfg::THREADS;
      ra[i] = p2_load16(a, m0 + (task >> 2), k0 + 16 * (task & 3), M, K,
                        a_vec);
    }
    if (b_task) {
#pragma unroll
      for (int kk = 0; kk < 16; ++kk)
        rb[kk] = p2_load4(b, k0 + 16 * kc + kk, n0 + 4 * nc, K, N, b_vec);
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Cfg::A_TASKS; ++i) {
      const int task = tid + i * Cfg::THREADS;
      *reinterpret_cast<int4*>(&As[buf][task >> 2][16 * (task & 3)]) = ra[i];
    }
    if (b_task) {
      uint32_t col[4][4];                // col[j][q]: column j, k 4q .. 4q+3
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t c[4];
        p2_transpose4(rb + 4 * q, c);
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j][q] = c[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<int4*>(&Bt[buf][4 * nc + j][16 * kc]) =
            make_int4(col[j][0], col[j][1], col[j][2], col[j][3]);
    }
  };

  int acc[Cfg::TM][Cfg::TN][4] = {};
  const int KT = (K + P2_BK - 1) / P2_BK;
  fetch(0);
  stash(0);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < KT) fetch((kt + 1) * P2_BK);     // in flight meanwhile
#pragma unroll
    for (int kk = 0; kk < P2_BK; kk += 16) {
      uint32_t af[Cfg::TM][2], bf[Cfg::TN];
#pragma unroll
      for (int mt = 0; mt < Cfg::TM; ++mt) {
        const int r = wm * Cfg::TM * 16 + mt * 16 + g;
        af[mt][0] = ld_u32(&As[cur][r][kk + 4 * t]);
        af[mt][1] = ld_u32(&As[cur][r + 8][kk + 4 * t]);
      }
#pragma unroll
      for (int nt = 0; nt < Cfg::TN; ++nt)
        bf[nt] = ld_u32(&Bt[cur][wn * Cfg::TN * 8 + nt * 8 + g][kk + 4 * t]);
#pragma unroll
      for (int mt = 0; mt < Cfg::TM; ++mt)
#pragma unroll
        for (int nt = 0; nt < Cfg::TN; ++nt)
          mma_s8(acc[mt][nt], af[mt], bf[nt]);
    }
    if (kt + 1 < KT) stash(cur ^ 1);
    __syncthreads();
  }

  // each thread's accumulator holds two adjacent columns: one int2 store
#pragma unroll
  for (int mt = 0; mt < Cfg::TM; ++mt)
#pragma unroll
    for (int nt = 0; nt < Cfg::TN; ++nt) {
      const int n = n0 + wn * Cfg::TN * 8 + nt * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * Cfg::TM * 16 + mt * 16 + g + 8 * h;
        if (r >= M || n >= N) continue;
        int* o = out + (long long)r * N + n;
        if (out_vec && n + 1 < N) {
          *reinterpret_cast<int2*>(o) =
              make_int2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          o[0] = acc[mt][nt][2 * h];
          if (n + 1 < N) o[1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
}

// ------------------------------------------------------------------ P3

struct P3Params {
  int a_sft, dist_sft, sft, add, max_dlevel, thr, q_sft, wd, wb;
  int lvl[6];
};

__device__ __forceinline__ int rnd(int x, int s) {
  return (x + (1 << s >> 1)) >> s;
}

__device__ __forceinline__ int clip16(int x) {
  return min(max(x, -32768), 32767);
}

// estimateCoeffRate (reference src/HEVCe.c:526-535); lv >= 0
__device__ __forceinline__ int rate_of(int lv, const P3Params& p) {
  if (lv >= 6) return 92000 + ((4 + 2 * (31 - __clz(lv - 5))) << 15);
  int r = p.lvl[5];
  r = lv == 4 ? p.lvl[4] : r;
  r = lv == 3 ? p.lvl[3] : r;
  r = lv == 2 ? p.lvl[2] : r;
  r = lv == 1 ? p.lvl[1] : r;
  return lv == 0 ? p.lvl[0] : r;
}

// saturating RD cost of level lv (0 <= lv <= I32_MAX >> sft)
__device__ __forceinline__ int cost_of(int dlevel, int lv, const P3Params& p) {
  const int d1 = abs(dlevel - (lv << p.sft)) >> p.dist_sft;
  const int dist = (d1 < 46340 ? d1 * d1 : kI32Max) >> 7;
  const int r = rate_of(lv, p);
  const int c1 = (kI32Max / p.wd <= dist) ? kI32Max : p.wd * dist;
  const int c2 = (kI32Max / p.wb <= r) ? kI32Max : p.wb * r;
  return (kI32Max - c1 <= c2) ? kI32Max : c1 + c2;
}

// One transform stage on warps 0 and 1: O[:, 8h .. 8h+7] = X @ K^T for the
// tile's 16 rows, X split in NDIG digits and recombined by Horner's rule.
// bf is this thread's fragment of K (rows 8h + g, k = 4t .. 4t+3).
template <int NDIG>
__device__ __forceinline__ void stage(int (*X)[16], int (*O)[16],
                                      uint32_t bf, int h, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int4 lo = *reinterpret_cast<const int4*>(&X[g][4 * t]);
  const int4 hi = *reinterpret_cast<const int4*>(&X[g + 8][4 * t]);
  int acc[4] = {0, 0, 0, 0};
  {
    const uint32_t af[2] = {digits<true>(lo, NDIG - 1),
                            digits<true>(hi, NDIG - 1)};
    mma_s8(acc, af, bf);
  }
#pragma unroll
  for (int k = NDIG - 2; k >= 0; --k) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= 128;
    const uint32_t af[2] = {digits<false>(lo, k), digits<false>(hi, k)};
    mma_s8(acc, af, bf);
  }
  const int c = 8 * h + 2 * t;
  O[g][c] = acc[0];
  O[g][c + 1] = acc[1];
  O[g + 8][c] = acc[2];
  O[g + 8][c + 1] = acc[3];
}

// sum over the 16 lanes of one half-warp (one candidate block)
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(256)
p3_fused4(const uint8_t* __restrict__ pred, const uint8_t* __restrict__ blk,
          const int8_t* __restrict__ kron, long long n_blocks, int modes,
          P3Params p, int* __restrict__ q_out, int* __restrict__ sse_out) {
  __shared__ __align__(16) int X[16][16];
  __shared__ __align__(16) int O[16][16];
  const int tid = threadIdx.x, r = tid >> 4, e = tid & 15;
  const int warp = tid >> 5, lane = tid & 31;
  const bool mma_warp = warp < 2;
  const long long b = (long long)blockIdx.x * 16 + r;
  const bool live = b < n_blocks;

  // this thread's fragments of the four stage matrices (fwd 1, fwd 2,
  // inv 1, inv 2), 16x16 int8 each, row-major
  uint32_t bf[4] = {0, 0, 0, 0};
  if (mma_warp) {
    const int row = warp * 8 + (lane >> 2), col = 4 * (lane & 3);
#pragma unroll
    for (int s = 0; s < 4; ++s) bf[s] = ld_u32(kron + s * 256 + row * 16 + col);
  }
  int pv = 0, bv = 0;
  if (live) {
    pv = pred[b * 16 + e];
    bv = blk[(b / modes) * 16 + e];
  }
  X[r][e] = bv - pv;
  __syncthreads();

  // forward stage 1: tmp = round(M @ X >> a); |resid| <= 255: 2 digits
  if (mma_warp) stage<2>(X, O, bf[0], warp, lane);
  __syncthreads();
  X[r][e] = rnd(O[r][e], p.a_sft);
  __syncthreads();
  // forward stage 2: coef = round(tmp @ M^T >> a+7); |tmp| < 2^17: 3 digits
  if (mma_warp) stage<3>(X, O, bf[1], warp, lane);
  __syncthreads();
  const int coef = rnd(O[r][e], p.a_sft + 7);

  // RDOQ (reference src/HEVCe.c:526-592), as csrc/fused_eval.cu
  const int absval = abs(coef);
  const int dlevel = absval > 0x1FFFF
      ? p.max_dlevel : min((absval & 0x1FFFF) << 14, p.max_dlevel);
  const int level0 = min(max((dlevel + p.add) >> p.sft, -32768), 32767);
  int best_l = level0;
  int best_c = cost_of(dlevel, level0, p);
  for (int dd = 1; dd <= 2; ++dd) {
    const int lv = level0 - dd;
    const int cst = cost_of(dlevel, max(lv, 0), p);
    if (level0 >= dd && cst < best_c) {
      best_l = lv;
      best_c = cst;
    }
  }
  const int signed_l = coef < 0 ? -best_l : best_l;
  // the CG kill: a 4x4 block is one CG, kept iff sum(min(dlevel, thr)) >= thr
  const int qv = sum16(min(dlevel, p.thr)) >= p.thr ? signed_l : 0;
  if (live) q_out[b * 16 + e] = qv;

  // dequant: clip16(q * 2^q_sft); |q| * 2^9 < 2^24. X is free: stage 2
  // read it before the last barrier.
  X[r][e] = clip16(qv * (1 << p.q_sft));
  __syncthreads();
  // inverse stage 1: clip16(round(M^T @ dq >> 7)); |dq| <= 2^15: 3 digits
  if (mma_warp) stage<3>(X, O, bf[2], warp, lane);
  __syncthreads();
  X[r][e] = clip16(rnd(O[r][e], 7));
  __syncthreads();
  // inverse stage 2: clip16(round(tmp @ M >> 12)); recon; SSE
  if (mma_warp) stage<3>(X, O, bf[3], warp, lane);
  __syncthreads();
  const int recon = min(max(clip16(rnd(O[r][e], 12)) + pv, 0), 255);
  const int d = bv - recon;
  const int sse = sum16(d * d);
  if (live && e == 0) sse_out[b] = sse;
}

}  // namespace

extern "C" {

// P1: x[0 .. n) += 1 on `stream`. Returns cudaGetLastError().
int hevce_p1_add_one(void* x, long long n, void* stream) {
  const long long blocks = (n + 255) / 256;
  if (n > 0)
    p1_add_one<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<int*>(x), n);
  return cudaGetLastError();
}

// P2: out (M, N) int32 = a (M, K) int8 @ b (K, N) int8, all row-major and
// contiguous, on `stream`. Tiles of 128 x 128 on 8 warps when they fill the
// card's 132 SMs at least once, else 32 x 16 on 2 warps (the probe's 512 x
// 64 output as 64 blocks). Returns cudaGetLastError().
int hevce_p2_int8_mm(const void* a, const void* b, void* out, int M, int K,
                     int N, void* stream) {
  if (M <= 0 || N <= 0) return cudaGetLastError();
  const auto* pa = static_cast<const int8_t*>(a);
  const auto* pb = static_cast<const int8_t*>(b);
  auto* po = static_cast<int*>(out);
  const bool a_vec = K % 16 == 0 && (uintptr_t)a % 16 == 0;
  const bool b_vec = N % 4 == 0 && (uintptr_t)b % 4 == 0;
  const bool out_vec = N % 2 == 0 && (uintptr_t)out % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto blocks = [&](int bm, int bn) {
    return dim3((M + bm - 1) / bm, (N + bn - 1) / bn);
  };
  const dim3 big = blocks(128, 128);
  if ((long long)big.x * big.y >= 132)
    p2_int8_mm<128, 128, 2, 4><<<big, P2Cfg<128, 128, 2, 4>::THREADS, 0, s>>>(
        pa, pb, po, M, K, N, a_vec, b_vec, out_vec);
  else
    p2_int8_mm<32, 16, 2, 1><<<blocks(32, 16), P2Cfg<32, 16, 2, 1>::THREADS,
                               0, s>>>(pa, pb, po, M, K, N, a_vec, b_vec,
                                       out_vec);
  return cudaGetLastError();
}

// P3: the fused 4x4 eval over n_blocks candidate blocks (rows of pred, 16
// bytes each), `modes` blocks per original block. kron: the four 16x16 int8
// stage matrices on the device (fwd 1, fwd 2, inv 1, inv 2). Shifts are
// the 4x4 table entries (FWD_SHIFT_A, QUANT_DIST_SHIFT, QUANT_LEVEL_SHIFT,
// DEQUANT_SHIFT); wd / wb the qpd6's RD-cost weights; lvl6 (host memory) the
// first 6 entries of LEVEL_RATE_TABLE. Returns cudaGetLastError().
int hevce_p3_fused4(const void* pred, const void* blk, const void* kron,
                    long long n_blocks, int modes, int a_sft, int dist_sft,
                    int level_sft, int dequant_sft, int qpd6, int wd, int wb,
                    const int* lvl6, void* q, void* sse, void* stream) {
  P3Params p;
  p.a_sft = a_sft;
  p.dist_sft = dist_sft;
  p.sft = level_sft + qpd6;
  p.add = 1 << p.sft >> 1;
  p.max_dlevel = kI32Max - p.add;
  p.thr = 9 << p.sft >> 2;
  p.q_sft = dequant_sft + qpd6;
  p.wd = wd;
  p.wb = wb;
  for (int i = 0; i < 6; ++i) p.lvl[i] = lvl6[i];
  const long long blocks = (n_blocks + 15) / 16;
  if (n_blocks > 0)
    p3_fused4<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pred), static_cast<const uint8_t*>(blk),
        static_cast<const int8_t*>(kron), n_blocks, modes, p,
        static_cast<int*>(q), static_cast<int*>(sse));
  return cudaGetLastError();
}

}  // extern "C"
