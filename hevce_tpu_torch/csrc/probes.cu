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
//   measures. So it is one block: a thread per 16-byte word (the probe's
//   4 KB are 256 of them), then a thread per element of the tail that is
//   not a multiple of 4 (or of the whole buffer where x is not 16-byte
//   aligned); at one element, one block of one thread, the card's least
//   kernel.
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
//   Design: one warp owns a tile of 16 candidate blocks from load to store,
//   with no shared memory and no barrier. A block is a row of the tile; each
//   transform stage is the product of the (16 blocks x 16 coefficients) tile
//   with a 16x16 Kronecker matrix (ops/probes.py::kron_stage / kron_inv;
//   out = X @ K^T, K row-major being the "col" operand as it stands), as
//   mma.sync m16n8k16 products for output columns 0-7 and 8-15. The first
//   forward stage takes the loaded bytes as they are: M @ (blk - pred) =
//   blk @ K^T + pred @ (-K)^T, two u8 x s8 products a half. The other
//   stages' operands are below 2^15 at 4x4 (|tmp| <= 255 * 242 / 2, the
//   dequantised levels and the inverse's middle clip16), so each splits in
//   two base-256 digits, an s8 top byte and a u8 low byte taken out by byte
//   permutes, recombined by Horner's rule in the int32 accumulator: acc =
//   (hi @ K^T) * 256 + lo @ K^T; every sum stays below 2^23. After the two
//   products thread (g, t) holds output columns {2t, 2t+1, 8+2t, 9+2t} of
//   rows g and g+8: the shape of its next A fragment (depth 4t .. 4t+3 of
//   the same rows). The rows of every stage matrix are permuted on the host
//   (ops/probes.py::P3_ORDER) so that those columns are coefficients
//   4t .. 4t+3 in raster order: each stage reads the previous stage's
//   accumulator as it stands, and each thread owns the same 8 coefficients,
//   4 consecutive ones of each of its 2 blocks, from the residual to the
//   SSE. So pred and blk come in as 4-byte words, q goes out as 16-byte
//   words, and RDOQ, the kill, dequant, recon and SSE run on those 8
//   registers, step by step over the 8 so that their chains interleave; the
//   kill sum and the SSE of a block are a sum of 4 and two xor shuffles
//   across the quad. RDOQ takes the form that holds at 4x4 (rdoq: no cost
//   saturates, level0 - 2 never wins, and level0 - 1 wins iff the rounding
//   error is below a threshold set by the rate step at level0), so it is a
//   compare with one of 8 thresholds the host makes for the qpd6, read by a
//   shuffle; a CPU test checks it against the full three-candidate search
//   for every |coef| and qpd6. There is no division: a block's blk row
//   comes from a multiply-high by a host-made magic number. 1,120 warp
//   tiles at 512 x 35 fit the card in one wave. Rows past the end of a
//   ragged last tile are masked at load and store. Negative levels are
//   scaled by multiplication, never by a left shift.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

constexpr int kI32Max = 0x7FFFFFFF;

// ------------------------------------------------------------------ P1

// x[0 .. n) += 1: thread i adds to 16-byte word i (i < n4), or to element
// 4 n4 + i - n4 of the tail past the words
__global__ void __launch_bounds__(256)
p1_add_one(int* __restrict__ x, int n4, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n4) {
    int4 w = reinterpret_cast<int4*>(x)[i];
    w.x += 1;
    w.y += 1;
    w.z += 1;
    w.w += 1;
    reinterpret_cast<int4*>(x)[i] = w;
  } else if (3 * n4 + i < n) {
    x[3 * n4 + i] += 1;
  }
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

// warp tiles (16 candidate blocks each) a thread block: 1,120 tiles at
// 512 x 35, so 280 blocks of 4 warps, all in one wave on 132 SMs (1 or 2
// warps a block measured no faster)
constexpr int kP3Warps = 4;

struct P3Params {
  int a_sft, sft, add, max_dlevel, thr, q_sft;
  int modes;
  unsigned div_mul, div_shr;           // n / modes = umulhi(n, mul) >> shr
  int th[8];                           // RDOQ's thresholds (rdoq below)
};

__device__ __forceinline__ int rnd(int x, int s) {
  return (x + (1 << s >> 1)) >> s;
}

__device__ __forceinline__ int clip16(int x) {
  return min(max(x, -32768), 32767);
}

// RDOQ of 8 coefficients (reference src/HEVCe.c:526-592): the signed level
// of least RD cost among level0, level0 - 1 and level0 - 2 (strict <, so
// ties keep the higher level), and each dlevel for the CG kill. At 4x4 the
// costs never saturate and level0 - 2 never wins, so the choice is level0 -
// 1 iff wd * (dist(level0 - 1) - dist(level0)) < wb * (rate(level0) -
// rate(level0 - 1)). The distortions depend only on e0 = dlevel - (level0
// << sft), and their weighted difference rises with e0 wherever it can
// decide, so the choice is e0 < th[k] for k the class of level0's rate step:
// k = level0 for 0 .. 6, 7 above where level0 - 5 is a power of two, else 0
// (no step: th[0] lies below every e0). ops/probes.py::p3_rdoq_thresholds
// makes th for the qpd6 and checks that form against the full search over
// every reachable e0; tests/test_torch_probes.py holds this kernel's form to
// the full search for every |coef|. `th` is this lane's th[lane & 7], read
// by a shuffle. Step by step over the 8 values, so their chains interleave.
__device__ __forceinline__ void rdoq(int (&x)[8], int (&dlevel)[8],
                                     const P3Params& p, int th) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dlevel[i] = min(min(abs(x[i]), 0x1FFFF) << 14, p.max_dlevel);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int l = (dlevel[i] + p.add) >> p.sft;
    const int e0 = dlevel[i] - (l << p.sft);
    const int k = l <= 6 ? l : (((l - 5) & (l - 6)) == 0 ? 7 : 0);
    const int lv = l - (e0 < __shfl_sync(0xffffffffu, th, k));
    x[i] = x[i] < 0 ? -lv : lv;
  }
}

// the 4 values' byte 0 (lo) and byte 1 (hi) packed as A fragment words:
// for |v| < 2^15, v = hi * 256 + lo with hi signed (s8) and lo unsigned (u8)
__device__ __forceinline__ void split256(const int* v, uint32_t& lo,
                                         uint32_t& hi) {
  const uint32_t p01 = __byte_perm(v[0], v[1], 0x5140);  // v0.0 v1.0 v0.1 v1.1
  const uint32_t p23 = __byte_perm(v[2], v[3], 0x5140);
  lo = __byte_perm(p01, p23, 0x5410);
  hi = __byte_perm(p01, p23, 0x7632);
}

// the accumulators of a stage's two products (output columns 0-7 in c0,
// 8-15 in c1) as this thread's coefficients 4t .. 4t+3 of rows g (x[0..3])
// and g+8 (x[4..7])
__device__ __forceinline__ void gather(const int (&c0)[4], const int (&c1)[4],
                                       int (&x)[8]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    x[4 * h] = c0[2 * h];
    x[4 * h + 1] = c0[2 * h + 1];
    x[4 * h + 2] = c1[2 * h];
    x[4 * h + 3] = c1[2 * h + 1];
  }
}

// One transform stage on the warp: x (this thread's coefficients 4t .. 4t+3
// of the tile's rows g (x[0..3]) and g+8 (x[4..7]), |x| < 2^15) becomes
// x @ K^T, as hi @ K^T * 256 + lo @ K^T. bf: this thread's fragments of the
// permuted K, rows g (output columns 0-7) and 8+g (8-15), k = 4t .. 4t+3.
__device__ __forceinline__ void stage(int (&x)[8], const uint32_t (&bf)[2]) {
  uint32_t lo[2], hi[2];
  split256(x, lo[0], hi[0]);
  split256(x + 4, lo[1], hi[1]);
  int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
  mma_s8(c0, hi, bf[0]);
  mma_s8(c1, hi, bf[1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c0[i] *= 256;
    c1[i] *= 256;
  }
  mma_u8s8(c0, lo, bf[0]);
  mma_u8s8(c1, lo, bf[1]);
  gather(c0, c1, x);
}

// sum over the quad of lanes that hold one candidate block
__device__ __forceinline__ int sum4(int v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ int ubyte(uint32_t w, int j) {
  return __byte_perm(w, 0u, 0x4440 + j);
}

__global__ void __launch_bounds__(32 * kP3Warps)
p3_fused4(const uint8_t* __restrict__ pred, const uint8_t* __restrict__ blk,
          const int8_t* __restrict__ kron, int n_blocks, P3Params p,
          int* __restrict__ q_out, int* __restrict__ sse_out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int b0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 16;
  if (b0 >= n_blocks) return;          // a whole warp past the last tile
  const int b[2] = {b0 + g, b0 + g + 8};
  const bool live[2] = {b[0] < n_blocks, b[1] < n_blocks};

  // pred and blk of coefficients 4t .. 4t+3 of both rows, a word each: as
  // they stand, the A fragments (u8) of the first forward stage
  uint32_t pw[2] = {0u, 0u}, bw[2] = {0u, 0u};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const unsigned row = p.modes == 1
        ? (unsigned)b[h] : __umulhi((unsigned)b[h], p.div_mul) >> p.div_shr;
    pw[h] = *reinterpret_cast<const uint32_t*>(pred + (size_t)b[h] * 16 +
                                               4 * t);
    bw[h] = *reinterpret_cast<const uint32_t*>(blk + (size_t)row * 16 +
                                               4 * t);
  }
  // this thread's fragments of the five permuted stage matrices (fwd 1,
  // -fwd 1, fwd 2, inv 1, inv 2), 16x16 int8 each, row-major
  uint32_t bf[5][2];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      bf[s][h] = ld_u32(kron + s * 256 + (8 * h + g) * 16 + 4 * t);

  // forward stage 1: tmp = round(M @ (blk - pred) >> a) = blk @ K^T +
  // pred @ (-K)^T, both u8; |tmp| <= 255 * 242 / 2 < 2^15
  int x[8];
  {
    int c0[4] = {0, 0, 0, 0}, c1[4] = {0, 0, 0, 0};
    mma_u8s8(c0, bw, bf[0][0]);
    mma_u8s8(c1, bw, bf[0][1]);
    mma_u8s8(c0, pw, bf[1][0]);
    mma_u8s8(c1, pw, bf[1][1]);
    gather(c0, c1, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = rnd(x[i], p.a_sft);
  }
  // forward stage 2: coef = round(tmp @ M^T >> a+7)
  stage(x, bf[2]);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = rnd(x[i], p.a_sft + 7);

  // RDOQ and the CG kill: a 4x4 block is one CG, kept iff
  // sum(min(dlevel, thr)) >= thr
  int dlevel[8];
  rdoq(x, dlevel, p, p.th[lane & 7]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int kill = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) kill += min(dlevel[4 * h + j], p.thr);
    const bool keep = sum4(kill) >= p.thr;
#pragma unroll
    for (int j = 0; j < 4; ++j) x[4 * h + j] = keep ? x[4 * h + j] : 0;
    if (live[h])
      *reinterpret_cast<int4*>(q_out + (size_t)b[h] * 16 + 4 * t) =
          make_int4(x[4 * h], x[4 * h + 1], x[4 * h + 2], x[4 * h + 3]);
  }

  // dequant: clip16(q * 2^q_sft); |q| * 2^9 < 2^24
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = clip16(x[i] * (1 << p.q_sft));
  // inverse stage 1: clip16(round(M^T @ dq >> 7))
  stage(x, bf[3]);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = clip16(rnd(x[i], 7));
  // inverse stage 2: round(tmp @ M >> 12) (its clip16 cannot change the
  // recon: |r| < 2^11 and pred is 0..255); recon; SSE
  stage(x, bf[4]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int sse = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int recon =
          min(max(rnd(x[4 * h + j], 12) + ubyte(pw[h], j), 0), 255);
      const int d = ubyte(bw[h], j) - recon;
      sse += d * d;
    }
    sse = sum4(sse);
    if (live[h] && t == 0) sse_out[b[h]] = sse;
  }
}

}  // namespace

extern "C" {

// P1: x[0 .. n) += 1 on `stream` (n < 2^31): a thread per 16-byte word
// where x is 16-byte aligned, one per element past them (all, where it is
// not), 256 threads a block (one block for the probe's (8, 128), one thread
// at one element). Returns cudaGetLastError().
int hevce_p1_add_one(void* x, int n, void* stream) {
  if (n > 0) {
    const int n4 = (uintptr_t)x % 16 == 0 ? n / 4 : 0;
    const int threads = n4 + (n - 4 * n4);
    const int per_block = threads < 256 ? threads : 256;
    p1_add_one<<<(threads + per_block - 1) / per_block, per_block, 0,
                 static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(x),
                                                      n4, n);
  }
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

// P3: the fused 4x4 eval over n_blocks (< 2^31) candidate blocks (rows of
// pred, 16 bytes each; pred and blk 4-byte aligned, q 16-byte aligned),
// `modes` blocks per original block; a block's blk row is n / modes =
// umulhi(n, div_mul) >> div_shr (modes > 1). kron: the five 16x16 int8
// stage matrices on the device (fwd 1, -fwd 1, fwd 2, inv 1, inv 2), rows
// permuted by ops/probes.py::P3_ORDER. Shifts are the 4x4 table entries
// (FWD_SHIFT_A, QUANT_LEVEL_SHIFT, DEQUANT_SHIFT); th8 (host memory) the
// qpd6's RDOQ thresholds (ops/probes.py::p3_rdoq_thresholds). Returns
// cudaGetLastError().
int hevce_p3_fused4(const void* pred, const void* blk, const void* kron,
                    int n_blocks, int modes, unsigned div_mul,
                    unsigned div_shr, int a_sft, int level_sft,
                    int dequant_sft, int qpd6, const int* th8, void* q,
                    void* sse, void* stream) {
  P3Params p;
  p.a_sft = a_sft;
  p.sft = level_sft + qpd6;
  p.add = 1 << p.sft >> 1;
  p.max_dlevel = kI32Max - p.add;
  p.thr = 9 << p.sft >> 2;
  p.q_sft = dequant_sft + qpd6;
  p.modes = modes;
  p.div_mul = div_mul;
  p.div_shr = div_shr;
  for (int i = 0; i < 8; ++i) p.th[i] = th8[i];
  const int tiles = (n_blocks + 15) / 16;
  if (n_blocks > 0)
    p3_fused4<<<(tiles + kP3Warps - 1) / kP3Warps, 32 * kP3Warps, 0,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(pred), static_cast<const uint8_t*>(blk),
        static_cast<const int8_t*>(kron), n_blocks, p, static_cast<int*>(q),
        static_cast<int*>(sse));
  return cudaGetLastError();
}

}  // extern "C"
