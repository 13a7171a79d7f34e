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
//   out = a @ b, a (M, K) int8, b (K, N) int8 -> (M, N) int32, exact. At the
//   probe's shape (512, 64) x (64, 64) it moves 167,936 B (50 ns) for 4.2 M
//   operations (2 ns on the int8 tensor cores): bound by bytes, and at this
//   size by the launch. Design: the product runs on the tensor cores with
//   mma.sync m16n8k16 s8 x s8 -> s32 (no .satfinite: |sum| <= K * 2^14 stays
//   far inside int32). A block of 4 warps stages a 64-row tile of A
//   row-major and a 64-column tile of B transposed ("col") in shared memory,
//   64 of K at a time, zero-filled past M, N and K; each warp owns 16 rows
//   and all 64 columns (8 accumulator fragments).
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

namespace {

constexpr int kI32Max = 0x7FFFFFFF;

// ------------------------------------------------------------------ P1

__global__ void p1_add_one(int* __restrict__ x, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] += 1;
}

// ------------------------------------------------- int8 mma fragments
//
// D = A * B + D on one warp: A 16x16 s8 (row), B 16x8 s8 (col), D 16x8 s32.
// Fragments (PTX ISA, mma.m16n8k16 with .s8 operands), g = lane >> 2,
// t = lane & 3, four bytes packed in a register with the lowest k lowest:
//   a[0] = A[g][4t .. 4t+3]        a[1] = A[g+8][4t .. 4t+3]
//   b    = B[4t .. 4t+3][g]        (= row g of B^T, four bytes)
//   d[0], d[1] = D[g][2t], D[g][2t+1]    d[2], d[3] = D[g+8][2t], D[g+8][2t+1]

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[2],
                                       uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ------------------------------------------------------------------ P2

constexpr int P2_TILE = 64;           // rows, columns and depth of a tile
constexpr int P2_STRIDE = P2_TILE + 16;  // bytes a shared row: 20 words,
                                         // so a fragment load hits 32 banks

__global__ void __launch_bounds__(128)
p2_int8_mm(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
           int* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) int8_t As[P2_TILE][P2_STRIDE];
  __shared__ __align__(16) int8_t Bt[P2_TILE][P2_STRIDE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * P2_TILE, n0 = blockIdx.y * P2_TILE;
  int acc[8][4] = {};

  for (int k0 = 0; k0 < K; k0 += P2_TILE) {
    for (int i = threadIdx.x; i < P2_TILE * P2_TILE; i += blockDim.x) {
      const int r = i / P2_TILE, c = i % P2_TILE;
      const int m = m0 + r, k = k0 + c;
      As[r][c] = (m < M && k < K) ? a[(long long)m * K + k] : 0;
    }
    for (int i = threadIdx.x; i < P2_TILE * P2_TILE; i += blockDim.x) {
      const int r = i / P2_TILE, c = i % P2_TILE;     // r: k, c: n
      const int k = k0 + r, n = n0 + c;
      Bt[c][r] = (k < K && n < N) ? b[(long long)k * N + n] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < P2_TILE; kk += 16) {
      const uint32_t af[2] = {ld_u32(&As[warp * 16 + g][kk + 4 * t]),
                              ld_u32(&As[warp * 16 + g + 8][kk + 4 * t])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_s8(acc[nt], af, ld_u32(&Bt[nt * 8 + g][kk + 4 * t]));
    }
    __syncthreads();
  }

  const int r0 = m0 + warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= M) continue;
      if (n < N) out[(long long)r * N + n] = acc[nt][2 * h];
      if (n + 1 < N) out[(long long)r * N + n + 1] = acc[nt][2 * h + 1];
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

// four base-128 digits k of v[0..3] packed as s8: low digits unsigned
// (0..127), the top digit signed
template <bool TOP>
__device__ __forceinline__ uint32_t digits(const int4 v, int k) {
  const int s = 7 * k;
  const int d[4] = {v.x >> s, v.y >> s, v.z >> s, v.w >> s};
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((TOP ? d[i] : d[i] & 127) & 0xFF) << (8 * i);
  return r;
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
// contiguous, on `stream`. Returns cudaGetLastError().
int hevce_p2_int8_mm(const void* a, const void* b, void* out, int M, int K,
                     int N, void* stream) {
  const dim3 grid((M + P2_TILE - 1) / P2_TILE, (N + P2_TILE - 1) / P2_TILE);
  if (M > 0 && N > 0)
    p2_int8_mm<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
        static_cast<int*>(out), M, K, N);
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
