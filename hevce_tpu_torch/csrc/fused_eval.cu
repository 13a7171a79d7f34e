// Fused CU-candidate evaluation (kernel K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel hevce_tpu/ops/fused_eval.py::_make_kernel (launched
// through _caller). Per candidate block: residual -> forward DST/DCT
// (round(M.X >> a), round(.M^T >> a+7)) -> RDOQ (level0, -1, -2 priced by
// estimateCoeffRate and the saturating RD cost; strict <, so ties keep the
// higher level) -> per-4x4-CG kill -> dequant clip16(q * 2^(shift+qpd6)) ->
// inverse (clip16(>>7), clip16(>>12)) -> recon clip(r + pred, 0, 255) ->
// per-block SSE. Bit-identical to the plain PyTorch pipeline
// (hevce_tpu_torch/ops/fused_eval.py::pipeline_sse_plain).
//
// What bounds it. Per coefficient: four sz-deep transform sums, ~84 int32
// operations around them (rounding, clips, RDOQ's three saturating RD costs,
// the kill, dequant, recon, SSE) and ~4 bytes moved (pred u8 in, q i16 and
// recon u8 out). As int32 multiply-adds on the CUDA cores (33.5 TOP/s) the
// transforms are 8 sz operations per coefficient and bound the kernel at
// sz >= 8. As int8 products of base-128 digits on the tensor cores
// (1,979 TOP/s) they cost 2 * 11 sz operations at 1/59 of the price, so the
// epilogue's int32 operations, with the digit extraction (a shift, a mask
// and a byte store per digit), bound it; bytes come third.
//
// Design, sz 8 / 16 / 32 (k1_kernel_tc). A block of 8 warps takes 1024
// coefficients: 16 candidates at 8x8, 4 at 16x16, 1 at 32x32. Every stage is
// a product A @ B on the int8 tensor cores (mma_s8.cuh), the wide operand A
// split into base-128 digits and recombined by Horner's rule:
//   forward 1   T^T = X^T  @ M^T   A: the residual X, transposed, 2 digits
//   forward 2   C   = T    @ M^T   A: T, 3 digits
//   inverse 1   U^T = Dq^T @ M     A: the dequantised levels, transposed, 3
//   inverse 2   R   = U    @ M     A: U, 3 digits
// The left products (M @ X, M^T @ Dq) run as the transposed product, so each
// stage's output at (row i, column j) is the next stage's A at (j, i): one
// transposed store serves all four. Each warp owns one 16 x 8 tile of every
// stage's output, so each thread owns the same four coefficients (its
// accumulator fragment) from the residual to the SSE. B is M or M^T
// row-major (rows of B^T, as mma.sync reads it): each thread keeps its
// fragments of both in registers (2 or 4 words), loaded once per block from
// an int8 device buffer the wrapper uploads once per device. A lives in
// shared memory as int8 digit planes (double-buffered), written once per
// element by the thread that produced the element; row strides of 8, 16 and
// 48 bytes put both the fragment loads and the transposed byte stores on 32
// distinct banks. The epilogue runs on the fragments in registers: a CG is
// 4 rows x 4 columns of a warp's tile, so its kill sum is three xor
// shuffles; the SSE is a warp-wide shuffle sum (at 16x16 and 32x32 then one
// shared add per warp). At 8x8 a stage is only 8 deep, half of m16n8k16's
// depth: the depth is padded with zeros (the B fragment of lanes t >= 2 is
// 0 and their A fragment is not loaded). Two candidates cannot share the
// depth, since their products would add; they share the rows instead (a
// 16-row tile holds two 8x8 candidates).
//
// Design, sz 4 (k1_kernel4). The probe P3 (probes.cu) found the tensor cores
// buy nothing at 4x4: the epilogue and the barriers set its time. So the
// transforms stay int32 multiply-adds on the CUDA cores, one thread per
// coefficient, a candidate per half-warp, 16 a block; each thread holds the
// rows of M and M^T it reads in 4 registers and takes each stage's operands
// from the other lanes of its half-warp by shuffles, so the kernel has no
// shared memory and no barrier; the kill and the SSE are 16-lane shuffle
// sums (a 4x4 block is one CG). At the main path's shapes (72 to 630
// blocks, one wave) its time is one block's latency and the launch.
//
// Exactness. Every sum stays inside int32:
//   forward stage 1: |sum| <= 255 * 90 * 32 < 2^20
//   forward stage 2: |T| < 2^17, |sum| < 2^17 * 90 * 32 < 2^29
//   inverse stages:  |sum| <= 32768 * 90 * 32 < 2^27
//   SSE:             <= 255^2 * 1024 < 2^26
//   CG sums:         <= 16 * thr < 2^29
// and each Horner partial is the product of a right-shifted operand, so it
// stays inside its stage's bound. Digits: the residual (|r| <= 255) has a top
// digit r >> 7 in [-2, 1]; T (< 2^17) one in [-8, 7]; the levels and U
// (clip16) one in [-2, 1]; the low digits are 0..127: all fit s8. The 6
// entries of the level-rate table are kernel parameters, picked by selects,
// and the RD cost's saturation limits I32_MAX / wd and / wb are computed
// once on the host; no __constant__ arrays, no per-coefficient atomics.
// Negative levels are scaled by multiplication (never a left shift of a
// negative int); every >> on a signed int is arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

#include "mma_s8.cuh"

namespace {

constexpr int kI32Max = 0x7FFFFFFF;
constexpr int kThreads = 256;

struct K1Params {
  int a_sft, b_sft, dist_sft, sft, add, max_dlevel, thr, q_sft, wd, wb;
  int lim_d, lim_b;                    // I32_MAX / wd, I32_MAX / wb
  int lvl[6];
};

__host__ __device__ constexpr int cands_per_block(int sz) {
  return sz == 4 ? kThreads / 16 : 1024 / (sz * sz);
}

__device__ __forceinline__ int rnd(int x, int s) {
  return (x + (1 << s >> 1)) >> s;
}

__device__ __forceinline__ int clip16(int x) {
  return min(max(x, -32768), 32767);
}

// byte k of w as a signed int
__device__ __forceinline__ int sbyte(uint32_t w, int k) {
  return static_cast<int8_t>(w >> (8 * k));
}

// estimateCoeffRate (reference src/HEVCe.c:526-535); lv >= 0
__device__ __forceinline__ int rate_of(int lv, const K1Params& p) {
  if (lv >= 6) return 92000 + ((4 + 2 * (31 - __clz(lv - 5))) << 15);
  int r = p.lvl[5];
  r = lv == 4 ? p.lvl[4] : r;
  r = lv == 3 ? p.lvl[3] : r;
  r = lv == 2 ? p.lvl[2] : r;
  r = lv == 1 ? p.lvl[1] : r;
  return lv == 0 ? p.lvl[0] : r;
}

// saturating RD cost of level lv (0 <= lv <= I32_MAX >> sft)
__device__ __forceinline__ int cost_of(int dlevel, int lv, const K1Params& p) {
  const int d1 = abs(dlevel - (lv << p.sft)) >> p.dist_sft;
  const int dist = (d1 < 46340 ? d1 * d1 : kI32Max) >> 7;
  const int r = rate_of(lv, p);
  const int c1 = (p.lim_d <= dist) ? kI32Max : p.wd * dist;
  const int c2 = (p.lim_b <= r) ? kI32Max : p.wb * r;
  return (kI32Max - c1 <= c2) ? kI32Max : c1 + c2;
}

// RDOQ of one coefficient (reference src/HEVCe.c:526-592): the signed level,
// and its dlevel for the CG kill
__device__ __forceinline__ int rdoq(int coef, const K1Params& p, int& dlevel) {
  const int absval = abs(coef);
  dlevel = absval > 0x1FFFF ? p.max_dlevel
                            : min((absval & 0x1FFFF) << 14, p.max_dlevel);
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
  return coef < 0 ? -best_l : best_l;
}

// sum over the 16 lanes of one half-warp
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int sum32(int v) {
  return sum16(v + __shfl_xor_sync(0xffffffffu, v, 16));
}

// ------------------------------------------------------------- sz = 4

__global__ void __launch_bounds__(kThreads)
k1_kernel4(const uint8_t* __restrict__ pred, const uint8_t* __restrict__ blk,
           const int8_t* __restrict__ mats, int n_cand, int m_per_blk,
           K1Params p, int16_t* __restrict__ q_out,
           uint8_t* __restrict__ rec_out, int* __restrict__ sse_out) {
  constexpr int SZ = 4, NN = 16, CPB = cands_per_block(SZ);
  constexpr unsigned kAll = 0xffffffffu;

  // a half-warp holds one candidate, lane hb + 4i + j its coefficient (i, j)
  const int lane = threadIdx.x & 31, hb = lane & 16;
  const int e = lane & 15, i = e / SZ, j = e % SZ;
  const int c = blockIdx.x * CPB + threadIdx.x / NN;
  const bool live = c < n_cand;
  // rows i and j of M (mats[0..15]) and of M^T (mats[16..31])
  const uint32_t mi = ld_u32(mats + 4 * i), mj = ld_u32(mats + 4 * j);
  const uint32_t ti = ld_u32(mats + NN + 4 * i);
  const uint32_t tj = ld_u32(mats + NN + 4 * j);
  // x[k][j] and x[i][l] of a stage's input x, read from the lanes holding them
  const auto col = [&](int v, int k) {
    return __shfl_sync(kAll, v, hb + 4 * k + j);
  };
  const auto row = [&](int v, int l) {
    return __shfl_sync(kAll, v, hb + 4 * i + l);
  };

  int pv = 0, bv = 0;
  if (live) {
    pv = pred[(long long)c * NN + e];
    bv = blk[(long long)(c / m_per_blk) * NN + e];
  }
  const int x = bv - pv;

  // forward stage 1: tmp = round(M @ X >> a)
  int acc = 0;
#pragma unroll
  for (int k = 0; k < SZ; ++k) acc += sbyte(mi, k) * col(x, k);
  const int tmp = rnd(acc, p.a_sft);

  // forward stage 2: coef = round(tmp @ M^T >> a+7)
  acc = 0;
#pragma unroll
  for (int l = 0; l < SZ; ++l) acc += row(tmp, l) * sbyte(mj, l);
  int dlevel;
  const int signed_l = rdoq(rnd(acc, p.b_sft), p, dlevel);
  // the CG kill: a 4x4 block is one CG, kept iff sum(min(dlevel, thr)) >= thr
  const int qv = sum16(min(dlevel, p.thr)) >= p.thr ? signed_l : 0;
  if (live) q_out[(long long)c * NN + e] = (int16_t)qv;

  // dequant: clip16(q * 2^q_sft); |q| * 2^9 < 2^24
  const int dq = clip16(qv * (1 << p.q_sft));

  // inverse stage 1: u = clip16(round(M^T @ dq >> 7)); M[k][i] = M^T[i][k]
  acc = 0;
#pragma unroll
  for (int k = 0; k < SZ; ++k) acc += sbyte(ti, k) * col(dq, k);
  const int u = clip16(rnd(acc, 7));

  // inverse stage 2: r = clip16(round(u @ M >> 12)); M[l][j] = M^T[j][l]
  acc = 0;
#pragma unroll
  for (int l = 0; l < SZ; ++l) acc += row(u, l) * sbyte(tj, l);
  const int recon = min(max(clip16(rnd(acc, 12)) + pv, 0), 255);
  if (live) rec_out[(long long)c * NN + e] = (uint8_t)recon;
  const int d = bv - recon;
  const int sse = sum16(d * d);
  if (live && e == 0) sse_out[c] = sse;
}

// ------------------------------------------------------- sz = 8, 16, 32

template <int SZ>
struct Tc {
  static constexpr int NN = SZ * SZ;
  static constexpr int CPB = cands_per_block(SZ);   // 16, 4, 1
  static constexpr int ROWS = CPB * SZ;             // candidates stacked
  static constexpr int SB = SZ == 32 ? 48 : SZ;     // bytes a plane row
  static constexpr int PLANE = ROWS * SB;
  static constexpr int KS = SZ == 8 ? 1 : SZ / 16;  // 16-deep steps
  static constexpr int NT = SZ / 8;                 // 8-wide tiles a row
  static_assert((ROWS / 16) * NT * 32 == kThreads, "8 warps, 1 tile each");
};

// Store this thread's four stage outputs v, at stacked rows r = R0 + g + 8h
// (candidate r / SZ, row lr = r % SZ) and columns n = n0 + 2t + e, as NDIG
// digit planes of the next stage's A, transposed: plane row
// (r - lr + n), byte lr.
template <int SZ, int NDIG>
__device__ __forceinline__ void put_t(int8_t* planes, int R0, int n0, int g,
                                      int t, const int (&v)[4]) {
  using K = Tc<SZ>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = R0 + g + 8 * h, lr = r % SZ;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      int8_t* dst = planes + (r - lr + n0 + 2 * t + e) * K::SB + lr;
      const int x = v[2 * h + e];
      dst[(NDIG - 1) * K::PLANE] = digit<true>(x, NDIG - 1);
#pragma unroll
      for (int k = 0; k < NDIG - 1; ++k) dst[k * K::PLANE] = digit<false>(x, k);
    }
  }
}

// One stage on this warp's 16 x 8 tile: acc = A @ B with A the NDIG digit
// planes (rows R0 .. R0+15) recombined by Horner's rule, top digit first.
template <int SZ, int NDIG>
__device__ __forceinline__ void stage(const int8_t* planes,
                                      const uint32_t (&b)[Tc<SZ>::KS],
                                      int R0, int g, int t, int (&acc)[4]) {
  using K = Tc<SZ>;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0;
#pragma unroll
  for (int k = NDIG - 1; k >= 0; --k) {
    if (k < NDIG - 1) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] *= 128;
    }
#pragma unroll
    for (int ks = 0; ks < K::KS; ++ks) {
      uint32_t a[2] = {0u, 0u};
      if (SZ > 8 || t < 2) {
        const int8_t* p = planes + k * K::PLANE + (R0 + g) * K::SB
                          + 16 * ks + 4 * t;
        a[0] = ld_u32(p);
        a[1] = ld_u32(p + 8 * K::SB);
      }
      mma_s8(acc, a, b[ks]);
    }
  }
}

template <int SZ>
__global__ void __launch_bounds__(kThreads)
k1_kernel_tc(const uint8_t* __restrict__ pred, const uint8_t* __restrict__ blk,
             const int8_t* __restrict__ mats, int n_cand, int m_per_blk,
             K1Params p, int16_t* __restrict__ q_out,
             uint8_t* __restrict__ rec_out, int* __restrict__ sse_out) {
  using K = Tc<SZ>;
  constexpr int NN = K::NN, CPB = K::CPB;
  __shared__ __align__(16) int8_t P[2][3 * K::PLANE];
  __shared__ int S[CPB];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int R0 = (warp / K::NT) * 16, n0 = (warp % K::NT) * 8;
  const int col = n0 + 2 * t;

  // B fragments for column n0 + g: rows of M (forward) and of M^T (inverse),
  // bytes 16 ks + 4t .. +3; at 8x8 lanes t >= 2 hold the zero padding
  uint32_t bf[K::KS], bi[K::KS];
#pragma unroll
  for (int ks = 0; ks < K::KS; ++ks) {
    const bool pad = SZ == 8 && t >= 2;
    const int off = (n0 + g) * SZ + 16 * ks + 4 * t;
    bf[ks] = pad ? 0u : ld_u32(mats + off);
    bi[ks] = pad ? 0u : ld_u32(mats + NN + off);
  }

  // this thread's four coefficients: rows R0 + g + 8h, columns col + e
  int cand[2], lr[2], pv[4], bv[4];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = R0 + g + 8 * h;
    lr[h] = r % SZ;
    cand[h] = blockIdx.x * CPB + r / SZ;
    live[h] = cand[h] < n_cand;
    const long long pe = (long long)cand[h] * NN + lr[h] * SZ + col;
    const long long be = (long long)(cand[h] / m_per_blk) * NN + lr[h] * SZ
                         + col;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      pv[2 * h + e] = live[h] ? pred[pe + e] : 0;
      bv[2 * h + e] = live[h] ? blk[be + e] : 0;
    }
  }
  if (threadIdx.x < CPB) S[threadIdx.x] = 0;

  int v[4], acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = bv[i] - pv[i];
  put_t<SZ, 2>(P[0], R0, n0, g, t, v);
  __syncthreads();

  // forward stage 1: T = round(M @ X >> a), as T^T = X^T @ M^T
  stage<SZ, 2>(P[0], bf, R0, g, t, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = rnd(acc[i], p.a_sft);
  put_t<SZ, 3>(P[1], R0, n0, g, t, v);
  __syncthreads();

  // forward stage 2: coef = round(T @ M^T >> a+7); RDOQ; the CG kill: a CG
  // (rows g & ~3 .. +3, columns col & ~3 .. +3) spans lanes differing in
  // bits 0, 2 and 3, and is kept iff sum(min(dlevel, thr)) >= thr
  stage<SZ, 3>(P[1], bf, R0, g, t, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int dl[2], sl[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) sl[e] = rdoq(rnd(acc[2 * h + e], p.b_sft), p,
                                             dl[e]);
    int s = min(dl[0], p.thr) + min(dl[1], p.thr);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    const int q0 = s >= p.thr ? sl[0] : 0, q1 = s >= p.thr ? sl[1] : 0;
    if (live[h])
      *reinterpret_cast<uint32_t*>(
          q_out + (long long)cand[h] * NN + lr[h] * SZ + col) =
          (uint32_t)(uint16_t)q0 | ((uint32_t)(uint16_t)q1 << 16);
    // dequant: clip16(q * 2^q_sft); |q| * 2^9 < 2^24
    v[2 * h] = clip16(q0 * (1 << p.q_sft));
    v[2 * h + 1] = clip16(q1 * (1 << p.q_sft));
  }
  put_t<SZ, 3>(P[0], R0, n0, g, t, v);
  __syncthreads();

  // inverse stage 1: U = clip16(round(M^T @ Dq >> 7)), as U^T = Dq^T @ M
  stage<SZ, 3>(P[0], bi, R0, g, t, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = clip16(rnd(acc[i], 7));
  put_t<SZ, 3>(P[1], R0, n0, g, t, v);
  __syncthreads();

  // inverse stage 2: r = clip16(round(U @ M >> 12)); recon; SSE
  stage<SZ, 3>(P[1], bi, R0, g, t, acc);
  int sse[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int rec[2];
    sse[h] = 0;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rec[e] = min(max(clip16(rnd(acc[2 * h + e], 12)) + pv[2 * h + e], 0),
                   255);
      const int d = bv[2 * h + e] - rec[e];
      sse[h] += d * d;
    }
    if (live[h])
      *reinterpret_cast<uint16_t*>(
          rec_out + (long long)cand[h] * NN + lr[h] * SZ + col) =
          (uint16_t)(rec[0] | (rec[1] << 8));
  }
  if constexpr (SZ == 8) {
    // a warp holds two whole candidates, one per half of its tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = sum32(sse[h]);
      if (lane == 0 && live[h]) sse_out[cand[h]] = s;
    }
  } else {
    const int s = sum32(sse[0] + sse[1]);
    if (lane == 0) atomicAdd(&S[R0 / SZ], s);
    __syncthreads();
    const int c = blockIdx.x * CPB + threadIdx.x;
    if (threadIdx.x < CPB && c < n_cand) sse_out[c] = S[threadIdx.x];
  }
}

template <int SZ>
cudaError_t launch(const void* pred, const void* blk, const void* mats,
                   int n_cand, int m_per_blk, const K1Params& p, void* q,
                   void* rec, void* sse, cudaStream_t stream) {
  constexpr int CPB = cands_per_block(SZ);
  const unsigned blocks = (unsigned)((n_cand + CPB - 1) / CPB);
  void (*kernel)(const uint8_t*, const uint8_t*, const int8_t*, int, int,
                 K1Params, int16_t*, uint8_t*, int*);
  if constexpr (SZ == 4) kernel = k1_kernel4;
  else kernel = k1_kernel_tc<SZ>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(pred), static_cast<const uint8_t*>(blk),
      static_cast<const int8_t*>(mats), n_cand, m_per_blk, p,
      static_cast<int16_t*>(q), static_cast<uint8_t*>(rec),
      static_cast<int*>(sse));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch K1 on `stream` over n_cand candidates (rows of pred), m_per_blk
// candidates per original block. mats: M then M^T, row-major int8 (2 sz^2
// bytes, on the device). Shift arguments are the per-size table entries
// (FWD_SHIFT_A, QUANT_DIST_SHIFT, QUANT_LEVEL_SHIFT, DEQUANT_SHIFT); wd / wb
// the qpd6's RD-cost weights; lvl6 (host memory) the first 6 entries of
// LEVEL_RATE_TABLE. Returns cudaGetLastError().
int hevce_k1_launch(int sz, const void* pred, const void* blk,
                    const void* mats, int n_cand, int m_per_blk, int a_sft,
                    int dist_sft, int level_sft, int dequant_sft, int qpd6,
                    int wd, int wb, const int* lvl6, void* q, void* rec,
                    void* sse, void* stream) {
  K1Params p;
  p.a_sft = a_sft;
  p.b_sft = a_sft + 7;
  p.dist_sft = dist_sft;
  p.sft = level_sft + qpd6;
  p.add = 1 << p.sft >> 1;
  p.max_dlevel = kI32Max - p.add;
  p.thr = 9 << p.sft >> 2;
  p.q_sft = dequant_sft + qpd6;
  p.wd = wd;
  p.wb = wb;
  p.lim_d = kI32Max / wd;
  p.lim_b = kI32Max / wb;
  for (int i = 0; i < 6; ++i) p.lvl[i] = lvl6[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sz) {
    case 4: return launch<4>(pred, blk, mats, n_cand, m_per_blk, p, q, rec, sse, s);
    case 8: return launch<8>(pred, blk, mats, n_cand, m_per_blk, p, q, rec, sse, s);
    case 16: return launch<16>(pred, blk, mats, n_cand, m_per_blk, p, q, rec, sse, s);
    case 32: return launch<32>(pred, blk, mats, n_cand, m_per_blk, p, q, rec, sse, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
