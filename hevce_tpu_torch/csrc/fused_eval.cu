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
// Design. One thread per coefficient; CPB candidates per thread block
// (16 at 4x4, 4 at 8x8, 1 at 16x16 and 32x32), so a block holds 256 threads
// (1024 at 32x32). The residual and every stage output stay in shared
// memory; the transform matrices sit in __constant__ memory. The original
// block is read at row / M (no broadcast copy in device memory). The TPU
// kernel's G-packing and Kronecker flat operators were 128-lane layout
// devices, and its base-128 digit split existed only for the int8 MXU:
// plain int32 multiply-accumulate is exact here, because
//   forward stage 1: |sum| <= 510 * 90 * 32 < 2^21
//   forward stage 2: |sum| <  2^18 * 90 * 32 < 2^30
//   inverse stages:  |sum| <= 32767 * 90 * 32 < 2^27
//   SSE:             <= 255^2 * 1024 < 2^26
//   CG sums:         <= 16 * thr < 2^29
// Negative levels are scaled by multiplication (never a left shift of a
// negative int); every >> on a signed int is arithmetic.
//
// What bounds it. Per candidate about 4 * sz * sz^2 int32 multiply-adds
// (four sz x sz x sz matrix stages, 2 ops each) against about 4 * sz^2
// bytes moved (pred u8 in, q i16 + recon u8 out): ~2 * sz ops per byte.
// The H100's int32 ridge is ~10 ops per byte (33.5 TOP/s on the CUDA
// cores' int32 lanes over 3.35 TB/s of HBM), so sz = 4 is bound by bytes
// and sz >= 8 by the integer ALU rate. This first version is simple and
// correct, not fast: each stage loops over sz with shared-memory operands,
// and the forward and inverse second stages read the matrix from constant
// memory at addresses that differ across a warp, which serializes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kI32Max = 0x7FFFFFFF;

__constant__ int c_mat4[16];
__constant__ int c_mat8[64];
__constant__ int c_mat16[256];
__constant__ int c_mat32[1024];
__constant__ int c_lvl[6];

struct K1Params {
  int a_sft, b_sft, dist_sft, sft, add, max_dlevel, thr, q_sft, wd, wb;
};

__host__ __device__ constexpr int cands_per_block(int sz) {
  return sz * sz >= 256 ? 1 : 256 / (sz * sz);
}

template <int SZ>
__device__ __forceinline__ int mat(int r, int c) {
  if constexpr (SZ == 4) return c_mat4[r * 4 + c];
  else if constexpr (SZ == 8) return c_mat8[r * 8 + c];
  else if constexpr (SZ == 16) return c_mat16[r * 16 + c];
  else return c_mat32[r * 32 + c];
}

__device__ __forceinline__ int rnd(int x, int s) {
  return (x + (1 << s >> 1)) >> s;
}

__device__ __forceinline__ int clip16(int x) {
  return min(max(x, -32768), 32767);
}

// estimateCoeffRate (reference src/HEVCe.c:526-535); lv >= 0
__device__ __forceinline__ int rate_of(int lv) {
  if (lv < 6) return c_lvl[lv];
  const int i = 31 - __clz(lv - 5);  // floor(log2(lv - 5))
  return 92000 + ((4 + 2 * i) << 15);
}

// saturating RD cost of level lv (0 <= lv <= I32_MAX >> sft)
__device__ __forceinline__ int cost_of(int dlevel, int lv, const K1Params& p) {
  const int d1 = abs(dlevel - (lv << p.sft)) >> p.dist_sft;
  const int dist = (d1 < 46340 ? d1 * d1 : kI32Max) >> 7;
  const int r = rate_of(lv);
  const int c1 = (kI32Max / p.wd <= dist) ? kI32Max : p.wd * dist;
  const int c2 = (kI32Max / p.wb <= r) ? kI32Max : p.wb * r;
  return (kI32Max - c1 <= c2) ? kI32Max : c1 + c2;
}

template <int SZ>
__global__ void __launch_bounds__(SZ * SZ * cands_per_block(SZ))
k1_kernel(const uint8_t* __restrict__ pred, const uint8_t* __restrict__ blk,
          long long n_cand, int m_per_blk, K1Params p,
          int16_t* __restrict__ q_out, uint8_t* __restrict__ rec_out,
          int* __restrict__ sse_out) {
  constexpr int NN = SZ * SZ;
  constexpr int CPB = cands_per_block(SZ);
  __shared__ int X[CPB * NN];
  __shared__ int T[CPB * NN];
  __shared__ int S[CPB];

  const int local = threadIdx.x / NN;
  const int e = threadIdx.x % NN;
  const int i = e / SZ, j = e % SZ;
  const long long c = (long long)blockIdx.x * CPB + local;
  const bool live = c < n_cand;
  int* x = X + local * NN;
  int* t = T + local * NN;

  int pv = 0, bv = 0;
  if (live) {
    pv = pred[c * NN + e];
    bv = blk[(c / m_per_blk) * NN + e];
  }
  if (e == 0) S[local] = 0;
  x[e] = bv - pv;
  __syncthreads();

  // forward stage 1: tmp = round(M @ X >> a)
  int acc = 0;
#pragma unroll 8
  for (int k = 0; k < SZ; ++k) acc += mat<SZ>(i, k) * x[k * SZ + j];
  t[e] = rnd(acc, p.a_sft);
  __syncthreads();

  // forward stage 2: coef = round(tmp @ M^T >> a+7)
  acc = 0;
#pragma unroll 8
  for (int l = 0; l < SZ; ++l) acc += t[i * SZ + l] * mat<SZ>(j, l);
  const int coef = rnd(acc, p.b_sft);

  // RDOQ (reference src/HEVCe.c:526-592)
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

  // per-4x4-CG kill: keep the CG iff sum(min(dlevel, thr)) >= thr.
  // X is free: stage 1 finished reading it before the last barrier.
  x[e] = min(dlevel, p.thr);
  __syncthreads();
  int cg = 0;
  const int ci = i & ~3, cj = j & ~3;
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) cg += x[(ci + u) * SZ + cj + v];
  const int qv = cg >= p.thr ? signed_l : 0;
  if (live) q_out[c * NN + e] = (int16_t)qv;
  __syncthreads();

  // dequant: clip16(q * 2^q_sft); |q| * 2^9 < 2^24
  x[e] = clip16(qv * (1 << p.q_sft));
  __syncthreads();

  // inverse stage 1: tmp = clip16(round(M^T @ dq >> 7))
  acc = 0;
#pragma unroll 8
  for (int k = 0; k < SZ; ++k) acc += mat<SZ>(k, i) * x[k * SZ + j];
  t[e] = clip16(rnd(acc, 7));
  __syncthreads();

  // inverse stage 2: r = clip16(round(tmp @ M >> 12)); recon; SSE
  acc = 0;
#pragma unroll 8
  for (int l = 0; l < SZ; ++l) acc += t[i * SZ + l] * mat<SZ>(l, j);
  const int recon = min(max(clip16(rnd(acc, 12)) + pv, 0), 255);
  if (live) rec_out[c * NN + e] = (uint8_t)recon;
  const int d = bv - recon;
  atomicAdd(&S[local], d * d);
  __syncthreads();
  if (live && e == 0) sse_out[c] = S[local];
}

template <int SZ>
cudaError_t launch(const void* pred, const void* blk, long long n_cand,
                   int m_per_blk, const K1Params& p, void* q, void* rec,
                   void* sse, cudaStream_t stream) {
  constexpr int CPB = cands_per_block(SZ);
  const long long blocks = (n_cand + CPB - 1) / CPB;
  k1_kernel<SZ><<<(unsigned)blocks, SZ * SZ * CPB, 0, stream>>>(
      static_cast<const uint8_t*>(pred), static_cast<const uint8_t*>(blk),
      n_cand, m_per_blk, p, static_cast<int16_t*>(q),
      static_cast<uint8_t*>(rec), static_cast<int*>(sse));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Upload the transform matrices and the 6-entry level-rate table to the
// current device's constant memory. Returns a cudaError_t.
int hevce_k1_init(const int* m4, const int* m8, const int* m16,
                  const int* m32, const int* lvl6) {
  cudaError_t err;
  if ((err = cudaMemcpyToSymbol(c_mat4, m4, 16 * sizeof(int)))) return err;
  if ((err = cudaMemcpyToSymbol(c_mat8, m8, 64 * sizeof(int)))) return err;
  if ((err = cudaMemcpyToSymbol(c_mat16, m16, 256 * sizeof(int)))) return err;
  if ((err = cudaMemcpyToSymbol(c_mat32, m32, 1024 * sizeof(int)))) return err;
  if ((err = cudaMemcpyToSymbol(c_lvl, lvl6, 6 * sizeof(int)))) return err;
  return cudaSuccess;
}

// Launch K1 on `stream` over n_cand candidates (rows of pred), m_per_blk
// candidates per original block. Shift arguments are the per-size table
// entries (FWD_SHIFT_A, QUANT_DIST_SHIFT, QUANT_LEVEL_SHIFT, DEQUANT_SHIFT);
// wd / wb are the qpd6's RD-cost weights. Returns cudaGetLastError().
int hevce_k1_launch(int sz, const void* pred, const void* blk,
                    long long n_cand, int m_per_blk, int a_sft, int dist_sft,
                    int level_sft, int dequant_sft, int qpd6, int wd, int wb,
                    void* q, void* rec, void* sse, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (sz) {
    case 4: return launch<4>(pred, blk, n_cand, m_per_blk, p, q, rec, sse, s);
    case 8: return launch<8>(pred, blk, n_cand, m_per_blk, p, q, rec, sse, s);
    case 16: return launch<16>(pred, blk, n_cand, m_per_blk, p, q, rec, sse, s);
    case 32: return launch<32>(pred, blk, n_cand, m_per_blk, p, q, rec, sse, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
