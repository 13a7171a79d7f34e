// Fused node kernels X1-X4 for Hopper (sm_90a).
//
// They stand for XLA's fusions of the JAX package's front step
// (hevce_tpu/models/wavefront.py, hevce_tpu/models/cu_eval.py): no Pallas
// kernel is ported here. Each is bit-identical to its plain PyTorch version
// in hevce_tpu_torch/ops/fused_node.py, the op chain it replaces:
//
//   X1 x1_predict_kernel     intra.build_borders + predict_all_modes, or a
//                            TU split's sub-TU: its border from the node's
//                            context and each lane's own canvas, the lane's
//                            one mode (cu_eval.eval_2nx2n / eval_tusplit).
//                            One block per (row, lane).
//   X2 x2_preselect_kernel   the RMD node's front half: 35 predictions from
//                            one border, the residuals' Hadamard SATD, the
//                            forced planar / DC / MPMs, the top K (a rank
//                            count), the K kept predictions. One block per
//                            row.
//   X3 x3_rate_cost_kernel   per candidate: estimateCoeffRate summed, the
//                            last-XY + significance-map estimate at the
//                            candidate's scan type, the pmode rate, header
//                            bins, (r + 2^14) >> 15 and the saturating RD
//                            cost. One warp per candidate.
//   X4 x4_pick_kernel        a node's or NxN PU's winner: the first
//                            minimum over one or two candidate sets, its
//                            layout and mode, its levels and recon copied
//                            out (a PU's recon into the leaf's canvas), a
//                            PU's saturating running total. One warp per
//                            row.
//
// What bounds them. Each does a few int32 operations per byte it moves:
// X1 writes a byte per predicted pixel after ~10 operations; X2 reads a
// byte of the original and does ~2 log2(sz) + 12 per pixel and mode
// (prediction, two butterfly passes, |.|, the sum) for 35 modes, then
// writes K of them; X3 reads two bytes of levels for ~20 operations; X4
// moves the winner's 3 bytes a pixel and does nothing else. So
// at the front step's shapes the bytes bound them on paper, and what sets
// their time is latency: small grids (one block per row or candidate), the
// barriers between X1's and X2's border steps and X2's butterfly stages.
// The design is the simple one: a block per row or candidate, threads over
// pixels and modes, int32 throughout, the constant tables (the angular
// taps, the scan tables) read from device buffers the wrapper uploads once
// per device. Making them fast (several lanes a block, the butterflies in
// registers) is later work.
//
// Exactness. Predictions are the integer two-tap rule ((32 - f) a + f b +
// 16) >> 5 on the border (the plain version's float32 product is exact
// because its sums stay below 2^24); at f = 0 the second tap, which may
// lie one past its border segment, is not read. SATD: |stage 2| <= 255 *
// 32^2 and the sum <= 2^28. Rates wrap as the plain version's int32 sums
// do (unsigned arithmetic); every >> on a signed int is arithmetic.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kI32Max = 0x7FFFFFFF;
constexpr int kModes = 35;
constexpr int kBit = 1 << 15;
constexpr int kHalf = 1 << 14;
constexpr int kMaxS = 2 + 8 * 32;        // the border vector at sz 32
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// a (rows, n) view: element (r, i) at p[r * rs + i * es]
struct View {
  const void* p;
  long long rs, es;
};

template <typename T>
__device__ __forceinline__ int at(const View& v, int r, int i) {
  return (int)static_cast<const T*>(v.p)[r * v.rs + i * v.es];
}

// The neighbours of the block being predicted: the whole node (isub < 0,
// n = sz) or sub-TU isub of its TU split (n = sz / 2), whose borders read
// the lane's canvas cv (sz x sz, the sub-TUs before it) where the node's
// context does not reach (cu_eval.eval_tusplit's assembly). Reads only
// what the flags let through: a sub-TU's masked half may lie past the
// canvas.
template <typename T>
struct Nb {
  View top, left;
  int r, sz, isub;
  const uint8_t* cv;

  __device__ int left2(int i) const {
    const int h = sz >> 1;
    switch (isub) {
      case 1: return cv[i * sz + h - 1];
      case 2: return at<T>(left, r, h + i);
      case 3: return cv[(h + i) * sz + h - 1];
      default: return at<T>(left, r, i);
    }
  }
  __device__ int top2(int i) const {
    const int h = sz >> 1;
    switch (isub) {
      case 1: return at<T>(top, r, 1 + h + i);
      case 2: return cv[(h - 1) * sz + i];
      case 3: return cv[(h - 1) * sz + h + i];
      default: return at<T>(top, r, 1 + i);
    }
  }
  __device__ int corner() const {
    const int h = sz >> 1;
    switch (isub) {
      case 1: return at<T>(top, r, h);
      case 2: return at<T>(left, r, h - 1);
      case 3: return cv[(h - 1) * sz + h - 1];
      default: return at<T>(top, r, 0);
    }
  }
};

// the four flags (bll, blb, baa, bar) of the block: the node's, or the
// reference's sub-block tables (src/HEVCe.c:1376-1379)
__device__ __forceinline__ void block_flags(const View& flags, int r,
                                            int isub, bool f[4]) {
  bool g[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = at<uint8_t>(flags, r, k) != 0;
  switch (isub) {
    case 0: f[0] = g[0]; f[1] = g[0]; f[2] = g[2]; f[3] = g[2]; break;
    case 1: f[0] = true; f[1] = false; f[2] = g[2]; f[3] = g[3]; break;
    case 2: f[0] = g[0]; f[1] = g[1]; f[2] = true; f[3] = true; break;
    case 3: f[0] = true; f[1] = false; f[2] = true; f[3] = false; break;
    default: f[0] = g[0]; f[1] = g[1]; f[2] = g[2]; f[3] = g[3];
  }
}

// Builds the border vector S = [ubla | ublb (2n) | ubar (2n) | fbla | fblb
// (2n) | fbar (2n)] of intra.build_borders in shared memory, and the DC
// value *dc. Every thread of the block takes part; ends on a barrier.
template <typename T>
__device__ void build_border(const Nb<T>& nb, const View& flags, int n,
                             int* S, int* dc) {
  bool f[4];
  block_flags(flags, nb.r, nb.isub, f);
  const bool bll = f[0], blb = f[1], baa = f[2], bar = f[3];
  const int ubla = (bll && baa) ? nb.corner()
                   : bll        ? nb.left2(0)
                   : baa        ? nb.top2(0)
                                : 128;
  const int n2 = 2 * n;
  for (int k = threadIdx.x; k < 2 * n2; k += blockDim.x) {
    const bool is_top = k >= n2;
    const int i = is_top ? k - n2 : k;
    const bool lo_ok = is_top ? baa : bll, hi_ok = is_top ? bar : blb;
    int v;
    if (i < n || hi_ok) {
      const bool ok = i < n ? lo_ok : true;
      v = !ok ? ubla : (is_top ? nb.top2(i) : nb.left2(i));
    } else {                       // the hi half from the lo half's last
      v = !lo_ok ? ubla : (is_top ? nb.top2(n - 1) : nb.left2(n - 1));
    }
    S[1 + k] = v;
  }
  if (threadIdx.x == 0) S[0] = ubla;
  __syncthreads();
  // smoothing: fbla, then [1 2 1] over ublb and ubar with their end cases
  for (int k = threadIdx.x; k <= 2 * n2; k += blockDim.x) {
    if (k == 2 * n2) {
      S[1 + 2 * n2] = (2 + S[1] + S[1 + n2] + 2 * ubla) >> 2;
      continue;
    }
    const int side = k >= n2, i = side ? k - n2 : k;
    const int* u = S + 1 + side * n2;
    int v;
    if (i == 0) v = (2 + 2 * u[0] + u[1] + ubla) >> 2;
    else if (i == n2 - 1) v = u[n2 - 1];
    else v = (2 + 2 * u[i] + u[i - 1] + u[i + 1]) >> 2;
    S[2 + 2 * n2 + k] = v;
  }
  if (threadIdx.x == 0) {
    int s = n;
    for (int i = 0; i < n; ++i) s += S[1 + i] + S[1 + n2 + i];
    *dc = s / n2;
  }
  __syncthreads();
}

__device__ __forceinline__ int clamp255(int v) {
  return min(max(v, 0), 255);
}

// Pixel (i, j) of the n x n prediction in mode m from the border S
// (intra.predict_all_modes): planar, DC, HOR and VER closed-form (with the
// sz <= 16 edge filters), the angular modes by the two-tap rule of
// intra._angular_tables (tab: idx1 (35, n, n) | idx2 | frac (35, n), in
// the vertical form; the horizontal modes transposed).
__device__ __forceinline__ int pred_px(const int* S, int n, int m, int i,
                                       int j, const int16_t* tab,
                                       int planar_filt, int dc) {
  const int* ublb = S + 1;
  const int* ubar = S + 1 + 2 * n;
  if (m == 0) {
    const int* pl = planar_filt ? S + 2 + 4 * n : ublb;
    const int* pa = planar_filt ? S + 2 + 6 * n : ubar;
    return (n + (n - j - 1) * pl[i] + (j + 1) * pa[n] + (n - i - 1) * pa[j] +
            (i + 1) * pl[n]) /
           (2 * n);
  }
  if (m == 1) {
    if (n <= 16) {
      if (i == 0 && j == 0) return (2 + 2 * dc + ublb[0] + ubar[0]) >> 2;
      if (i == 0) return (2 + 3 * dc + ubar[j]) >> 2;
      if (j == 0) return (2 + 3 * dc + ublb[i]) >> 2;
    }
    return dc;
  }
  if (m == 10) {
    if (n <= 16 && i == 0) return clamp255(((ubar[j] - S[0]) >> 1) + ublb[0]);
    return ublb[i];
  }
  if (m == 26) {
    if (n <= 16 && j == 0) return clamp255(((ublb[i] - S[0]) >> 1) + ubar[0]);
    return ubar[j];
  }
  const bool horiz = m < 18;
  const int ti = horiz ? j : i, tj = horiz ? i : j;
  const int nn35 = kModes * n * n;
  const int k = (m * n + ti) * n + tj;
  const int f = tab[2 * nn35 + m * n + ti];
  const int a = S[tab[k]];
  if (f == 0) return a;
  return ((32 - f) * a + f * S[tab[nn35 + k]] + 16) >> 5;
}

// four horizontally adjacent pixels from p (a multiple of 4; n >= 4), as
// one 32-bit word of bytes
__device__ __forceinline__ uint32_t pred4(const int* S, int n, int m, int p,
                                          const int16_t* tab, int planar_filt,
                                          int dc) {
  const int i = p / n, j = p % n;
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    w |= (uint32_t)pred_px(S, n, m, i, j + e, tab, planar_filt, dc)
         << (8 * e);
  return w;
}

// ------------------------------------------------------------------- X1

template <typename T>
__global__ void x1_predict_kernel(int sz, int isub, int lanes, View top,
                                  View left, View flags,
                                  const uint8_t* canvas, const int* modes,
                                  const int16_t* tab, int planar_filt,
                                  uint8_t* out) {
  __shared__ int S[kMaxS];
  __shared__ int dc;
  const int lane = blockIdx.x, r = blockIdx.y;
  const long long cand = (long long)r * lanes + lane;
  const int n = isub < 0 ? sz : sz >> 1;
  const int m = (isub >= 0 && modes) ? modes[cand] : lane;
  Nb<T> nb{top, left, r, sz, isub,
           canvas ? canvas + cand * sz * sz : nullptr};
  build_border(nb, flags, n, S, &dc);
  uint32_t* o = reinterpret_cast<uint32_t*>(out + cand * n * n);
  for (int p = 4 * threadIdx.x; p < n * n; p += 4 * blockDim.x)
    o[p >> 2] = pred4(S, n, m, p, tab, planar_filt, dc);
}

// ------------------------------------------------------------------- X2

// the reference's three most probable modes (src/HEVCe.c:958-977)
__device__ __forceinline__ void mpm3(int pml, int pma, int mpm[3]) {
  if (pml != pma) {
    mpm[0] = pml;
    mpm[1] = pma;
    mpm[2] = (pml != 0 && pma != 0) ? 0 : (pml + pma < 2 ? 26 : 1);
  } else if (pml > 1) {
    mpm[0] = pml;
    mpm[1] = ((pml + 29) % 32) + 2;
    mpm[2] = ((pml - 1) % 32) + 2;
  } else {
    mpm[0] = 0;
    mpm[1] = 1;
    mpm[2] = 26;
  }
}

// the sum of v over the block (a multiple of 32 threads); red holds 32 ints
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(kFull, v);
  const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < nw; ++k) s += red[k];
  __syncthreads();
  return s;
}

template <typename T>
__global__ void x2_preselect_kernel(int n, int K, View top, View left,
                                    View flags, const uint8_t* blk,
                                    const int* pml, long long pml_s,
                                    const int* pma, long long pma_s,
                                    const int16_t* tab, int planar_filt,
                                    uint8_t* predK, int* modesK) {
  __shared__ int S[kMaxS];
  __shared__ int R[32 * 32];
  __shared__ int cost[kModes];
  __shared__ int keep[kModes];
  __shared__ int kept[kModes];
  __shared__ int red[32];
  __shared__ int dc;
  const int r = blockIdx.x, nn = n * n, half = nn >> 1;
  Nb<T> nb{top, left, r, n, -1, nullptr};
  build_border(nb, flags, n, S, &dc);
  const uint8_t* b = blk + (long long)r * nn;

  // SATD of each mode's residual: sum |H X H|, the butterflies of the
  // Walsh-Hadamard transform (Sylvester order) over rows, then columns
  for (int m = 0; m < kModes; ++m) {
    for (int p = threadIdx.x; p < nn; p += blockDim.x)
      R[p] = (int)b[p] - pred_px(S, n, m, p / n, p % n, tab, planar_filt, dc);
    __syncthreads();
    for (int len = 1; len < n; len <<= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int row = t / (n >> 1), k = t % (n >> 1);
        const int i = (k / len) * 2 * len + (k % len);
        int* x = R + row * n;
        const int a = x[i], c = x[i + len];
        x[i] = a + c;
        x[i + len] = a - c;
      }
      __syncthreads();
    }
    for (int len = 1; len < n; len <<= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const int col = t % n, k = t / n;
        const int i = (k / len) * 2 * len + (k % len);
        const int a = R[i * n + col], c = R[(i + len) * n + col];
        R[i * n + col] = a + c;
        R[(i + len) * n + col] = a - c;
      }
      __syncthreads();
    }
    int s = 0;
    for (int p = threadIdx.x; p < nn; p += blockDim.x) s += abs(R[p]);
    s = block_sum(s, red);
    if (threadIdx.x == 0) cost[m] = s;
  }
  __syncthreads();

  // the forced modes biased below every SATD; the top K by a rank count:
  // m is kept when fewer than K modes come before it in (cost, mode) order
  // (_topk_mask's set), and listed in ascending mode order
  if (threadIdx.x < kModes) {
    const int m = threadIdx.x;
    int mpm[3];
    mpm3(pml[r * pml_s], pma[r * pma_s], mpm);
    const bool forced = m <= 1 || m == mpm[0] || m == mpm[1] || m == mpm[2];
    cost[m] -= forced ? (1 << 29) : 0;
  }
  __syncthreads();
  if (threadIdx.x < kModes) {
    const int m = threadIdx.x, c = cost[m];
    int rank = 0;
    for (int j = 0; j < kModes; ++j)
      rank += (cost[j] < c) || (cost[j] == c && j < m);
    keep[m] = rank < K;
  }
  __syncthreads();
  if (threadIdx.x < kModes && keep[threadIdx.x]) {
    const int m = threadIdx.x;
    int pos = 0;
    for (int j = 0; j < m; ++j) pos += keep[j];
    kept[pos] = m;
    modesK[(long long)r * K + pos] = m;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    uint32_t* o = reinterpret_cast<uint32_t*>(predK + ((long long)r * K + k) * nn);
    for (int p = 4 * threadIdx.x; p < nn; p += 4 * blockDim.x)
      o[p >> 2] = pred4(S, n, kept[k], p, tab, planar_filt, dc);
  }
}

// ------------------------------------------------------------------- X3

struct X3Params {
  int wd, wb, lim_d, lim_b, hdr_bins;
  int lvl[6];
};

// estimateCoeffRate of a level from |q| (a = -32768 when q = -32768: the
// int16 abs wraps, and the table's last entry prices it, as in the plain
// version)
__device__ __forceinline__ int level_rate(int a, const X3Params& p) {
  if (a < 6) return (a >= 0 && a < 5) ? p.lvl[a] : p.lvl[5];
  return 92000 + ((4 + 2 * (31 - __clz(a - 5))) << 15);
}

__device__ __forceinline__ int rd_cost(int dist, int bits,
                                       const X3Params& p) {
  const int c1 = p.lim_d <= dist ? kI32Max : wmul(p.wd, dist);
  const int c2 = p.lim_b <= bits ? kI32Max : wmul(p.wb, bits);
  return wsub(kI32Max, c1) <= c2 ? kI32Max : wadd(c1, c2);
}

// One warp per candidate (row r, lane l): levels q (subs sub-blocks of
// n x n, contiguous), scan tables tab = inv (3, nn) | packed by scan index
// (3, nn) | scan type by mode (35).
__global__ void x3_rate_cost_kernel(int n, int subs, int rows, int lanes,
                                    const int16_t* q, const int* sse,
                                    const int* ctxv, long long ctxv_s,
                                    const int* sigv, long long sigv_s,
                                    const int* pml, long long pml_s,
                                    const int* pma, long long pma_s,
                                    const int* modes, const int* tab,
                                    X3Params p, int* cost) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= (long long)rows * lanes) return;      // whole warps return
  const int lane = threadIdx.x & 31;
  const int r = (int)(w / lanes), l = (int)(w % lanes);
  const int m = modes ? modes[w] : l;
  const int cv = ctxv[r * ctxv_s], sv = sigv[r * sigv_s];
  const int nn = n * n;
  const int st = n <= 8 ? tab[6 * nn + m] : 0;
  const int* inv = tab + st * nn;
  const int* packed = tab + 3 * nn + st * nn;
  const int16_t* qc = q + w * subs * nn;
  unsigned est = 0;
  int last = 0;
  for (int s = 0; s < subs; ++s) {
    int nz = 0;
    unsigned il = 0, lo = 0, hi = 0;
    for (int px = lane; px < nn; px += 32) {
      const int v = qc[s * nn + px];
      const int a = v == -32768 ? -32768 : abs(v);
      est += (unsigned)level_rate(a, p);
      if (v != 0) {
        ++nz;
        const unsigned k = (unsigned)inv[px];
        il = max(il, k);
        const unsigned g = k >> 4;
        if (g < 32) lo |= 1u << g;
        else hi |= 1u << (g - 32);
      }
    }
    nz = __reduce_add_sync(kFull, nz);
    il = __reduce_max_sync(kFull, il);
    lo = __reduce_or_sync(kFull, lo);
    hi = __reduce_or_sync(kFull, hi);
    if (nz == 0) continue;                         // an all-zero block: 0
    const int sel = packed[il];
    const int ili = (int)il;
    int rate = wadd(wadd(wmul(sel >> 20, cv), sel & ((1 << 20) - 1)),
                    wmul(ili + 1 - nz, sv));
    if (nn > 16) {
      // a middle CG (1 .. cg_last - 1) that is all zero costs one sig_cg
      // bin instead of 16 sig-zero charges; every middle CG pays its flag
      const int cg_last = ili >> 4;
      const int n_mid = max(cg_last - 1, 0);
      const unsigned long long mask =
          ((unsigned long long)hi << 32) | (unsigned long long)lo;
      const unsigned long long mid =
          cg_last >= 2 ? (((1ull << cg_last) - 1) & ~1ull) : 0ull;
      const int n_mid_zero = n_mid - __popcll(mask & mid);
      rate = wadd(wsub(rate, wmul(16 * n_mid_zero, sv)), wmul(n_mid, cv));
    }
    last = wadd(last, rate);
  }
  est = __reduce_add_sync(kFull, est);
  if (lane != 0) return;
  int mpm[3];
  mpm3(pml[r * pml_s], pma[r * pma_s], mpm);
  int hits = 5;                                    // last match wins
  if (m == mpm[0]) hits = 1;
  if (m == mpm[1]) hits = 2;
  if (m == mpm[2]) hits = 2;
  const int pmr = wadd(cv, hits * kBit);
  const int rf = wadd(wadd(wadd((int)est, last), pmr), wmul(p.hdr_bins, cv));
  cost[w] = rd_cost(sse[w], wadd(rf, kHalf) >> 15, p);
}

// ------------------------------------------------------------------- X4

// candidate blocks of a row: element e (row-major over a w-wide block) of
// candidate m in row r at p + r * rs + m * ms + (e / w) * ys + (e % w) * xs,
// in elements; vec: every block is contiguous and 16-byte aligned. An
// output's blocks the same way, with ms = 0.
struct Blk {
  char* p;
  long long rs, ms, ys, xs;
  int w, vec;
};

// int32 values of a row: element i of row r at p[r * rs + i * es]
struct Ivec {
  int* p;
  long long rs, es;
};

struct X4Args {
  int rows, sets, nn, M[2];
  Ivec cost[2], modes[2];     // modes[s].p null: the mode is the index
  Blk q[2], r[2];             // int16 levels, uint8 recon
  int* cost_out;              // (rows,) contiguous
  int* lay_out;
  Ivec pm_out, total;         // total.p null: no running total
  Blk q_out, r_out;
};

// the winner's block into the output row: 16-byte vectors when both sides
// are contiguous and aligned, else element by element through the strides
template <typename T>
__device__ __forceinline__ void copy_block(const Blk& s, int r, int m,
                                           const Blk& d, int nn, int lane) {
  const T* src = reinterpret_cast<const T*>(s.p) + r * s.rs + m * s.ms;
  T* dst = reinterpret_cast<T*>(d.p) + r * d.rs;
  if (s.vec && d.vec) {
    const int nv = nn * (int)sizeof(T) / 16;
    const uint4* vs = reinterpret_cast<const uint4*>(src);
    uint4* vd = reinterpret_cast<uint4*>(dst);
    for (int k = lane; k < nv; k += 32) vd[k] = vs[k];
    return;
  }
  for (int e = lane; e < nn; e += 32)
    dst[(e / d.w) * d.ys + (e % d.w) * d.xs] =
        src[(e / s.w) * s.ys + (e % s.w) * s.xs];
}

// One warp per row: the (cost, index) pairs of the sets joined, the first
// minimum by a shuffle reduction (ties to the lower index, as
// _argmin_first's), then the winner's cost, layout (1 + its set), mode and
// blocks; with a running total, total = total > I32_MAX - cost ? I32_MAX :
// total + cost in wrapping int32, as the plain version's.
__global__ void x4_pick_kernel(X4Args a) {
  const long long w =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= a.rows) return;                       // whole warps return
  const int r = (int)w, lane = threadIdx.x & 31;
  const int M0 = a.M[0], M = M0 + (a.sets > 1 ? a.M[1] : 0);
  int best = kI32Max, bi = M;
  for (int k = lane; k < M; k += 32) {
    const Ivec c = k < M0 ? a.cost[0] : a.cost[1];
    const int v = c.p[r * c.rs + (k < M0 ? k : k - M0) * c.es];
    if (v < best || (v == best && k < bi)) {
      best = v;
      bi = k;
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const int v = __shfl_xor_sync(kFull, best, off);
    const int k = __shfl_xor_sync(kFull, bi, off);
    if (v < best || (v == best && k < bi)) {
      best = v;
      bi = k;
    }
  }
  const int s = bi >= M0, i = s ? bi - M0 : bi;
  if (lane == 0) {
    a.cost_out[r] = best;
    a.lay_out[r] = 1 + s;
    const Ivec md = s ? a.modes[1] : a.modes[0];
    a.pm_out.p[r * a.pm_out.rs] = md.p ? md.p[r * md.rs + i * md.es] : i;
    if (a.total.p) {
      int* t = a.total.p + r * a.total.rs;
      *t = *t > wsub(kI32Max, best) ? kI32Max : wadd(*t, best);
    }
  }
  copy_block<int16_t>(s ? a.q[1] : a.q[0], r, i, a.q_out, a.nn, lane);
  copy_block<uint8_t>(s ? a.r[1] : a.r[0], r, i, a.r_out, a.nn, lane);
}

int x2_threads(int n) { return n >= 32 ? 256 : n >= 16 ? 128 : 64; }

struct Reader {
  const long long* v;
  int i;
  long long next() { return v[i++]; }
  Ivec ivec() {
    Ivec x;
    x.p = reinterpret_cast<int*>(next());
    x.rs = next();
    x.es = next();
    return x;
  }
  Blk blk() {
    Blk b;
    b.p = reinterpret_cast<char*>(next());
    b.rs = next();
    b.ms = next();
    b.ys = next();
    b.xs = next();
    b.w = (int)next();
    b.vec = (int)next();
    return b;
  }
};

constexpr int kX4Words = 67;

}  // namespace

extern "C" {

// X1 on `stream`: rows x lanes blocks of n x n predictions into out (uint8,
// contiguous), n = sz (isub < 0: all 35 modes, lane = mode) or sz / 2
// (sub-TU isub 0-3 of a TU split, canvas (rows, lanes, sz, sz) uint8, lane
// t in mode modes[t], or t when modes is null). top / left / flags: (rows,
// n) views (pointer, row stride, element stride) of the node's context
// (uint8, or int32 when ctx_i32) and its four flags (bool). tab: the
// angular table at n. Returns cudaGetLastError().
int hevce_x1_launch(int sz, int isub, int rows, int lanes, int ctx_i32,
                    const void* top, long long top_rs, long long top_es,
                    const void* left, long long left_rs, long long left_es,
                    const void* flags, long long flags_rs,
                    long long flags_es, const void* canvas,
                    const void* modes, const void* tab, int planar_filt,
                    void* out, void* stream) {
  const View t{top, top_rs, top_es}, l{left, left_rs, left_es},
      f{flags, flags_rs, flags_es};
  const int n = isub < 0 ? sz : sz >> 1;
  const int threads = max(32, min(256, n * n / 4));
  const dim3 grid((unsigned)lanes, (unsigned)rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const uint8_t*>(canvas);
  auto* md = static_cast<const int*>(modes);
  auto* tb = static_cast<const int16_t*>(tab);
  auto* o = static_cast<uint8_t*>(out);
  if (ctx_i32)
    x1_predict_kernel<int32_t><<<grid, threads, 0, s>>>(
        sz, isub, lanes, t, l, f, c, md, tb, planar_filt, o);
  else
    x1_predict_kernel<uint8_t><<<grid, threads, 0, s>>>(
        sz, isub, lanes, t, l, f, c, md, tb, planar_filt, o);
  return cudaGetLastError();
}

// X2 on `stream`: one block per row; predK (rows, K, sz, sz) uint8 and
// modesK (rows, K) int32, K <= 35. blk (rows, sz, sz) uint8 contiguous;
// pml / pma (rows,) int32 with their strides; the rest as X1's.
int hevce_x2_launch(int sz, int K, int rows, const void* top,
                    long long top_rs, long long top_es, const void* left,
                    long long left_rs, long long left_es, const void* flags,
                    long long flags_rs, long long flags_es, int ctx_i32,
                    const void* blk, const void* pml, long long pml_s,
                    const void* pma, long long pma_s, const void* tab,
                    int planar_filt, void* predK, void* modesK,
                    void* stream) {
  const View t{top, top_rs, top_es}, l{left, left_rs, left_es},
      f{flags, flags_rs, flags_es};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* b = static_cast<const uint8_t*>(blk);
  auto* pl = static_cast<const int*>(pml);
  auto* pa = static_cast<const int*>(pma);
  auto* tb = static_cast<const int16_t*>(tab);
  auto* pk = static_cast<uint8_t*>(predK);
  auto* mk = static_cast<int*>(modesK);
  if (ctx_i32)
    x2_preselect_kernel<int32_t><<<rows, x2_threads(sz), 0, s>>>(
        sz, K, t, l, f, b, pl, pml_s, pa, pma_s, tb, planar_filt, pk, mk);
  else
    x2_preselect_kernel<uint8_t><<<rows, x2_threads(sz), 0, s>>>(
        sz, K, t, l, f, b, pl, pml_s, pa, pma_s, tb, planar_filt, pk, mk);
  return cudaGetLastError();
}

// X3 on `stream`: costs (rows, lanes) int32 of the candidates' levels q
// (rows, lanes, subs, n, n) int16 and sse (rows, lanes) int32; ctxv /
// sigv / pml / pma (rows,) int32 with their strides; modes (rows, lanes)
// int32 or null (lane = mode); tab X3's scan table at n; hdr_bins header
// context bins; wd / wb the qpd6's RD weights; lvl6 (host memory) the
// first 6 entries of LEVEL_RATE_TABLE.
int hevce_x3_launch(int n, int subs, int rows, int lanes, const void* q,
                    const void* sse, const void* ctxv, long long ctxv_s,
                    const void* sigv, long long sigv_s, const void* pml,
                    long long pml_s, const void* pma, long long pma_s,
                    const void* modes, const void* tab, int hdr_bins, int wd,
                    int wb, const int* lvl6, void* cost, void* stream) {
  X3Params p;
  p.wd = wd;
  p.wb = wb;
  p.lim_d = kI32Max / wd;
  p.lim_b = kI32Max / wb;
  p.hdr_bins = hdr_bins;
  for (int i = 0; i < 6; ++i) p.lvl[i] = lvl6[i];
  const long long warps = (long long)rows * lanes;
  const unsigned blocks = (unsigned)((warps + 3) / 4);
  x3_rate_cost_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      n, subs, rows, lanes, static_cast<const int16_t*>(q),
      static_cast<const int*>(sse), static_cast<const int*>(ctxv), ctxv_s,
      static_cast<const int*>(sigv), sigv_s, static_cast<const int*>(pml),
      pml_s, static_cast<const int*>(pma), pma_s,
      static_cast<const int*>(modes), static_cast<const int*>(tab), p,
      static_cast<int*>(cost));
  return cudaGetLastError();
}

// X4 on `stream`: v (host memory, kX4Words words) is, in order: rows,
// sets (1 or 2), nn (elements a block), M0, M1; the sets' costs, then
// their mode maps (each pointer, row stride, element stride; a null mode
// map: the mode is the index); the sets' levels (int16), then their
// recons (uint8) (each pointer, row, candidate, block-row and element
// strides, block width, vec); the outputs cost and lay ((rows,) int32,
// contiguous), pm and the running total (pointer, row stride, 0; a null
// total: none) and the levels and recon (as a set's blocks, candidate
// stride 0). Returns -1 on a wrong word count, else cudaGetLastError().
int hevce_x4_launch(const long long* v, int words, void* stream) {
  if (words != kX4Words) return -1;
  Reader rd{v, 0};
  X4Args a;
  a.rows = (int)rd.next();
  a.sets = (int)rd.next();
  a.nn = (int)rd.next();
  a.M[0] = (int)rd.next();
  a.M[1] = (int)rd.next();
  for (int k = 0; k < 2; ++k) a.cost[k] = rd.ivec();
  for (int k = 0; k < 2; ++k) a.modes[k] = rd.ivec();
  for (int k = 0; k < 2; ++k) a.q[k] = rd.blk();
  for (int k = 0; k < 2; ++k) a.r[k] = rd.blk();
  a.cost_out = reinterpret_cast<int*>(rd.next());
  a.lay_out = reinterpret_cast<int*>(rd.next());
  a.pm_out = rd.ivec();
  a.total = rd.ivec();
  a.q_out = rd.blk();
  a.r_out = rd.blk();
  if (rd.i != kX4Words) return -1;
  const unsigned blocks = (unsigned)((a.rows + 3) / 4);
  x4_pick_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
