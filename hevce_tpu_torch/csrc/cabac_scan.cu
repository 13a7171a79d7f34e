// Exact CABAC rate scan (kernel K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel hevce_tpu/ops/cabac_pallas.py::_kernel (bin update
// _advance, built by _build, reached through advance_rates). Each lane
// advances the reference coder's 7 scalars (range, low, nbits, outstanding,
// bufbyte, zrun, nbytes) and its context palette through its own string of
// packed ops: a context-coded bin (LPS range lookup, MPS/LPS state
// transition, renormalisation), a bypass run of up to 8 bins, a terminate
// bin, or a nop. After each op the low register is refilled: carries are
// resolved through the outstanding-0xFF count and emitted bytes are COUNTED
// through the start-code emulation-prevention sink (a closed form of the
// zero-run automaton), never stored. Bit-identical to the plain version,
// hevce_tpu_torch/ops/cabac_sim.py::simulate_chunked.
//
// Design. One thread per lane; a block is one warp of 32 lanes, so the few
// hundred lanes of a call spread over as many SMs as possible. The 7 scalars
// live in registers. The lane's context palette lives in shared memory,
// thread-minor (ctx[p * 32 + tid]), so lanes of a warp that touch different
// slots still hit 32 different banks. The LPS range table and the two
// next-state tables are copied into shared memory as well: they are indexed
// by per-lane state, and divergent __constant__ reads serialise. The op
// strings arrive as (lanes, L) rows; every 32 ops the warp stages a 32 x 32
// tile of them in shared memory, one lane's row per load instruction
// (consecutive addresses, one 128-byte line), and each lane then reads its
// own row of the tile (padded to 33 columns: no bank conflicts). A lane
// stops at its own op count, and loads past it are skipped: the padded tail
// is nops, which change nothing.
//
// What bounds it. Every op depends on the previous one through the coder
// state, so a lane is one serial chain of ~20-40 integer instructions and
// shared-memory loads per op, and a call lasts as long as its longest lane
// (max(nops) steps) times that chain's latency. The bytes (the real ops,
// 4 B each, plus the state and palette in and out) and the integer
// operations (~40 per op) are both far below what the card can move or do
// in that time, so the roofline bound is not what limits it: latency is.
// The design keeps the chain short (tables and contexts in shared memory,
// no global loads inside the chain except the staged tiles) and puts each
// warp on its own SM.
//
// int32 semantics follow the reference (and PyTorch): sums and left shifts
// wrap, so they are computed in uint32_t and cast back (a signed overflow,
// or a left shift of a negative int, is undefined in C++); `low >> sh` is an
// arithmetic shift of a signed int, as in PyTorch. The emulation-prevention
// closed form divides (k - first) only where it is >= 0, so C++'s
// truncation equals the plain version's floor division.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLps = 256;             // LPS range, index 4 * state + q
constexpr int kTables = kLps + 128 + 128;
constexpr int kNop = 3;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int wrap_shl(int a, int s) {
  return static_cast<int>(static_cast<uint32_t>(a) << s);
}

// count k emitted copies of `byte` through the emulation-prevention sink
// (reference src/HEVCe.c:821-832)
__device__ __forceinline__ void emit_run(int& nbytes, int& zrun, int byte,
                                         int k) {
  if (k <= 0) return;
  int ins = 0;
  if (byte == 0) {
    const int first = zrun >= 2 ? 1 : 3 - zrun;  // index of the 1st insert
    if (k >= first) {
      ins = 1 + (k - first) / 2;
      zrun = 1 + (k - first) % 2;
    } else {
      zrun += k;
    }
  } else {
    ins = (byte <= 3 && zrun >= 2) ? 1 : 0;
    zrun = 0;
  }
  nbytes += k + ins;
}

__global__ void __launch_bounds__(kWarp)
k2_kernel(const int* __restrict__ ops, int L, const int* __restrict__ nops,
          const int* __restrict__ st_in, const int* __restrict__ ctx_in,
          const int* __restrict__ tables, int lanes, int P,
          int* __restrict__ st_out, int* __restrict__ ctx_out) {
  extern __shared__ int smem[];
  const int* lps_tab = smem;
  const int* next_lps = smem + kLps;
  const int* next_mps = smem + kLps + 128;
  int (*tile)[kWarp + 1] =
      reinterpret_cast<int (*)[kWarp + 1]>(smem + kTables);
  int* ctx = smem + kTables + kWarp * (kWarp + 1);

  const int tid = threadIdx.x;
  const int base = blockIdx.x * kWarp;
  const int lane = base + tid;
  const bool live = lane < lanes;

  for (int i = tid; i < kTables; i += kWarp) smem[i] = tables[i];

  int rng = 0, low = 0, nbits = 0, outstanding = 0, bufbyte = 0, zrun = 0,
      nbytes = 0, n = 0;
  if (live) {
    rng = st_in[lane];
    low = st_in[lanes + lane];
    nbits = st_in[2 * lanes + lane];
    outstanding = st_in[3 * lanes + lane];
    bufbyte = st_in[4 * lanes + lane];
    zrun = st_in[5 * lanes + lane];
    nbytes = st_in[6 * lanes + lane];
    const int* row = ctx_in + static_cast<long long>(lane) * P;
    for (int p = 0; p < P; ++p) ctx[p * kWarp + tid] = row[p];
    n = min(max(nops[lane], 0), L);
  }
  __syncwarp();
  const int nmax = __reduce_max_sync(0xffffffffu, n);

  for (int k0 = 0; k0 < nmax; k0 += kWarp) {
    // stage ops k0..k0+31 of the warp's lanes; row r is one coalesced load
#pragma unroll 8
    for (int r = 0; r < kWarp; ++r) {
      const int nr = __shfl_sync(0xffffffffu, n, r);
      const int t = k0 + tid;
      tile[r][tid] =
          t < nr ? ops[static_cast<long long>(base + r) * L + t] : kNop;
    }
    __syncwarp();
    const int kend = min(kWarp, n - k0);
    for (int i = 0; i < kend; ++i) {
      const int op = tile[tid][i];
      const int kind = op & 3;
      if (kind == kNop) continue;
      const int b = (op >> 10) & 1;
      if (kind == 0) {
        // context-coded bin (reference src/HEVCe.c:914-933). The palette
        // remap keeps slots below P; the clamp only keeps a malformed op
        // inside shared memory.
        const int slot = min((op >> 2) & 0xFF, P - 1);
        int* cv = ctx + slot * kWarp + tid;
        const int v = *cv;
        const int lps = lps_tab[(v >> 1) * 4 + ((rng >> 6) & 3)];
        const int r1 = rng - lps;
        if (b != (v & 1)) {
          const int li = lps >> 3;
          const int nbit =
              6 - ((li >= 1) + (li >= 2) + (li >= 4) + (li >= 8) + (li >= 16));
          low = wrap_shl(wrap_add(low, r1), nbit);
          rng = wrap_shl(lps, nbit);
          nbits -= nbit;
          *cv = next_lps[v];
        } else {
          if (r1 < 256) {
            low = wrap_shl(low, 1);
            rng = wrap_shl(r1, 1);
            nbits -= 1;
          } else {
            rng = r1;
          }
          *cv = next_mps[v];
        }
      } else if (kind == 1) {
        // bypass run of 1..8 bins (src/HEVCe.c:899-911)
        const int len = (op >> 2) & 0xF;
        const int val = (op >> 6) & 0xFF;
        low = wrap_add(wrap_shl(low, len), wrap_mul(rng, val));
        nbits -= len;
      } else {
        // terminate bin (src/HEVCe.c:882-896)
        const int r2 = rng - 2;
        if (b) {
          low = wrap_shl(wrap_add(low, r2), 7);
          rng = 2 << 7;
          nbits -= 7;
        } else if (r2 < 256) {
          low = wrap_shl(low, 1);
          rng = wrap_shl(r2, 1);
          nbits -= 1;
        } else {
          rng = r2;
        }
      }
      // refill: carry resolution + byte extraction (src/HEVCe.c:859-879)
      if (nbits < 12) {
        const int lead = low >> min(max(24 - nbits, 0), 31);
        nbits += 8;
        const int msh = min(max(32 - nbits, 0), 31);
        low = static_cast<int>(static_cast<uint32_t>(low) & ((1u << msh) - 1u));
        if (lead == 0xFF) {
          outstanding += 1;
        } else if (outstanding >= 0) {
          if (outstanding > 0) {
            const int carry = lead >> 8;
            emit_run(nbytes, zrun, (bufbyte + carry) & 0xFF, 1);
            emit_run(nbytes, zrun, (0xFF + carry) & 0xFF, outstanding - 1);
          }
          outstanding = 1;
          bufbyte = lead & 0xFF;
        }
      }
    }
    __syncwarp();
  }

  if (live) {
    st_out[lane] = rng;
    st_out[lanes + lane] = low;
    st_out[2 * lanes + lane] = nbits;
    st_out[3 * lanes + lane] = outstanding;
    st_out[4 * lanes + lane] = bufbyte;
    st_out[5 * lanes + lane] = zrun;
    st_out[6 * lanes + lane] = nbytes;
    if (ctx_out) {
      int* row = ctx_out + static_cast<long long>(lane) * P;
      for (int p = 0; p < P; ++p) row[p] = ctx[p * kWarp + tid];
    }
  }
}

}  // namespace

extern "C" {

// Launch K2 on `stream`. ops: (lanes, L) int32 nop-padded op strings;
// nops: (lanes,) op counts; st_in / st_out: (7, lanes) int32 coder scalars
// (range, low, nbits, outstanding, bufbyte, zrun, nbytes); ctx_in: (lanes,
// P) int32 context palette, 1 <= P <= 256; ctx_out: (lanes, P) final
// palette, or null to skip the write-back; tables: int32, the first 512 of
// which are read (the 64x4 LPS range table, the LPS and the MPS next-state
// tables; ops/cabac_sim._tables). Returns cudaGetLastError().
int hevce_k2_launch(const void* ops, int lanes, int L, const void* nops,
                    const void* st_in, const void* ctx_in, int P,
                    const void* tables, void* st_out, void* ctx_out,
                    void* stream) {
  if (lanes <= 0 || L < 0 || P < 1 || P > 256) return cudaErrorInvalidValue;
  const int blocks = (lanes + kWarp - 1) / kWarp;
  const size_t smem =
      sizeof(int) * (kTables + kWarp * (kWarp + 1) + static_cast<size_t>(P) * kWarp);
  k2_kernel<<<blocks, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ops), L, static_cast<const int*>(nops),
      static_cast<const int*>(st_in), static_cast<const int*>(ctx_in),
      static_cast<const int*>(tables), lanes, P, static_cast<int*>(st_out),
      static_cast<int*>(ctx_out));
  return cudaGetLastError();
}

}  // extern "C"
