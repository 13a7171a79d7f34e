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
// What bounds it. Every op depends on the previous one through the coder
// state, so a lane is one serial chain, and a call lasts as long as its
// longest lane (max(nops) ops) times the time of one op. The bytes (the real
// ops, 4 B each, plus the state and palette in and out) and the integer
// operations are far below what the card moves or does in that time: the
// latency of the chain, and the instructions the warp issues for one op,
// are the bound. A call has a few hundred to 1260 lanes, one warp per block,
// fewer warps than the card has SMs, and nothing hides a warp's latency.
//
// Design, one thread per lane and a block of one warp:
//  * One straight-line path per op, in the form of the JAX kernel's
//    _advance. The context-bin, bypass and terminate results are all
//    computed and one is picked by selects; a nop picks "no change". The
//    refill and the emulation-prevention count are predicated arithmetic
//    too. The warp issues one path per op whatever its 32 lanes' op kinds,
//    and the kinds' independent work overlaps.
//  * The LPS lookup is off the range chain. The 64x4 LPS table is packed as
//    64 words of 4 bytes; the word of state v >> 1 depends on the context
//    value only, so it loads while the range is computed, and the range step
//    takes byte (rng >> 6) & 3 with one byte permute. The renormalisation
//    shift is min(clz(lps) - 23, 6); the MPS next state is v + 2 (s < 62)
//    for s = v >> 1, the MPS bit kept. Only the LPS next state is a table
//    read, on the context chain.
//  * The next op's context is loaded early: op i + 1's word and its slot's
//    value are loaded before op i stores its slot; when the slots are the
//    same the new value is forwarded from the register. The context chain
//    (load, next state, store) overlaps the range and low chain.
//  * No stall between op tiles: the 32 x 32 tile of the next 32 ops of the
//    warp's lanes is loaded from global memory into registers before the
//    current tile's ops run (one lane's row per load instruction: one
//    128-byte line), and stored into the shared tile once they have run.
// The palette lives in shared memory thread-minor (ctx[p * 32 + tid]), so
// lanes of a warp that touch different slots hit 32 different banks; tiles
// are padded to 33 columns for the same reason.
//
// int32 semantics follow the reference (and PyTorch): sums and left shifts
// wrap, so they are computed in uint32_t and cast back (a signed overflow,
// or a left shift of a negative int, is undefined in C++); `low >> sh` is an
// arithmetic shift of a signed int, as in PyTorch. The emulation-prevention
// closed form halves (k - first) with a shift and a mask only where it is
// >= 0, where they equal the plain version's floor division and modulo.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kLps4 = 64;             // packed LPS ranges, 4 bytes a state
// in shared memory the packed word of state s is stored for both context
// values v = 2 s and 2 s + 1, so that v indexes it directly, then the
// 128-entry LPS next-state table
constexpr int kSmemTables = 128 + 128;
constexpr int kChunk = 32;            // palette loads in flight a thread
static_assert(kSmemTables % 32 == 0, "the tables copy in whole rows");
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

// Computes each value in place and hides where it came from: an empty asm
// statement that the compiler must keep where it stands. Without it the
// compiler turns some selects into divergent branches: one whose operand
// takes a few instructions (the shift count, the next-state load), so as
// to compute it only where it is picked, and a chain keyed on one value,
// which it merges into a switch.
__device__ __forceinline__ void pin() {}

template <typename... T>
__device__ __forceinline__ void pin(int& x, T&... rest) {
  asm volatile("" : "+r"(x));
  pin(rest...);
}

struct Coder {
  int rng, low, nbits, outstanding, bufbyte, zrun, nbytes;
};

// One op on the coder, without a branch. v is the value of the op's slot
// (used by a context bin only), w the packed LPS word of its state,
// lps4v[v]. Returns the slot's value after the op: v itself unless the op
// is a context bin.
__device__ __forceinline__ int advance(Coder& c, int op, int v, int w,
                                       const int* next_lps) {
  // the kind's predicates, pinned: selects keyed on one value compared
  // with several constants are otherwise merged into a switch, a branch
  const int kind = op & 3;
  int is_ctx = kind == 0, is_byp = kind == 1, is_term = kind == 2;
  pin(is_ctx, is_byp, is_term);
  const bool active = kind != kNop;
  const int b = (op >> 10) & 1;
  const int rng = c.rng;

  // context-coded bin (reference src/HEVCe.c:914-933)
  const int lps = static_cast<int>(__byte_perm(static_cast<uint32_t>(w), 0u,
                                               0x4440u | ((rng >> 6) & 3)));
  int nbit = min(__clz(lps) - 23, 6);
  const int r1 = rng - lps;
  const bool is_lps = ((op >> 10) ^ v) & 1;    // the bin is not the MPS
  int ren1 = r1 < 256;
  int lps_next = next_lps[v];

  // terminate bin (src/HEVCe.c:882-896)
  const int r2 = rng - 2;
  int ren2 = r2 < 256;

  // bypass run of 1..8 bins (src/HEVCe.c:899-911)
  int len = (op >> 2) & 0xF;
  const int val = (op >> 6) & 0xFF;
  pin(nbit, ren1, lps_next, ren2, len);
  const int newv = is_lps ? lps_next : v + 2 * ((v >> 1) < 62);

  // each kind as low' = ((low + add) << sh) + extra, rng' = base << sh
  // (a bypass run keeps its range), nbits' = nbits - sh; one select of two
  // values at a time, each a select and not a branch
  const int add_ctx = is_lps ? r1 : 0, add_term = b ? r2 : 0;
  const int add = is_ctx ? add_ctx : is_term ? add_term : 0;
  const int sh_ctx = is_lps ? nbit : ren1, sh_term = b ? 7 : ren2;
  const int sh_byp = is_byp ? len : 0;
  const int sh_other = is_term ? sh_term : sh_byp;
  const int sh = is_ctx ? sh_ctx : sh_other;
  const int base_ctx = is_lps ? lps : r1, base_term = b ? 2 : r2;
  const int base = is_ctx ? base_ctx : base_term;
  const int extra = is_byp ? wrap_mul(rng, val) : 0;
  const int low2 = wrap_add(wrap_shl(wrap_add(c.low, add), sh), extra);
  const int nbits2 = c.nbits - sh;
  c.rng = is_ctx || is_term ? wrap_shl(base, sh) : rng;

  // refill: carry resolution + byte extraction (src/HEVCe.c:859-879)
  const bool need = active && nbits2 < 12;
  const int lead = low2 >> min(max(24 - nbits2, 0), 31);
  const int nbits3 = need ? nbits2 + 8 : nbits2;
  const uint32_t mask = (1u << min(max(32 - nbits3, 0), 31)) - 1u;
  c.low = need ? static_cast<int>(static_cast<uint32_t>(low2) & mask) : low2;
  const bool is_ff = lead == 0xFF;
  const bool flush = need && !is_ff && c.outstanding > 0;
  const bool fresh = need && !is_ff && c.outstanding == 0;
  const int carry = lead >> 8;
  // a flush emits (bufbyte + carry) & 0xFF once, then outstanding - 1
  // copies of (0xFF + carry) & 0xFF, through the emulation-prevention sink
  // (src/HEVCe.c:821-832): one 0x03 before a byte <= 3 after two zeros
  const int b1 = wrap_add(c.bufbyte, carry) & 0xFF;
  const int z0 = c.zrun;
  const int ins1 = z0 >= 2 && b1 <= 3;
  const int z1 = b1 == 0 ? (z0 >= 2 ? 1 : z0 + 1) : 0;
  const int fill = (0xFF + carry) & 0xFF;
  const int k = c.outstanding - 1;            // >= 0 on a flush
  const int first = z1 >= 2 ? 1 : 3 - z1;     // index of the 1st insert
  const int d = k - first;
  const bool many = d >= 0;
  const int ins0 = many ? 1 + (d >> 1) : 0;
  const int z0run = many ? 1 + (d & 1) : z1 + k;
  const int ins2 = k > 0 ? (fill == 0 ? ins0 : (fill <= 3 && z1 >= 2)) : 0;
  const int z2 = k > 0 ? (fill == 0 ? z0run : 0) : z1;
  c.nbytes = flush ? c.nbytes + 1 + ins1 + k + ins2 : c.nbytes;
  c.zrun = flush ? z2 : z0;
  c.outstanding = need && is_ff ? c.outstanding + 1
                                : flush || fresh ? 1 : c.outstanding;
  c.bufbyte = flush || fresh ? lead & 0xFF : c.bufbyte;
  c.nbits = nbits3;
  return is_ctx ? newv : v;
}

__global__ void __launch_bounds__(kWarp)
k2_kernel(const int* __restrict__ ops, int L, const int* __restrict__ nops,
          const int* __restrict__ st_in, const int* __restrict__ ctx_in,
          const int* __restrict__ tables, int lanes, int P,
          int* __restrict__ st_out, int* __restrict__ ctx_out) {
  extern __shared__ int smem[];
  const int* lps4v = smem;
  const int* next_lps = smem + 128;
  int (*tile)[kWarp + 1] =
      reinterpret_cast<int (*)[kWarp + 1]>(smem + kSmemTables);
  int* ctx = smem + kSmemTables + kWarp * (kWarp + 1);

  const int tid = threadIdx.x;
  const int base = blockIdx.x * kWarp;
  const int lane = base + tid;
  const bool live = lane < lanes;

  Coder c{0, 0, 0, 0, 0, 0, 0};
  int n = 0;
  if (live) {
    c.rng = st_in[lane];
    c.low = st_in[lanes + lane];
    c.nbits = st_in[2 * lanes + lane];
    c.outstanding = st_in[3 * lanes + lane];
    c.bufbyte = st_in[4 * lanes + lane];
    c.zrun = st_in[5 * lanes + lane];
    c.nbytes = st_in[6 * lanes + lane];
    n = min(max(nops[lane], 0), L);
  }

  // ops k0..k0+31 of the warp's lanes, row r one coalesced load; past a
  // lane's count a nop, which changes nothing
  auto fetch = [&](int k0, int r) {
    const int nr = __shfl_sync(0xffffffffu, n, r);
    const int t = k0 + tid;
    return t < nr ? ops[static_cast<long long>(base + r) * L + t] : kNop;
  };
#pragma unroll
  for (int j = 0; j < kSmemTables / kWarp; ++j) {
    const int i = j * kWarp + tid;
    smem[i] = tables[i < 128 ? i >> 1 : i - kLps4];
  }
  // the first tile's loads are in flight while the palette is copied
  int staged[kWarp];
#pragma unroll
  for (int r = 0; r < kWarp; ++r) staged[r] = fetch(0, r);
  // the warp's palette rows are contiguous: element i = r * P + p of them
  // is slot p of lane base + r. They are read with coalesced loads, up to
  // kChunk of them in flight a thread; a lane past the last gets slot
  // values 0, a valid context for the nops it runs
  const int* rows = ctx_in + static_cast<long long>(base) * P;
  const int live_elems = min(lanes - base, kWarp) * P;
  const int dr = kWarp / P, dp = kWarp % P;
  int er = tid / P, ep = tid % P;        // row and slot of element i
  for (int i0 = tid; i0 < kWarp * P; i0 += kChunk * kWarp) {
    int val[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int i = i0 + j * kWarp;
      val[j] = i < live_elems ? rows[i] : 0;
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (i0 + j * kWarp < kWarp * P) ctx[ep * kWarp + er] = val[j];
      er += dr;
      ep += dp;
      if (ep >= P) {
        ep -= P;
        ++er;
      }
    }
  }
  __syncwarp();
  const int nmax = __reduce_max_sync(0xffffffffu, n);

  // the palette remap keeps slots below P; the clamp only keeps a
  // malformed op inside shared memory
  const auto slot_of = [P](int op) { return min((op >> 2) & 0xFF, P - 1); };
  int* ctx_t = ctx + tid;                // this lane's slot p: ctx_t[p * 32]
  for (int k0 = 0; k0 < nmax; k0 += kWarp) {
#pragma unroll
    for (int r = 0; r < kWarp; ++r) tile[r][tid] = staged[r];
    __syncwarp();
    if (k0 + kWarp < nmax) {
#pragma unroll
      for (int r = 0; r < kWarp; ++r) staged[r] = fetch(k0 + kWarp, r);
    }
    const int* row = tile[tid];
    const int kend = min(kWarp, nmax - k0);
    int op = row[0];
    int slot = slot_of(op);
    int v = ctx_t[slot * kWarp];
#pragma unroll 2
    for (int i = 0; i < kend; ++i) {
      // op i + 1 (the pad column past the tile's end: never used) and its
      // slot's value, loaded before op i stores its own slot
      const int op_n = row[i + 1];
      const int slot_n = slot_of(op_n);
      const int v_n = ctx_t[slot_n * kWarp];
      const int nv = advance(c, op, v, lps4v[v], next_lps);
      ctx_t[slot * kWarp] = nv;
      v = slot_n == slot ? nv : v_n;
      op = op_n;
      slot = slot_n;
    }
    __syncwarp();
  }

  if (live) {
    st_out[lane] = c.rng;
    st_out[lanes + lane] = c.low;
    st_out[2 * lanes + lane] = c.nbits;
    st_out[3 * lanes + lane] = c.outstanding;
    st_out[4 * lanes + lane] = c.bufbyte;
    st_out[5 * lanes + lane] = c.zrun;
    st_out[6 * lanes + lane] = c.nbytes;
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
// palette, or null to skip the write-back; tables: int32, the first 192 of
// which are read (the 64x4 LPS range table packed as 64 little-endian words
// of 4 bytes, then the 128-entry LPS next-state table;
// ops/cabac_scan.kernel_tables). Returns cudaGetLastError().
int hevce_k2_launch(const void* ops, int lanes, int L, const void* nops,
                    const void* st_in, const void* ctx_in, int P,
                    const void* tables, void* st_out, void* ctx_out,
                    void* stream) {
  if (lanes <= 0 || L < 0 || P < 1 || P > 256) return cudaErrorInvalidValue;
  const int blocks = (lanes + kWarp - 1) / kWarp;
  const size_t smem =
      sizeof(int) * (kSmemTables + kWarp * (kWarp + 1)
                     + static_cast<size_t>(P) * kWarp);
  k2_kernel<<<blocks, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ops), L, static_cast<const int*>(nops),
      static_cast<const int*>(st_in), static_cast<const int*>(ctx_in),
      static_cast<const int*>(tables), lanes, P, static_cast<int*>(st_out),
      static_cast<int*>(ctx_out));
  return cudaGetLastError();
}

}  // extern "C"
