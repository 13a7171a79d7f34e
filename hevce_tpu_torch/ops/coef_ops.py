"""Residual-coding op-string generation as tensor work.

Turns quantized TU blocks into the exact CABAC op strings that putCoef
(reference src/HEVCe.c:1173-1269) and the CU headers
(src/HEVCe.c:1272-1316) would encode, with no host work; with ops/cabac_scan
this gives exact rates for thousands of candidates at once.

Strategy: emit ops into a fixed "mega layout" with validity masks (a
last-significant segment followed by one fixed-size segment per coefficient
group in reverse scan order), then compact the valid ops to the front with
a prefix-sum scatter. The sequential dependencies (the c1 context chain
across CGs, the Golomb-Rice rparam within a CG) have closed forms or small
static loops.

Layout per CG (reverse scan order): [cg_sig 1][sig 16][gt1 8][gt2 1]
[sign 2][escape 16 x E_ESC].
"""
import functools

import numpy as np
import torch

from hevce_tpu_torch.bitstream import cabac as cb
from hevce_tpu_torch.bitstream import syntax as syn
from hevce_tpu_torch.ops import cabac_scan
from hevce_tpu_torch.ops import cabac_sim as sim
from hevce_tpu_torch.utils import device as _device

# ops per escaped coefficient: <=3 prefix chunks (plen <= 24) + 2 suffix
# chunks (slen <= 16), bypass runs of <= 8 bins each
E_ESC = 5
CG_SEG = 1 + 16 + 8 + 1 + 2 + 16 * E_ESC   # cg_sig, sig, gt1, gt2, signs, esc
LAST_SEG = 28
I32 = torch.int32


def _pack(kind, ctx, binv):
    return kind | (ctx << 2) | (binv << 10)


@functools.lru_cache(maxsize=None)
def _tables(sz: int):
    """static per-size tables for the three scan types (numpy), indexed
    [scan_type][...]:
      pos / ypos / xpos: (3, n) flat pixel index / coordinates per scan index
      sig_idx: (3, 4, n) sig ctx index per scan position and sig_ctx value
      cg_right / cg_below: (3, ncg2) CG scan index of the spatial right /
               below neighbour, -1 if outside
    Horizontal / vertical scans exist only for sz <= 8 (rows stay 0)."""
    n = sz * sz
    ncg = sz // 4
    ncg2 = ncg * ncg
    pos = np.zeros((3, n), np.int32)
    ypos = np.zeros((3, n), np.int32)
    xpos = np.zeros((3, n), np.int32)
    sig_idx = np.zeros((3, 4, n), np.int32)
    cg_right = np.full((3, ncg2), -1, np.int32)
    cg_below = np.full((3, ncg2), -1, np.int32)
    for st in range(3):
        if st != syn.SCAN_DIAG and sz > 8:
            continue
        tab = syn.scan_table(sz, st)
        pos[st] = tab[:, 0] * sz + tab[:, 1]
        ypos[st] = tab[:, 0]
        xpos[st] = tab[:, 1]
        cg_of_scan = {}
        for g in range(ncg2):
            y, x = tab[g * 16, 0] // 4, tab[g * 16, 1] // 4
            cg_of_scan[(y, x)] = g
        for g in range(ncg2):
            y, x = tab[g * 16, 0] // 4, tab[g * 16, 1] // 4
            if x + 1 < ncg:
                cg_right[st, g] = cg_of_scan[(y, x + 1)]
            if y + 1 < ncg:
                cg_below[st, g] = cg_of_scan[(y + 1, x)]
        for i in range(n):
            y, x = int(tab[i, 0]), int(tab[i, 1])
            for sc in range(4):
                sig_idx[st, sc, i] = syn.sig_ctx_idx(sz, False, st, y, x, sc)
    return dict(pos=pos, ypos=ypos, xpos=xpos, sig_idx=sig_idx,
                cg_right=cg_right, cg_below=cg_below)


@_device.cached_per_device
def _device_tables(sz: int, device: torch.device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in _tables(sz).items()}


def _group_index(t):
    """GROUP_INDEX[t] arithmetically (t in 0..31): t for t<4, else
    2*(bitlen(t)-1) + the bit below the MSB (H.265 last-significant
    grouping)."""
    blen = (1 + (t >= 2).to(I32) + (t >= 4).to(I32) + (t >= 8).to(I32)
            + (t >= 16).to(I32))
    msb1 = (t >> torch.clamp(blen - 2, min=0)) & 1
    return torch.where(t < 4, t, 2 * (blen - 1) + msb1)


def _min_in_group(g):
    """MIN_IN_GROUP[g] arithmetically: g for g<4, else (2+(g&1)) << (g/2 - 1)."""
    return torch.where(g < 4, g,
                       (2 + (g & 1)) << torch.clamp((g >> 1) - 1, min=0))


def _last_xy_ops(sz, st, y, x):
    """last-significant-XY segment ops (LAST_SEG slots) + valid mask.

    y/x/st: (lanes,) int32. Mirrors put_last_significant_xy
    (src/HEVCe.c:1046-1087) for luma."""
    addr = int(syn._LAST_ADDR[0][sz // 8])
    sft = int(syn._LAST_SFT[0][sz // 8])
    gmax = int(syn.GROUP_INDEX[sz - 1])

    ty = torch.where(st == syn.SCAN_VER, x, y)
    tx = torch.where(st == syn.SCAN_VER, y, x)
    gy = _group_index(ty)
    gx = _group_index(tx)
    zero = torch.zeros_like(y)
    ops, val = [], []

    def ctx_run(g, base_ctx):
        # g ctx-coded 1-bins at ctx base+(i>>sft), then a 0-bin if g < gmax
        for i in range(gmax):
            ops.append(zero + _pack(sim.KIND_CTX, base_ctx + (i >> sft), 1))
            val.append(i < g)
        ops.append(_pack(sim.KIND_CTX, 0, 0)
                   + ((base_ctx + (torch.clamp(g, max=gmax - 1) >> sft)) << 2))
        val.append(g < gmax)

    ctx_run(gx, cb.CTX_LAST_X + 5 * addr)
    ctx_run(gy, cb.CTX_LAST_Y + 5 * addr)

    # suffix bypass bits, one bin per op like the reference's per-bit
    # CABACputBins calls (src/HEVCe.c:1076-1086)
    maxsuf = max((gmax - 2) >> 1, 0)
    for t_coord, g in ((tx, gx), (ty, gy)):
        rem = t_coord - _min_in_group(g)
        nb = torch.where(g > 3, (g - 2) >> 1, 0)
        for i in range(maxsuf):
            bitpos = nb - 1 - i
            b = (rem >> torch.clamp(bitpos, min=0)) & 1
            ops.append(sim.KIND_BYPASS + (1 << 2) + (b << 6))
            val.append(bitpos >= 0)
    assert len(ops) <= LAST_SEG, len(ops)
    pad = LAST_SEG - len(ops)
    ops = torch.stack(ops + [zero] * pad, 1).to(I32)
    val = torch.stack(val + [zero.bool()] * pad, 1)
    return ops, val


def generate_put_coef_ops(sz: int, pmode, blk, code_zero_blocks: bool = False):
    """op strings for putCoef of (lanes, sz, sz) quantized blocks.

    pmode: (lanes,) int32 (selects the scan), blk: quantized levels.
    Returns (ops, valid): (lanes, TOTAL) mega-layout op words + validity.

    code_zero_blocks=False (cbf-guarded coding): all-zero lanes get no ops.
    code_zero_blocks=True mirrors the reference step-4 rate approximation
    (src/HEVCe.c:1516 calls putCoef unconditionally): an all-zero block
    encodes just last_significant_xy at (0,0)."""
    dev = blk.device
    T = _device_tables(sz, dev)
    n = sz * sz
    ncg2 = n // 16
    lanes = blk.shape[0]
    pmode = pmode.to(I32)

    # scan type from pmode (src/HEVCe.c:1134-1150)
    if sz <= 8:
        st = torch.where((pmode - 26).abs() <= 4, syn.SCAN_HOR,
                         torch.where((pmode - 10).abs() <= 4, syn.SCAN_VER,
                                     syn.SCAN_DIAG)).to(I32)
    else:
        st = torch.zeros_like(pmode)
    stl = st.long()

    flat = blk.reshape(lanes, n).to(I32)
    vals = flat.gather(1, T["pos"][stl].long())
    nz = vals != 0
    absv = vals.abs()
    sign = (vals < 0).to(I32)
    has_any = nz.any(1)
    idx = torch.arange(n, dtype=I32, device=dev)
    i_last = (idx * nz).amax(1)
    g_last = i_last // 16

    cg_nz = nz.reshape(lanes, ncg2, 16)
    cg_abs = absv.reshape(lanes, ncg2, 16)
    cg_sign = sign.reshape(lanes, ncg2, 16)
    sig_cg = cg_nz.any(2)

    # neighbour-CG significance -> sig_ctx per CG (src/HEVCe.c:1208-1211)
    def nbr(tab):
        t = tab[stl]
        return sig_cg.gather(1, t.clamp(min=0).long()) & (t >= 0)
    sig_ctx = (nbr(T["cg_below"]).to(I32) << 1) | nbr(T["cg_right"]).to(I32)

    # --- per-CG reverse-order nonzero ranking (k=15..0) ---
    nzi = cg_nz.to(I32)
    rev = nzi.flip(2)
    rank = (torch.cumsum(rev, 2, dtype=I32) - rev).flip(2)
    nnz = nzi.sum(2, dtype=I32)

    # j-th (reverse-order) nonzero's |value| and sign, j = 0..15
    jj = torch.arange(16, dtype=I32, device=dev)
    sel = ((rank[..., None] == jj) & cg_nz[..., None]).to(I32)  # (l, g, 16, j)
    a_j = (cg_abs[..., None] * sel).sum(2, dtype=I32)
    s_j = (cg_sign[..., None] * sel).sum(2, dtype=I32)

    a8 = a_j[..., :8]
    gt1 = (a8 > 1).to(I32)
    gt1_any_before = torch.cumsum(gt1, 2, dtype=I32) - gt1
    c1_j = torch.where(gt1_any_before > 0, 0,
                       torch.clamp(1 + jj[:8], max=3)).to(I32)
    ngt1 = gt1.sum(2, dtype=I32)
    c1_out = torch.where(ngt1 > 0, 0, torch.clamp(1 + torch.clamp(nnz, max=8),
                                                  max=3))
    # c1 chain across CGs in processing (reverse-scan) order
    # (src/HEVCe.c:1230-1233): c1 into CG g = c1_out of the previously
    # PROCESSED CG with nnz > 0, else 1
    c1_in = [None] * ncg2
    c1_run = torch.ones((lanes,), dtype=I32, device=dev)
    for g in range(ncg2 - 1, -1, -1):
        c1_in[g] = c1_run
        processed = (g <= g_last) & (nnz[:, g] > 0)
        c1_run = torch.where(processed, c1_out[:, g], c1_run)
    c1_in = torch.stack(c1_in, 1)

    gg = torch.arange(ncg2, dtype=I32, device=dev)
    # luma ctx_set: +2 if not the first CG, +1 if incoming c1 == 0
    ctx_set = (gg[None, :] != 0).to(I32) * 2 + (c1_in == 0).to(I32)
    # first gt1 coefficient's value (gt2 flag and escape base)
    gt1_mask = a8 > 1
    first_gt1 = gt1_mask & (torch.cumsum(gt1, 2) == 1)
    first_gt1_val = (a8 * first_gt1).sum(2, dtype=I32)
    has_gt1 = ngt1 > 0
    escape = (nnz > 8) | (ngt1 >= 2) | (has_gt1 & (first_gt1_val > 2))

    # escape values + rparam/first_coeff2 evolution (src/HEVCe.c:1254-1266)
    it16 = torch.arange(16, dtype=I32, device=dev)
    plens, slens, svals, dos = [], [], [], []
    rparam = torch.zeros((lanes, ncg2), dtype=I32, device=dev)
    seen_ge2 = torch.zeros((lanes, ncg2), dtype=torch.bool, device=dev)
    for j in range(16):
        a = a_j[..., j]
        base = 3 - seen_ge2.to(I32) if j < 8 else 1
        esc_v = a - base
        do = (j < nnz) & (esc_v >= 0) & escape
        r = rparam
        # case A: esc_v < 3<<r: prefix (len+1) bins, suffix r bins
        lenA = esc_v >> r
        # case B: the reference's length loop (at most 16 rounds), in closed
        # form: round m runs iff vv + 2^r >= 2^(r+m+1), monotone in m
        vv0 = esc_v - (3 << r)
        rounds = ((vv0 + (1 << r))[..., None]
                  >= (1 << (r[..., None] + 1 + it16))).sum(-1, dtype=I32)
        lenB = r + rounds
        vv = vv0 - ((1 << lenB) - (1 << r))
        isA = esc_v < (3 << r)
        plen = torch.where(isA, lenA + 1, 4 + lenB - r)
        slen = torch.where(isA, r, lenB)
        sval = torch.where(isA, esc_v & ((1 << r.clamp(min=0)) - 1), vv)
        plens.append(torch.where(do, plen, 0))
        slens.append(torch.where(do, slen, 0))
        svals.append(sval)
        dos.append(do)
        rparam = torch.where(do & (a > (3 << r)), torch.clamp(r + 1, max=4),
                             rparam)
        seen_ge2 = seen_ge2 | ((j < nnz) & (a >= 2))
    esc_plen = torch.stack(plens, 2)
    esc_slen = torch.stack(slens, 2)
    esc_sval = torch.stack(svals, 2)
    esc_do = torch.stack(dos, 2)

    # --- the mega layout ---
    in_range = gg[None, :] <= g_last[:, None]                   # (lanes, ncg2)
    is_lastcg = gg[None, :] == g_last[:, None]

    cg_sig_op = (_pack(sim.KIND_CTX, 0, 0)
                 + ((cb.CTX_SIG_MAP + (sig_ctx != 0).to(I32)) << 2)
                 + (sig_cg.to(I32) << 10))[:, :, None]
    cg_sig_val = (in_range & ~is_lastcg & (gg[None, :] != 0))[:, :, None]

    # sig bins (lanes, ncg2, 16) built k-ascending, then flipped to k=15..0;
    # ctx index per (scan type, sig_ctx) from the static table
    sig_tab = T["sig_idx"].reshape(3, 4, ncg2, 16)
    cidx = sig_tab[stl[:, None], sig_ctx.long(), gg.long()[None, :]]
    sig_op = (_pack(sim.KIND_CTX, 0, 0) + ((cb.CTX_SIG_SC + cidx) << 2)
              + (nzi << 10))
    kk = jj
    i_scan = gg[None, :, None] * 16 + kk[None, None, :]
    nnz_after = nnz[:, :, None] - torch.cumsum(nzi, 2, dtype=I32)
    sig_val = (in_range[:, :, None]
               & torch.where(is_lastcg[:, :, None],
                             i_scan < i_last[:, None, None], True)
               & ((gg[None, :, None] == 0)
                  | (sig_cg[:, :, None]
                     & ((kk[None, None, :] != 0) | (nnz_after > 0)))))
    sig_op = sig_op.flip(2)
    sig_val = sig_val.flip(2)

    # gt1 (lanes, ncg2, 8)
    gt1_op = (_pack(sim.KIND_CTX, 0, 0)
              + ((cb.CTX_ONE_SC + 4 * ctx_set[:, :, None] + c1_j) << 2)
              + (gt1 << 10))
    gt1_val = in_range[:, :, None] & (jj[None, None, :8] < nnz[:, :, None])

    # gt2 (lanes, ncg2, 1)
    gt2_op = (_pack(sim.KIND_CTX, 0, 0) + ((cb.CTX_ABS_SC + ctx_set) << 2)
              + ((first_gt1_val > 2).to(I32) << 10))[:, :, None]
    gt2_val = (in_range & has_gt1)[:, :, None]

    # signs: one or two bypass chunks per CG (MSB-first collected value)
    sign_value = (s_j << torch.clamp(nnz[:, :, None] - 1 - jj[None, None, :],
                                     0, 31)).sum(2, dtype=I32)
    c1n = torch.clamp(nnz, max=8)
    c2n = torch.clamp(nnz - 8, 0, 8)
    s_chunk1 = (sign_value >> c2n) & 0xFF
    s_chunk2 = sign_value & ((1 << c2n) - 1)
    sign_op = torch.stack([sim.KIND_BYPASS + (c1n << 2) + (s_chunk1 << 6),
                           sim.KIND_BYPASS + (c2n << 2) + (s_chunk2 << 6)], 2)
    sign_val = torch.stack([in_range & (nnz > 0), in_range & (nnz > 8)], 2)

    # escapes: per coeff <=3 prefix chunks ((plen-1) ones + a 0), 2 suffix
    def chunk_lens(total, maxchunks):
        return [torch.clamp(total - 8 * k, 0, 8) for k in range(maxchunks)]

    p1, p2, p3 = chunk_lens(esc_plen, 3)

    # the chunk holding the final 0-bin is the last nonempty one
    def pre_val(lk, is_last):
        full = (1 << lk) - 1
        return torch.where(is_last, full - 1, full)
    pv1 = pre_val(p1, esc_plen <= 8)
    pv2 = pre_val(p2, esc_plen <= 16)
    pv3 = pre_val(p3, torch.ones_like(esc_do))
    s1, s2 = chunk_lens(esc_slen, 2)
    sv1 = (esc_sval >> s2) & 0xFF
    sv2 = esc_sval & ((1 << s2) - 1)
    esc_op = torch.stack([sim.KIND_BYPASS + (p1 << 2) + (pv1 << 6),
                          sim.KIND_BYPASS + (p2 << 2) + (pv2 << 6),
                          sim.KIND_BYPASS + (p3 << 2) + (pv3 << 6),
                          sim.KIND_BYPASS + (s1 << 2) + (sv1 << 6),
                          sim.KIND_BYPASS + (s2 << 2) + (sv2 << 6)],
                         3).reshape(lanes, ncg2, 16 * E_ESC)
    doin = esc_do & in_range[:, :, None]
    esc_val = torch.stack([v & doin for v in (p1 > 0, p2 > 0, p3 > 0,
                                              s1 > 0, s2 > 0)],
                          3).reshape(lanes, ncg2, 16 * E_ESC)

    cg_ops = torch.cat([cg_sig_op, sig_op, gt1_op, gt2_op, sign_op, esc_op],
                       2).to(I32)                        # (lanes, ncg2, CG_SEG)
    cg_vals = torch.cat([cg_sig_val, sig_val, gt1_val, gt2_val, sign_val,
                         esc_val], 2)
    # CGs in processing order (g = ncg2-1 .. 0)
    cg_ops = cg_ops.flip(1).reshape(lanes, ncg2 * CG_SEG)
    cg_vals = cg_vals.flip(1).reshape(lanes, ncg2 * CG_SEG)

    # (y, x) of the last significant position
    il = i_last.long()[:, None]
    ly = T["ypos"][stl].gather(1, il)[:, 0]
    lx = T["xpos"][stl].gather(1, il)[:, 0]
    lops, lval = _last_xy_ops(sz, st, ly, lx)

    ops = torch.cat([lops, cg_ops], 1)
    valid = torch.cat([lval, cg_vals], 1)
    if not code_zero_blocks:
        valid = valid & has_any[:, None]
    return ops, valid


def compact_ops(ops, valid, cap: int):
    """compact valid ops to the front; returns ((lanes, cap) nop-padded
    array, overflow flag per lane (total ops > cap: the host arbiter
    trial-encodes those), op counts)."""
    lanes = ops.shape[0]
    vi = valid.to(I32)
    pos = torch.cumsum(vi, 1, dtype=I32) - 1
    total = vi.sum(1, dtype=I32)
    out = torch.full((lanes, cap + 1), sim.KIND_NOP, dtype=I32,
                     device=ops.device)
    tgt = torch.where(valid, torch.clamp(pos, max=cap), cap)
    out.scatter_(1, tgt.long(), torch.where(valid, ops, sim.KIND_NOP))
    return (out[:, :cap].contiguous(), total > cap,
            torch.clamp(total, max=cap))


@functools.lru_cache(maxsize=None)
def _palette(sz: int, full_trial: bool):
    """static context palette: the ctx indices a trial at this size can
    touch (~40-70 of 142), so a lane carries P slots instead of 142.

    Returns (palette (P,), remap (256,)): palette[p] = full ctx index,
    remap[full] = palette slot (unreachable -> 0, never emitted)."""
    idxs = set()
    # a full trial codes residuals at size sz (single TU) AND sz/2 (TU split)
    for s in ((sz, sz // 2) if full_trial and sz > 4 else (sz,)):
        T = _tables(s)
        gmax = int(syn.GROUP_INDEX[s - 1])
        addr = int(syn._LAST_ADDR[0][s // 8])
        sft = int(syn._LAST_SFT[0][s // 8])
        idxs.update((cb.CTX_SIG_SC + v) for v in np.unique(T["sig_idx"]).tolist())
        for g in range(gmax + 1):
            idxs.add(cb.CTX_LAST_X + 5 * addr + (g >> sft))
            idxs.add(cb.CTX_LAST_Y + 5 * addr + (g >> sft))
    idxs.update(cb.CTX_SIG_MAP + k for k in (0, 1))
    idxs.update(cb.CTX_ONE_SC + k for k in range(16))      # luma ctx_set 0..3
    idxs.update(cb.CTX_ABS_SC + k for k in range(4))
    if full_trial:
        idxs.update(cb.CTX_SPLIT_CU + k for k in range(3))
        idxs.update((cb.CTX_PARTSIZE, cb.CTX_Y_PMODE, cb.CTX_UV_PMODE))
        idxs.update(cb.CTX_SPLIT_TU + k for k in range(3))
        idxs.update(cb.CTX_Y_QT_CBF + k for k in (0, 1))
        idxs.add(cb.CTX_UV_QT_CBF)
    palette = np.array(sorted(idxs), np.int32)
    remap = np.zeros(256, np.int32)
    remap[palette] = np.arange(len(palette), dtype=np.int32)
    return palette, remap


@_device.cached_per_device
def _palette_tensors(sz: int, full_trial: bool, device: torch.device):
    """_palette(sz, full_trial) on `device`, uploaded once: (palette as
    int64 indices, remap)."""
    palette, remap = _palette(sz, full_trial)
    return (torch.as_tensor(palette, device=device).long(),
            torch.as_tensor(remap, device=device))


def remap_ctx_ops(ops, remap):
    """rewrite the ctx-index field of context-coded ops into palette slots;
    remap: the (256,) table of _palette (numpy or a tensor)."""
    remap = torch.as_tensor(remap, device=ops.device)
    kind = ops & 3
    new_cidx = remap[((ops >> 2) & 0xFF).long()]
    rebuilt = sim.KIND_CTX | (new_cidx << 2) | (ops & (1 << 10))
    return torch.where(kind == sim.KIND_CTX, rebuilt, ops)


def _mpm3(left, above):
    """3-entry MPM derivation (src/HEVCe.c:958-977); (lanes,) ints."""
    third_neq = torch.where((left != 0) & (above != 0), 0,
                            torch.where(left + above < 2, 26, 1))
    m0 = torch.where(left != above, left,
                     torch.where(left > 1, left, 0))
    m1 = torch.where(left != above, above,
                     torch.where(left > 1, ((left + 29) % 32) + 2, 1))
    m2 = torch.where(left != above, third_neq,
                     torch.where(left > 1, ((left - 1) % 32) + 2, 26))
    return m0.to(I32), m1.to(I32), m2.to(I32)


def generate_cu_header_ops(sz: int, tu_split: bool, pmode, pmode_left,
                           pmode_above, gl, ga, split_cu_coded: bool = True):
    """ops for a 2Nx2N CU header up to (but excluding) the Y cbf and the
    coefficients: [split_cu=0][part_size][pmode MPM bins][uv_pmode]
    [split_tu][cbf U][cbf V].

    All (lanes,) inputs; returns (ops (lanes, 16), valid). Mirrors the
    put_cu_2nx2n / put_cu_2nx2n_tusplit headers (src/HEVCe.c:1272-1316)."""
    pmode = pmode.to(I32)
    pmode_left = pmode_left.to(I32)
    pmode_above = pmode_above.to(I32)
    zero = torch.zeros_like(pmode)
    t = torch.ones_like(pmode, dtype=torch.bool)
    ops, val = [], []

    def put(kind, cidx, b, cond):
        ops.append(_pack(kind, 0, 0) + (cidx << 2) + (b << 10))
        val.append(cond)

    if split_cu_coded and sz >= 16:
        put(sim.KIND_CTX, cb.CTX_SPLIT_CU + gl.to(I32) + ga.to(I32), zero, t)
    if sz == 8:   # part_size: 1 = 2Nx2N (src/HEVCe.c:952-955)
        put(sim.KIND_CTX, zero + cb.CTX_PARTSIZE, zero + 1, t)
    # pmode MPM coding (src/HEVCe.c:985-1018)
    m0, m1, m2 = _mpm3(pmode_left, pmode_above)
    hit = torch.where(pmode == m2, 2, torch.where(
        pmode == m1, 1, torch.where(pmode == m0, 0, -1)))
    is_hit = hit >= 0
    put(sim.KIND_CTX, zero + cb.CTX_Y_PMODE, is_hit.to(I32), t)
    rem = pmode - ((pmode > m0).to(I32) + (pmode > m1).to(I32)
                   + (pmode > m2).to(I32))
    # hit: two 1-bin bypass ops [hit>0][hit-1]; miss: ONE 5-bin bypass chunk
    # (the reference emits rem with a single CABACputBins(rem, 5))
    ops.append(torch.where(
        is_hit, sim.KIND_BYPASS + (1 << 2) + ((hit > 0).to(I32) << 6),
        sim.KIND_BYPASS + (5 << 2) + ((rem & 31) << 6)))
    val.append(t)
    ops.append(sim.KIND_BYPASS + (1 << 2) + (torch.clamp(hit - 1, min=0) << 6))
    val.append(is_hit & (hit > 0))
    # uv pmode (always bin 0, src/HEVCe.c:1021-1023)
    put(sim.KIND_CTX, zero + cb.CTX_UV_PMODE, zero, t)
    # split_tu flag (src/HEVCe.c:1026-1033)
    if sz in (32, 16, 8):
        put(sim.KIND_CTX, zero + cb.CTX_SPLIT_TU + {32: 0, 16: 1, 8: 2}[sz],
            zero + int(tu_split), t)
    # U/V cbf = 0 at depth 0 (src/HEVCe.c:1286-1287)
    for _ in range(2):
        put(sim.KIND_CTX, zero + cb.CTX_UV_QT_CBF + 0, zero, t)
    assert len(ops) <= 16
    pad = 16 - len(ops)
    return (torch.stack(ops + [zero] * pad, 1).to(I32),
            torch.stack(val + [~t] * pad, 1))


def generate_cu_2nx2n_ops(sz: int, pmode, pmode_left, pmode_above, gl, ga,
                          blk):
    """full step-2 trial ops: header + [Y cbf] + putCoef
    (src/HEVCe.c:1272-1291). blk: (lanes, sz, sz) quantized levels.
    Returns (ops, valid) in the mega layout."""
    h_ops, h_val = generate_cu_header_ops(sz, False, pmode, pmode_left,
                                          pmode_above, gl, ga)
    lanes = pmode.shape[0]
    cbf = (blk.reshape(lanes, -1) != 0).any(1)
    cbf_op = (_pack(sim.KIND_CTX, cb.CTX_Y_QT_CBF + 1, 0)
              + (cbf.to(I32) << 10))
    c_ops, c_val = generate_put_coef_ops(sz, pmode, blk)
    c_val = c_val & cbf[:, None]
    return (torch.cat([h_ops, cbf_op[:, None], c_ops], 1),
            torch.cat([h_val, torch.ones_like(cbf)[:, None], c_val], 1))


def generate_cu_tusplit_ops(sz: int, pmode, pmode_left, pmode_above, gl, ga,
                            blk4):
    """full step-3 trial ops: header + 4x([Y cbf at depth 1] + putCoef(h))
    (src/HEVCe.c:1294-1316). blk4: (lanes, 4, h, h)."""
    h = sz // 2
    h_ops, h_val = generate_cu_header_ops(sz, True, pmode, pmode_left,
                                          pmode_above, gl, ga)
    lanes = pmode.shape[0]
    parts_o, parts_v = [h_ops], [h_val]
    for isub in range(4):
        sub = blk4[:, isub]
        cbf = (sub.reshape(lanes, -1) != 0).any(1)
        cbf_op = (_pack(sim.KIND_CTX, cb.CTX_Y_QT_CBF + 0, 0)
                  + (cbf.to(I32) << 10))
        c_ops, c_val = generate_put_coef_ops(h, pmode, sub)
        parts_o += [cbf_op[:, None], c_ops]
        parts_v += [torch.ones_like(cbf)[:, None], c_val & cbf[:, None]]
    return torch.cat(parts_o, 1), torch.cat(parts_v, 1)


def put_coef_trials(sz: int, qpd6: int, pmode, blk, cap=None):
    """the rate scan's inputs for fresh-coder putCoef rates of (lanes, sz,
    sz) blocks: (fresh coder state on the size's palette, (lanes, cap)
    packed ops, op counts, overflow flags). Overflowing lanes (pathological
    op counts) need the host's trial encode."""
    if cap is None:
        # worst-case op counts with chunked bypass runs: overflow-free
        cap = {4: 256, 8: 512, 16: 2048, 32: 7168}[sz]
    # step-4 semantics: zero blocks still encode a (0,0) last-XY
    ops, valid = generate_put_coef_ops(sz, pmode, blk, code_zero_blocks=True)
    palette, remap = _palette_tensors(sz, False, blk.device)
    packed, overflow, nops = compact_ops(remap_ctx_ops(ops, remap), valid, cap)
    state = sim.initial_state(blk.shape[0], qpd6, blk.device)
    state["ctxs"] = state["ctxs"][:, palette].contiguous()
    return state, packed, nops, overflow


def put_coef_rates(sz: int, qpd6: int, pmode, blk, cap=None):
    """fresh-coder putCoef rates for (lanes, sz, sz) blocks, on blk's device
    (the rate scan is kernel K2 on CUDA tensors).

    Returns (rates (lanes,) int32, overflow (lanes,) bool)."""
    state, packed, nops, overflow = put_coef_trials(sz, qpd6, pmode, blk, cap)
    final = cabac_scan.advance_rates(state, packed, nops)
    return sim.bit_len(final).to(I32), overflow
