# Frozen copy of tools/pydecoder.py at commit 2c4bff8; its tables imported from the frozen copies beside it.
# Edit only to follow a change of what the benchmark compares.
#!/usr/bin/env python3
"""Readable-spec HEVC intra decoder for this encoder's stream subset.

Python mirror of the native decoder (csrc/hevce_host.cpp `namespace dec`),
used for debugging and as an extra cross-check on tiny images. Decodes the
pre-deblocking reconstruction (== the encoder's recon contract; the emitted
headers signal deblocking with beta/tc=0, which affects only display output —
HEVC intra prediction always uses unfiltered samples).

decode(stream) returns the reconstruction as a uint8 array.
"""
import numpy as np

from benchmark.reference import cabac_tables as cb
from benchmark.reference import constants as C
from benchmark.reference import syntax_tables as sx

VERBOSE = False


def _log(*a):
    if VERBOSE:
        print(*a)


def unescape(b):
    out = bytearray()
    zr = 0
    for x in b:
        if zr >= 2 and x == 3:
            zr = 0
            continue
        out.append(x)
        zr = zr + 1 if x == 0 else 0
    return bytes(out)


class BitReader:
    def __init__(self, b):
        self.b = b
        self.p = 0

    def bit(self):
        v = (self.b[self.p >> 3] >> (7 - (self.p & 7))) & 1
        self.p += 1
        return v

    def bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def ue(self):
        z = 0
        while self.bit() == 0:
            z += 1
        return (1 << z) - 1 + (self.bits(z) if z else 0)

    def se(self):
        k = self.ue()
        return (k + 1) // 2 if k & 1 else -(k // 2)


class CabacDec:
    """H.265 9.3.4.3 arithmetic decoding over the slice RBSP."""

    def __init__(self, data):
        self.b = data
        self.p = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self.rbit()

    def rbit(self):
        if self.p >> 3 >= len(self.b):
            self.p += 1
            return 0
        v = (self.b[self.p >> 3] >> (7 - (self.p & 7))) & 1
        self.p += 1
        return v

    def bin(self, ctxs, idx):
        v = ctxs[idx]
        lps = int(cb.LPS_TABLE[v >> 1][(self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            b = 1 - (v & 1)
            self.offset -= self.range
            self.range = lps
            ctxs[idx] = cb.NEXT_STATE_LPS[v]
        else:
            b = v & 1
            ctxs[idx] = cb.NEXT_STATE_MPS[v]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.rbit()
        return b

    def bypass(self):
        self.offset = (self.offset << 1) | self.rbit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def bypass_bits(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bypass()
        return v

    def terminate(self):
        self.range -= 2
        if self.offset >= self.range:
            return 1
        if self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.rbit()
        return 0


def parse_headers(stream):
    starts = []
    i = 0
    while i + 2 < len(stream):
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    nals = [(s, stream[s:(starts[j + 1] - 3 if j + 1 < len(starts) else len(stream))])
            for j, s in enumerate(starts)]
    width = height = qpd6 = None
    init_qp = 0
    for off, nal in nals:
        t = (nal[0] >> 1) & 0x3F
        r = BitReader(unescape(nal))
        if t == 33:                              # SPS
            r.bits(16)
            r.bits(8)                            # vps id / layers / nesting
            r.bits(96)                           # profile_tier_level
            r.ue()
            assert r.ue() == 1                   # 4:2:0
            width, height = r.ue(), r.ue()
            if r.bit():
                for _ in range(4):
                    r.ue()
            assert r.ue() == 0 and r.ue() == 0   # 8-bit
            r.ue()
            r.bit()
            r.ue(); r.ue(); r.ue()
            assert r.ue() == 0 and r.ue() == 2   # CB 8..32
            assert r.ue() == 0 and r.ue() == 3   # TB 4..32
            r.ue()
            assert r.ue() == 1                   # intra TU depth
            assert r.bits(4) == 0                # scaling/amp/sao/pcm off
        elif t == 34:                            # PPS
            r.bits(16)
            r.ue(); r.ue()
            r.bit(); r.bit(); r.bits(3)
            assert r.bit() == 0                  # sign hiding off
            r.bit()
            r.ue(); r.ue()
            init_qp = 26 + r.se()
        elif 16 <= t <= 21:                      # IRAP slice
            r.bits(16)
            assert r.bit() == 1                  # first slice segment
            r.bit()                              # no_output_of_prior_pics
            r.ue()                               # pps id
            assert r.ue() == 2                   # I slice
            qp = init_qp + r.se()
            qpd6 = (qp - 4) // 6
            # deblocking override group (present in this subset's headers)
            if r.bit():
                if r.bit() == 0:
                    r.se(); r.se()
                    r.bit()                      # loop filter across slices
            assert r.bit() == 1                  # alignment
            while r.p & 7:
                assert r.bit() == 0
            return width, height, qpd6, off, r.p // 8
    raise ValueError("no slice")


def probable_modes(left, above):
    return list(sx.probable_pmodes(left, above))


def parse_pmode_value(d, flag, pl, pa):
    mpm = probable_modes(pl, pa)
    if flag:
        idx = 0
        if d.bypass():
            idx = 1 + d.bypass()
        return mpm[idx]
    pm = d.bypass_bits(5)
    for m in sorted(mpm):
        if pm >= m:
            pm += 1
    return pm


def parse_last_xy(d, ctxs, sz, stype):
    szi = sz // 8
    addr, sft = sx._LAST_ADDR[0][szi], sx._LAST_SFT[0][szi]
    gmax = int(sx.GROUP_INDEX[sz - 1])
    gx = gy = 0
    while gx < gmax and d.bin(ctxs, cb.CTX_LAST_X + 5 * addr + (gx >> sft)):
        gx += 1
    while gy < gmax and d.bin(ctxs, cb.CTX_LAST_Y + 5 * addr + (gy >> sft)):
        gy += 1
    tx, ty = gx, gy
    if gx > 3:
        tx = int(sx.MIN_IN_GROUP[gx]) + d.bypass_bits((gx - 2) >> 1)
    if gy > 3:
        ty = int(sx.MIN_IN_GROUP[gy]) + d.bypass_bits((gy - 2) >> 1)
    y, x = (tx, ty) if stype == sx.SCAN_VER else (ty, tx)
    return y, x


def read_exgolomb(d, rparam):
    k = 0
    while d.bypass():
        k += 1
        assert k < 40
    if k <= 2:
        return (k << rparam) + d.bypass_bits(rparam)
    ln = k - 3 + rparam
    return (3 << rparam) + (1 << ln) - (1 << rparam) + d.bypass_bits(ln)


def parse_coef(d, ctxs, sz, pmode):
    stype, scan_yx = sx.get_scan(sz, pmode)
    scan = scan_yx[:, 0] * sz + scan_yx[:, 1]
    inv = np.empty(sz * sz, np.int32)
    inv[scan] = np.arange(sz * sz)
    ncg = sz // 4
    blk = np.zeros((sz, sz), np.int32)
    ly, lx = parse_last_xy(d, ctxs, sz, stype)
    i_last = int(inv[ly * sz + lx])
    _log(f"    last=({ly},{lx}) i_last={i_last} stype={stype}")
    sig_map = np.zeros((8, 8), bool)
    sctx, c1, nnz = 0, 1, 0
    pos_nz = []
    sig_cg = True
    for i in range(i_last, -1, -1):
        p = int(scan[i])
        y, x = p // sz, p % sz
        ycg, xcg = y >> 2, x >> 2
        is_final = i == i_last
        first_cg = ycg == 0 and xcg == 0
        first_in_cg = (i & 15) == 0
        final_in_cg = ((i & 15) == 15) or is_final
        if final_in_cg:
            right = xcg < ncg - 1 and sig_map[ycg][xcg + 1]
            below = ycg < ncg - 1 and sig_map[ycg + 1][xcg]
            sctx = (int(below) << 1) | int(right)
            nnz = 0
            pos_nz = []
            if not first_cg and not is_final:
                sig_cg = bool(d.bin(ctxs, cb.CTX_SIG_MAP + (sctx != 0)))
            else:
                sig_cg = True
            sig_map[ycg][xcg] = sig_cg
        if is_final:
            sig = 1
        elif first_cg or (sig_cg and (not first_in_cg or nnz > 0)):
            idx = sx.sig_ctx_idx(sz, False, stype, y, x, sctx)
            sig = d.bin(ctxs, cb.CTX_SIG_SC + idx)
        else:
            sig = 1 if (sig_cg and first_in_cg) else 0
        if sig:
            pos_nz.append(p)
            nnz += 1
        if first_in_cg and nnz > 0:
            cset = (2 if not first_cg else 0) + (1 if c1 == 0 else 0)
            g1 = []
            c2j = -1
            c1 = 1
            for j in range(min(8, nnz)):
                g1.append(d.bin(ctxs, cb.CTX_ONE_SC + 4 * cset + c1))
                if g1[j]:
                    c1 = 0
                    if c2j < 0:
                        c2j = j
                elif 0 < c1 < 3:
                    c1 += 1
            c2v = 0
            if c1 == 0 and c2j >= 0:
                c2v = d.bin(ctxs, cb.CTX_ABS_SC + cset)
            signs = d.bypass_bits(nnz)
            absv = [0] * nnz
            fc2, rparam = 3, 0
            for j in range(nnz):
                thr = fc2 if j < 8 else 1
                if j >= 8:
                    coded, base = True, thr
                elif not g1[j]:
                    coded, base = False, 1
                elif j == c2j:
                    coded, base = (c2v == 1), (thr if c2v else 2)
                else:
                    coded, base = True, thr
                if coded:
                    rem = read_exgolomb(d, rparam)
                    absv[j] = base + rem
                    if absv[j] > (3 << rparam):
                        rparam = min(rparam + 1, 4)
                else:
                    absv[j] = base
                if absv[j] >= 2:
                    fc2 = 2
            for j in range(nnz):
                s = (signs >> (nnz - 1 - j)) & 1
                blk[pos_nz[j] // sz, pos_nz[j] % sz] = -absv[j] if s else absv[j]
            _log(f"    CG@i={i}: nnz={nnz} absv={absv} g1={g1} c2j={c2j} c2v={c2v}")
    return blk


# --- numpy reconstruction (mirrors reference src/HEVCe.c:191-516) ----------------

def _build_borders(sz, top, left, bll, blb, baa, bar):
    n2 = 2 * sz
    bla = top[0] if (bll and baa) else left[0] if bll else top[1] if baa else 128
    ublb = np.empty(n2, np.int32)
    ubar = np.empty(n2, np.int32)
    ublb[:sz] = left[:sz] if bll else bla
    ublb[sz:] = left[sz:] if blb else ublb[sz - 1]
    ubar[:sz] = top[1:1 + sz] if baa else bla
    ubar[sz:] = top[1 + sz:1 + n2] if bar else ubar[sz - 1]
    fbla = (2 + ublb[0] + ubar[0] + 2 * bla) >> 2
    fblb = ublb.copy()
    fbar = ubar.copy()
    fblb[0] = (2 + 2 * ublb[0] + ublb[1] + bla) >> 2
    fbar[0] = (2 + 2 * ubar[0] + ubar[1] + bla) >> 2
    fblb[1:n2 - 1] = (2 + 2 * ublb[1:n2 - 1] + ublb[:n2 - 2] + ublb[2:]) >> 2
    fbar[1:n2 - 1] = (2 + 2 * ubar[1:n2 - 1] + ubar[:n2 - 2] + ubar[2:]) >> 2
    return int(bla), ublb, ubar, int(fbla), fblb, fbar


def _predict(sz, pmode, borders):
    bla0, ublb, ubar, fbla, fblb, fbar = borders
    filt = bool(C.FILTER_BORDER_Y[sz][pmode])
    bla = fbla if filt else bla0
    blb = fblb if filt else ublb
    bar = fbar if filt else ubar
    edge = sz <= 16
    dst = np.empty((sz, sz), np.int32)
    if pmode == 0:
        j = np.arange(sz)
        i = np.arange(sz)[:, None]
        hp = (sz - j - 1) * blb[i] + (j + 1) * bar[sz]
        vp = (sz - i - 1) * bar[j][None, :] + (i + 1) * blb[sz]
        dst = (sz + hp + vp) // (sz * 2)
    elif pmode == 1:
        dc = (sz + blb[:sz].sum() + bar[:sz].sum()) // (sz * 2)
        dst[:] = dc
        if edge:
            dst[0, 0] = (2 + 2 * dc + blb[0] + bar[0]) >> 2
            dst[0, 1:] = (2 + 3 * dc + bar[1:sz]) >> 2
            dst[1:, 0] = (2 + 3 * dc + blb[1:sz]) >> 2
    elif pmode == 10:
        dst[:] = blb[:sz][:, None]
        if edge:
            dst[0, :] = np.clip(((bar[:sz] - bla) >> 1) + dst[0, :], 0, 255)
    elif pmode == 26:
        dst[:] = bar[:sz][None, :]
        if edge:
            dst[:, 0] = np.clip(((blb[:sz] - bla) >> 1) + dst[:, 0], 0, 255)
    else:
        horiz = pmode < 18
        angle = int(C.ANGLE_TABLE[pmode])
        invang = int(C.ABS_INV_ANGLE_TABLE[pmode])
        main = blb if horiz else bar
        side = bar if horiz else blb
        # +2: at angle=32, i=sz-1 the p2 slice reaches base+2+sz+sz even
        # though its weight `of` is 0 (the reference reads the dead value
        # too, src/HEVCe.c:342-380; numpy would truncate the slice instead)
        ref = np.zeros(4 * 32 + 2, np.int32)
        base = 2 * 32
        ref[base] = bla
        ref[base + 1:base + 1 + 2 * sz] = side[:2 * sz]
        for i in range(-1, (sz * angle) >> 5, -1):
            ref[base + i] = ref[base + ((128 - invang * i) >> 8)]
        ref[base + 1:base + 1 + 2 * sz] = main[:2 * sz]
        for i in range(sz):
            off = angle * (i + 1)
            oi, of = off >> 5, off & 31
            p1 = ref[base + oi + 1:base + oi + 1 + sz]
            p2 = ref[base + oi + 2:base + oi + 2 + sz]
            px = ((32 - of) * p1 + of * p2 + 16) >> 5
            if horiz:
                dst[:, i] = px
            else:
                dst[i, :] = px
    return dst


def _inverse_transform(sz, coef):
    m = C.TRANSFORM_MAT[sz].astype(np.int64)
    t = np.clip((m.T @ coef + 64) >> 7, -32768, 32767)
    return np.clip((t @ m + 2048) >> 12, -32768, 32767).astype(np.int32)


class Dec:
    def __init__(self, stream):
        w, h, qpd6, soff, coff = parse_headers(stream)
        self.qpd6 = qpd6
        self.yszn, self.xszn = h, w
        self.rcon = np.zeros((h, w), np.uint8)
        ntu_x = 1 + w // 4
        self.map_cu_sz = np.full((9, ntu_x), 32, np.uint8)
        self.map_pmode = np.full((9, ntu_x), 1, np.uint8)
        self.ctxs = cb.new_context_set(qpd6)
        self.ctu_y = 0
        end = len(stream)
        k = soff
        while k + 2 < len(stream):
            if stream[k] == 0 and stream[k + 1] == 0 and stream[k + 2] == 1:
                end = k
                break
            k += 1
        rbsp = unescape(stream[soff:end])
        self.d = CabacDec(rbsp[coff:])
        # optional decision-forest trace: set to [] before run() to collect
        # (y, x, sz, lay, pm, consumed_bits) per non-split CU — lay 1/2/3 =
        # 2Nx2N-single-TU / 2Nx2N-TU-split / NxN; consumed_bits counts the
        # slice bits from the node's first flag through its last coefficient
        # (tools/diff_forests.py uses this to compare fast vs exact forests)
        self.trace = None

    def recon_tu(self, y, x, sz, flags, pmode, coef):
        tx = np.clip(np.arange(x - 1, x + 2 * sz), 0, self.xszn - 1)
        ty = max(min(y - 1, self.yszn - 1), 0)
        top = self.rcon[ty, tx].astype(np.int32)
        ly = np.clip(np.arange(y, y + 2 * sz), 0, self.yszn - 1)
        lx = max(min(x - 1, self.xszn - 1), 0)
        left = self.rcon[ly, lx].astype(np.int32)
        borders = _build_borders(sz, top, left, *flags)
        pred = _predict(sz, pmode, borders)
        if coef is not None:
            dq = np.clip(coef << (C.DEQUANT_SHIFT[sz] + self.qpd6), -32768, 32767)
            res = _inverse_transform(sz, dq)
            pred = np.clip(pred + res, 0, 255)
        self.rcon[y:y + sz, x:x + sz] = pred.astype(np.uint8)

    def cu(self, y, x, sz, bll, blb, baa, bar):
        mr, mc = 1 + (y - self.ctu_y) // 4, 1 + x // 4
        gl = sz > self.map_cu_sz[mr, mc - 1]
        ga = sz > self.map_cu_sz[mr - 1, mc]
        pml = int(self.map_pmode[mr, mc - 1])
        pma = int(self.map_pmode[mr - 1, mc])
        ntu = sz // 4
        d, ctxs = self.d, self.ctxs
        p0 = d.p
        if sz >= 16 and d.bin(ctxs, cb.CTX_SPLIT_CU + int(gl) + int(ga)):
            sf = _sub_flags(bll, blb, baa, bar)
            h = sz // 2
            for k, (oy, ox) in enumerate(_SUB_OFFS):
                self.cu(y + oy * h, x + ox * h, h, *sf[k])
            return
        nxn = 0
        if sz == 8:
            nxn = d.bin(ctxs, cb.CTX_PARTSIZE) == 0
        if not nxn:
            flag = d.bin(ctxs, cb.CTX_Y_PMODE)
            pm = parse_pmode_value(d, flag, pml, pma)
            d.bin(ctxs, cb.CTX_UV_PMODE)
            tsplit = d.bin(ctxs, cb.CTX_SPLIT_TU + {32: 0, 16: 1, 8: 2}[sz])
            d.bin(ctxs, cb.CTX_UV_QT_CBF)
            d.bin(ctxs, cb.CTX_UV_QT_CBF)
            _log(f"CU ({y},{x}) sz={sz} 2Nx2N pm={pm} tsplit={tsplit}")
            if not tsplit:
                cbf = d.bin(ctxs, cb.CTX_Y_QT_CBF + 1)
                coef = parse_coef(d, ctxs, sz, pm) if cbf else None
                self.recon_tu(y, x, sz, (bll, blb, baa, bar), pm, coef)
            else:
                h = sz // 2
                sf = _sub_flags(bll, blb, baa, bar)
                for k, (oy, ox) in enumerate(_SUB_OFFS):
                    cbf = d.bin(ctxs, cb.CTX_Y_QT_CBF)
                    coef = parse_coef(d, ctxs, h, pm) if cbf else None
                    self.recon_tu(y + oy * h, x + ox * h, h, sf[k], pm, coef)
            self.map_cu_sz[mr:mr + ntu, mc:mc + ntu] = sz
            self.map_pmode[mr:mr + ntu, mc:mc + ntu] = pm
            if self.trace is not None:
                self.trace.append((y, x, sz, 2 if tsplit else 1, pm, d.p - p0))
        else:
            h = sz // 2
            sf = _sub_flags(bll, blb, baa, bar)
            flags4 = [d.bin(ctxs, cb.CTX_Y_PMODE) for _ in range(4)]
            pm4 = [0] * 4
            for k in range(4):
                if k == 0:
                    pl, pa = pml, pma
                elif k == 1:
                    pl, pa = pm4[0], int(self.map_pmode[mr - 1, 1 + (x + h) // 4])
                elif k == 2:
                    pl = int(self.map_pmode[1 + (y + h - self.ctu_y) // 4, mc - 1])
                    pa = pm4[0]
                else:
                    pl, pa = pm4[2], pm4[1]
                pm4[k] = parse_pmode_value(d, flags4[k], pl, pa)
            d.bin(ctxs, cb.CTX_UV_PMODE)
            d.bin(ctxs, cb.CTX_UV_QT_CBF)
            d.bin(ctxs, cb.CTX_UV_QT_CBF)
            _log(f"CU ({y},{x}) sz={sz} NxN pm={pm4}")
            for k, (oy, ox) in enumerate(_SUB_OFFS):
                cbf = d.bin(ctxs, cb.CTX_Y_QT_CBF)
                coef = parse_coef(d, ctxs, h, pm4[k]) if cbf else None
                self.recon_tu(y + oy * h, x + ox * h, h, sf[k], pm4[k], coef)
            self.map_cu_sz[mr:mr + ntu, mc:mc + ntu] = sz
            self.map_pmode[mr, mc] = pm4[0]
            self.map_pmode[mr, mc + 1] = pm4[1]
            self.map_pmode[mr + 1, mc] = pm4[2]
            self.map_pmode[mr + 1, mc + 1] = pm4[3]
            if self.trace is not None:
                self.trace.append((y, x, sz, 3, pm4[0], d.p - p0))

    def run(self):
        for y in range(0, self.yszn, 32):
            self.ctu_y = y
            for x in range(0, self.xszn, 32):
                bll, baa = x > 0, y > 0
                bar = baa and (x + 32 < self.xszn)
                self.cu(y, x, 32, bll, False, baa, bar)
                last = (y + 32 >= self.yszn) and (x + 32 >= self.xszn)
                end = self.d.terminate()
                # final flag accepted as 0 or 1: the reference flush truncates
                # bit 7 of low (src/HEVCe.c:849-855), so the last
                # end_of_slice_segment_flag misdecodes as 0 on ~half of all
                # streams in a strict decoder; the picture is complete anyway
                assert last or end == 0, f"slice ended early at CTU ({y},{x})"
            self.map_cu_sz[0, 1:] = self.map_cu_sz[8, 1:]
        return self.rcon


_SUB_OFFS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _sub_flags(bll, blb, baa, bar):
    return ((bll, bll, baa, baa),
            (True, False, baa, bar),
            (bll, blb, True, True),
            (True, False, True, False))


def decode(stream):
    return Dec(stream).run()
