# Frozen copy of hevce_tpu/bitstream/cabac.py at commit 2c4bff8; its tables and context initialisation only (the encoder class is left out).
# Edit only to follow a change of what the benchmark compares.
"""HEVC binary arithmetic encoder (CABAC) + context model, clean-room Python.

Behavioral contract mirrors the reference coder (reference src/HEVCe.c:697-933):
9-bit range / 32-bit low with deferred carry resolution via an outstanding-FF
count, emulation-prevention 0x03 insertion inside the byte sink, and an exact
fractional bit-length oracle `bit_len()` used for all RD decisions
(CABAClen, src/HEVCe.c:835-837).

State-transition and LPS tables are standard H.265 data (ITU-T H.265 tables
9-41/9-42 equivalents); the 128-entry next-state tables are generated from the
64-state TransIdxLPS table + MPS increment rule rather than embedded.
"""
import numpy as np

# --- standard H.265 context state machine -------------------------------------

# TransIdxLPS: next probability state after an LPS, per state 0..63 (H.265 9.3.4.3.2.2)
_TRANS_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 22, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63], np.int32)


def _gen_next_state():
    """128-entry next-state tables over packed ctx values v = 2*state + mps."""
    mps = np.zeros(128, np.uint8)
    lps = np.zeros(128, np.uint8)
    for v in range(128):
        s, m = v >> 1, v & 1
        # MPS: state+1 capped at 62 (values 124/125 self-loop; 126/127 reserved)
        if s == 63:
            mps[v] = v
        else:
            mps[v] = 2 * min(s + 1, 62) + m
        # LPS: MPS flips at state 0
        if s == 0:
            lps[v] = 1 - m
        else:
            lps[v] = 2 * int(_TRANS_LPS[s]) + m
    mps[126], mps[127] = 126, 127
    lps[126], lps[127] = 126, 127
    return mps, lps


NEXT_STATE_MPS, NEXT_STATE_LPS = _gen_next_state()

# rangeTabLPS (H.265 table 9-46): LPS range per (state, (range>>6)&3)
LPS_TABLE = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216], [123, 150, 178, 205],
    [116, 142, 169, 195], [111, 135, 160, 185], [105, 128, 152, 175], [100, 122, 144, 166],
    [95, 116, 137, 158], [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116], [66, 80, 95, 110],
    [62, 76, 90, 104], [59, 72, 86, 99], [56, 69, 81, 94], [53, 65, 77, 89],
    [51, 62, 73, 85], [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62], [35, 43, 51, 59],
    [33, 41, 48, 56], [32, 39, 46, 53], [30, 37, 43, 50], [29, 35, 41, 48],
    [27, 33, 39, 45], [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33], [19, 23, 27, 31],
    [18, 22, 26, 30], [17, 21, 25, 28], [16, 20, 23, 27], [15, 19, 22, 25],
    [14, 18, 21, 24], [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18], [10, 12, 15, 17],
    [10, 12, 14, 16], [9, 11, 13, 15], [9, 11, 12, 14], [8, 10, 12, 14],
    [8, 9, 11, 13], [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2]], np.int32)


# single-shot renorm shift per (lps >> 3): 6 for lps<8, else 5 - floor(log2(lps>>3))
RENORM_TABLE = np.array(
    [6] + [5 - (i.bit_length() - 1) for i in range(1, 32)], np.int32)


# --- context set ---------------------------------------------------------------

# named offsets into the flat 142-byte context vector (struct layout matches
# the reference ContextSet, src/HEVCe.c:745-759, so state dumps are comparable)
CTX_SPLIT_CU = 0        # [3]
CTX_PARTSIZE = 3
CTX_Y_PMODE = 4
CTX_UV_PMODE = 5
CTX_SPLIT_TU = 6        # [3]
CTX_Y_QT_CBF = 9        # [2]
CTX_UV_QT_CBF = 11      # [5]
CTX_LAST_X = 16         # [5][5]
CTX_LAST_Y = 41         # [5][5]
CTX_SIG_MAP = 66        # [2]
CTX_SIG_SC = 68         # [44]
CTX_ONE_SC = 112        # [24]
CTX_ABS_SC = 136        # [6]
NUM_CTX = 142

# H.265 initValue data for the intra slice contexts used by this encoder, in
# flat layout order (equivalent content to reference src/HEVCe.c:762-777).
CTX_INIT_VALUES = np.array(
    # split_cu[3], partsize, Y_pmode, UV_pmode, split_tu[3], Y_qt_cbf[2], UV_qt_cbf[5]
    [139, 141, 157] + [184] + [184] + [63] + [153, 138, 138] + [111, 141] +
    [94, 138, 182, 154, 154] +
    # last_x[5][5] rows: 4x4(3), 8x8(3), 16x16(4), 32x32(5), chroma(4) — flattened 5x5
    [110, 110, 124, 0, 0, 125, 140, 153, 0, 0, 125, 127, 140, 109, 0,
     111, 143, 127, 111, 79, 108, 123, 63, 154, 0] +
    [110, 110, 124, 0, 0, 125, 140, 153, 0, 0, 125, 127, 140, 109, 0,
     111, 143, 127, 111, 79, 108, 123, 63, 154, 0] +
    # sig_map[2]
    [91, 171] +
    # sig_sc[44]
    [111, 111, 125, 110, 110, 94, 124, 108, 124, 107, 125, 141, 179, 153,
     125, 107, 125, 141, 179, 153, 125, 107, 125, 141, 179, 153, 125, 141,
     140, 139, 182, 182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139,
     111, 111] +
    # one_sc[24]
    [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92, 139, 107,
     122, 152, 140, 179, 166, 182, 140, 227, 122, 197] +
    # abs_sc[6]
    [138, 153, 136, 167, 152, 152], np.uint8)

assert CTX_INIT_VALUES.shape == (NUM_CTX,)

def init_context_state(init_val: int, qpd6: int) -> int:
    """QP-dependent packed context init (H.265 9.3.2.2; reference src/HEVCe.c:727-735)."""
    qp = qpd6 * 6 + 4
    state = ((((init_val >> 4) * 5 - 45) * qp) >> 4) + ((init_val & 15) << 3) - 16
    state = min(max(state, 1), 126)
    if state >= 64:
        return ((state - 64) << 1) | 1
    return (63 - state) << 1


def new_context_set(qpd6: int) -> bytearray:
    """Fresh 142-entry packed context vector for a slice at the given qpd6."""
    return bytearray(init_context_state(int(v), qpd6) for v in CTX_INIT_VALUES)
