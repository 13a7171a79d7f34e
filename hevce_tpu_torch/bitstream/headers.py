"""VPS/SPS/PPS/slice-header emission for the fixed monochrome intra profile.

The parameter sets are constant for this encoder except the SPS picture size
(reference src/HEVCe.c:621-691): everything else is emitted as pre-escaped
constants. Only pic_width/height are Exp-Golomb coded at run time.
"""

VPS = bytes([0x00, 0x00, 0x01, 0x40, 0x01, 0x0C, 0x01, 0xFF, 0xFF, 0x03, 0x10,
             0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00,
             0x03, 0x00, 0xB4, 0xF0, 0x24])
SPS_PREFIX = bytes([0x00, 0x00, 0x01, 0x42, 0x01, 0x01, 0x03, 0x10, 0x00, 0x00,
                    0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03, 0x00, 0x00, 0x03,
                    0x00, 0xB4])
PPS = bytes([0x00, 0x00, 0x01, 0x44, 0x01, 0xC0, 0x90, 0x91, 0x81, 0xD9, 0x20])

SLICE_HEADER = {
    0: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x16, 0xDE]),
    1: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x10, 0xDE]),
    2: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x2B, 0x78]),
    3: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x4D, 0xE0]),
    4: bytes([0x00, 0x00, 0x01, 0x26, 0x01, 0xAC, 0x97, 0x80]),
}

# SPS bit runs around the picture-size fields (src/HEVCe.c:682-687); the
# 24-bit tail encodes max_transform_hierarchy_depth_intra = 1
_SPS_LEAD_BITS = (0x0A, 4)
_SPS_MID_BITS = (0x197EE4, 22)
_SPS_TAIL_BITS = (0x681ED1, 24)


class BitWriter:
    """MSB-first bit accumulator flushed to bytes with zero padding."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nacc = 0

    def bits(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.nacc += length
        while self.nacc >= 8:
            self.nacc -= 8
            self.out.append((self.acc >> self.nacc) & 0xFF)
        self.acc &= (1 << self.nacc) - 1

    def uvlc(self, value: int) -> None:
        """unsigned Exp-Golomb with the reference's length derivation
        (floor(log2(v+2)) prefix zeros; src/HEVCe.c:642-648)."""
        v = value + 1
        half = (v + 1).bit_length() - 1
        self.bits(0, half)
        self.bits(v & ((1 << (half + 1)) - 1), half + 1)

    def align(self) -> None:
        if self.nacc:
            self.bits(0, 8 - self.nacc)


def write_headers(qpd6: int, ysz: int, xsz: int) -> bytes:
    """All NAL headers preceding the slice data, for the padded picture
    size (ysz, xsz)."""
    bw = BitWriter()
    bw.bits(*_SPS_LEAD_BITS)
    bw.uvlc(xsz)
    bw.uvlc(ysz)
    bw.bits(*_SPS_MID_BITS)
    bw.bits(*_SPS_TAIL_BITS)
    bw.align()
    return VPS + SPS_PREFIX + bytes(bw.out) + PPS + SLICE_HEADER[qpd6]
