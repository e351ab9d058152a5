"""VP8, WebP's lossy bitstream (RFC 6386, key frames), decoded to the
pixels libwebp gives Pillow, and a key frame encoder for ``.webp``.

Decoding (`decode_vp8`), bit for bit libwebp's:

* the frame header (key frame, profile <= 3, shown, the partition sizes
  clamped to the data as libwebp does), the boolean decoder, the segment
  header and segment map, the filter header with the loop-filter deltas
  by reference frame and mode, 1 to 8 token partitions, the coefficient
  probability updates and the skip probability;
* the dequantization tables with libwebp's clamps (y2 DC x2, y2 AC x155/100
  at least 8, uv DC index at most 117, i.e. 132);
* per macroblock: intra modes (i16, i4 with its contexts, chroma), the
  tokens, the inverse WHT and DCT, the predictions from the unfiltered
  neighbours (127 above the frame, 129 left of it, the top-right of the
  macroblock reused by the i4 blocks below the first row, the rightmost
  macroblock's top-right replicated);
* the loop filter (normal and simple, sharpness, hev thresholds, inner
  edges where the macroblock has coefficients or is i4) in macroblock
  order, as libwebp's filtering of each row amounts to; libwebp turns the
  filter off when the frame level is 0, whatever the segments say;
* the crop to the frame size, libwebp's "fancy" upsampler (the 9-3-3-1
  filter with its two roundings) and its 14-bit fixed-point
  ``VP8YUVToR/G/B``. No dithering (libwebp's default).

Encoding (`encode_vp8`): the port's own key frame; what Pillow writes for
``.webp`` is libwebp's, whose bytes are not reproduced (its encoder's rate
control needs libwebp itself). The stages: RGB -> YUV 4:2:0 (libwebp's
``VP8RGBToY/U/V`` on 2x2 sums), the quantizer index from the quality by
libwebp's quality -> compression mapping, i16 / i4 / chroma mode choice by
distortion plus lambda times the tokens' cost under the default
probabilities, a loop-filter level from the AC step, then the token
statistics, the probability updates that pay for themselves, the skip
probability, and the boolean coder. Partitions, the simple filter and
segments are internal arguments (the tests write files Pillow's writer
cannot); ``.webp`` output uses one partition, one segment, the normal
filter.

The boolean decoder's per-macroblock decode and the macroblock encode and
token coding run in `native` (host C++) where g++ built it, else in the
Python twins here (`_decode_frame_py`, `_encode_mbs_py`,
`_write_tokens_py`), which give the same output.
"""

from __future__ import annotations

import numpy as np

from path_tracer_tpu_torch import native

# RFC 6386 13.4 coeff_update_probs, 13.5 default_coeff_probs ([type][band][ctx][node]) and
# 11.5 kf_bmode_probs ([above][left][node], modes in libwebp's order below), as bytes
_UPDATE_PROBA = np.frombuffer(bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ffffffffffffffffffdff1fcff"
    "fffffffffffffff9fdfdfffffffffffffffffff4fcffffffffffffffffeafefefffffffffffffffffdffffffffffffff"
    "fffffffff6feffffffffffffffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefefffffffffffffffffefffeffff"
    "fffffffffffffffefdfffefffffffffffffafffefffefffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefefffffffffffffffff8feffffff"
    "fffffffffff9fefffffffffffffffffffffffffffffffffffffffffffdfffffffffffffffffff7feffffffffffffffff"
    "fffffffffffffffffffffffffffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdfffffffffffffffffaffffffffffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "bafbfaffffffffffffffffeafbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffffffffffffffffffffffffffff"
    "fffffffffefffffffffffffffffffefefffffffffffffffffffefffffffffffffffffffffffffffffffffffffffffffe"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffff8fffffffffffffffffffffafefcfefffffffffffffff8fe"
    "f9fdfffffffffffffffffdfdfffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfefffffffffffffffff5fbfeffffffffffffff"
    "fffdfdfefffffffffffffffffffbfdfffffffffffffffffcfdfefffffffffffffffffffefffffffffffffffffffffcff"
    "fffffffffffffffff9fffefffffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffffffffffffffffffffff"),
    np.uint8).reshape(4, 8, 3, 11)
_COEFF_PROBA0 = np.frombuffer(bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88feffe4db8080808080bd81f2ff"
    "e3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb"
    "80808001b9f9fff3ff8080808080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faffee8080808080806667e7ffd3"
    "ab80808080800198fcfff0ff8080808080b187f3ffeae180808080805081d3ffc2e080808080800101ff808080808080"
    "8080f601ff8080808080808080ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0bef9caffff800181e8fdd6c5"
    "f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080"
    "802c82c9fdcdc0ffff8080800184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7ffff808080798debffe1e3ff"
    "ff8080802d63bcfbc3d9ffe08080800101fbffd5ff8080808080cb01f8ffff8080808080808901b1ffe0ff8080808080"
    "fd09f8fbcfd0ffc0808080af0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba8080808080452ebeefc9daffe4"
    "80808001bffbffff808080808080dfa5f9ffd5ff80808080808d7cf8ffff8080808080800110f8ffff808080808080be"
    "24e6ffecff80808080809501ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080808080808080808080808080"
    "808080808080808080808080808080808080808080808080ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e"
    "8adb97b2f0aaffd8800170e6fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe08080809596e2fcd8cdffab8080"
    "801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8"
    "ffd8d58080808080a8aff6fcebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff8080808080808080ee01ff8080808080808080"),
    np.uint8).reshape(4, 8, 3, 11)
BMODES_PROBA = np.frombuffer(bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98721a11a32cc3150aad791850"
    "c31a3e2c405590470a26abd590221aaa2e371388a021ce473f14087272d00c09e251280b60b6541d102486b759896265"
    "6aa59448bb64829d6f204b504266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216585893962a2e2dc4cd2b61b7"
    "75552623b33d2735c8571a152be8ab3822336872661d5d4d271c55ab3aa55a6240221674ce17222ba6496b36201a3301"
    "512b1f44196a1640ab24e1722213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d16450082b9a01331a478e4e4e"
    "10ff8022c5ab29280566d3b70401dd333211a8d1c01719528a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba6"
    "5d499a282815748fd12227af2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39363970b8052926a6d51e221a"
    "8598740a2086271335dd1a722049ff1f0941ea020f0176494b200c33c0ffa02b33581f2343665537ba553815176f3bcd"
    "2d25c03726467c49660122627d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a39120a6666d522142b75140f"
    "24a38044011a663d472522351ff3c0453c472649771cde25442d8022012f0bf5ab3e1113469255373e46252b259a64a3"
    "55a0013f095c881c4020c9554b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d12d10155b40de0701c5381527"
    "9b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab120b073f90ab0404f6231b0a92aeab0c1a80be502363b450"
    "7e362d557e2f57b033291420654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418"), np.uint8).reshape(10, 10, 9)

DC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24,
    25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47,
    48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73,
    74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102,
    104, 106, 108, 110, 112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145,
    148, 151, 154, 157], np.int32)
AC_TABLE = np.array([
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
    31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56,
    57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104,
    106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152, 155, 158,
    161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234,
    239, 245, 249, 254, 259, 264, 269, 274, 279, 284], np.int32)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)  # by coefficient index, and a sentinel
CAT_PROBA = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# intra modes in libwebp's numbering; the 16x16 and chroma modes are the first four
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT = 10, 11, 12  # DC at the frame's edges (16x16 and chroma)
YMODES_TREE = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU)
_BMODES = BMODES_PROBA.tolist()
ERRORS = {-1: "premature end of a partition"}


def _wrap16(v: int) -> int:
    return ((v + 32768) & 0xFFFF) - 32768


class _BoolDecoder:
    """libwebp's VP8BitReader, a byte at a time: a decision that needs a
    byte past the end reads zeros and marks the partition as ended."""

    def __init__(self, data: bytes):
        self.data, self.pos, self.value, self.bits, self.range, self.eof = bytes(data), 0, 0, -8, 254, 0
        self._load()

    def _load(self):
        if self.pos < len(self.data):
            self.value = (self.value << 8) | self.data[self.pos]
            self.pos += 1
            self.bits += 8
        elif not self.eof:
            self.value <<= 8
            self.bits += 8
            self.eof = 1
        else:
            self.bits = 0

    def bit(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        split = (self.range * prob) >> 8
        if (self.value >> self.bits) > split:
            r = self.range - split
            self.value -= (split + 1) << self.bits
            bit = 1
        else:
            r = split + 1
            bit = 0
        shift = 7 ^ (r.bit_length() - 1)
        self.range = (r << shift) - 1
        self.bits -= shift
        return bit

    def value_of(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(0x80)
        return v

    def signed(self, n: int) -> int:
        v = self.value_of(n)
        return -v if self.bit(0x80) else v

    def state(self) -> tuple:
        return self.pos, self.value, self.bits, self.range, self.eof


# --- the per-macroblock decode (Python twin of native.vp8_decode_frame) ---


def _large(br: _BoolDecoder, p) -> int:
    """GetLargeValue: a coefficient magnitude of 2 or more."""
    if not br.bit(p[3]):
        return 2 if not br.bit(p[4]) else 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        return 7 + 2 * br.bit(165) + br.bit(145)
    bit1 = br.bit(p[8])
    cat = 2 * bit1 + br.bit(p[9 + bit1])
    v = 0
    for prob in CAT_PROBA[cat]:
        v = 2 * v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _BoolDecoder, probs, ctx: int, dq, n: int, out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from coefficient ``n``, dequantized into
    ``out[base:base + 16]`` (raster order); returns the index after the
    last one read (0 .. 16)."""
    p = probs[BANDS[n]][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = probs[BANDS[n]][0]
        if not br.bit(p[2]):
            v, nxt = 1, 1
        else:
            v, nxt = _large(br, p), 2
        if br.bit(0x80):
            v = -v
        out[base + ZIGZAG[n]] = _wrap16(v * dq[n > 0])
        n += 1
        p = probs[BANDS[n]][nxt]
    return 16


def _iwht(dc: list) -> list:
    """TransformWHT: the 16 luma DCs from the y2 block."""
    tmp, out = [0] * 16, [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[4 * i + 3], tmp[4 * i + 1] + tmp[4 * i + 2]
        a2, a3 = tmp[4 * i + 1] - tmp[4 * i + 2], d - tmp[4 * i + 3]
        out[4 * i:4 * i + 4] = [_wrap16((a0 + a1) >> 3), _wrap16((a3 + a2) >> 3),
                                _wrap16((a0 - a1) >> 3), _wrap16((a3 - a2) >> 3)]
    return out


def _mul1(a: int) -> int:
    return ((a * 20091) >> 16) + a


def _mul2(a: int) -> int:
    return (a * 35468) >> 16


def _idct_add(c: list, base: int, plane: list, at: int, stride: int) -> None:
    """TransformOne: add the inverse DCT of ``c[base:base + 16]`` to the 4x4
    block of ``plane`` at ``at`` (clipped to 0..255)."""
    tmp = [0] * 16
    for i in range(4):
        a, b = c[base + i] + c[base + 8 + i], c[base + i] - c[base + 8 + i]
        cc = _mul2(c[base + 4 + i]) - _mul1(c[base + 12 + i])
        d = _mul1(c[base + 4 + i]) + _mul2(c[base + 12 + i])
        tmp[4 * i:4 * i + 4] = [a + d, b + cc, b - cc, a - d]
    for i in range(4):
        dc = tmp[i] + 4
        a, b = dc + tmp[8 + i], dc - tmp[8 + i]
        cc = _mul2(tmp[4 + i]) - _mul1(tmp[12 + i])
        d = _mul1(tmp[4 + i]) + _mul2(tmp[12 + i])
        row = at + i * stride
        for k, v in enumerate((a + d, b + cc, b - cc, a - d)):
            plane[row + k] = min(max(plane[row + k] + (v >> 3), 0), 255)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, top: list, left: list, x: int) -> list:
    """A 4x4 prediction (row-major 16 values) from ``top`` (A..H, the four
    above and four above-right), ``left`` (I..L) and the corner ``x``."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    if mode == B_DC:
        return [(sum(top[:4]) + sum(left) + 4) >> 3] * 16
    if mode == B_TM:
        return [min(max(left[y] + top[k] - x, 0), 255) for y in range(4) for k in range(4)]
    if mode == B_VE:
        return [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == B_HE:
        return [v for v in (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)) for _ in range(4)]
    o = [0] * 16

    def put(vals, *xy):
        for k, y in xy:
            o[4 * y + k] = vals

    if mode == B_RD:
        put(_avg3(J, K, L), (0, 3))
        put(_avg3(I, J, K), (1, 3), (0, 2))
        put(_avg3(x, I, J), (2, 3), (1, 2), (0, 1))
        put(_avg3(A, x, I), (3, 3), (2, 2), (1, 1), (0, 0))
        put(_avg3(B, A, x), (3, 2), (2, 1), (1, 0))
        put(_avg3(C, B, A), (3, 1), (2, 0))
        put(_avg3(D, C, B), (3, 0))
    elif mode == B_LD:
        put(_avg3(A, B, C), (0, 0))
        put(_avg3(B, C, D), (1, 0), (0, 1))
        put(_avg3(C, D, E), (2, 0), (1, 1), (0, 2))
        put(_avg3(D, E, F), (3, 0), (2, 1), (1, 2), (0, 3))
        put(_avg3(E, F, G), (3, 1), (2, 2), (1, 3))
        put(_avg3(F, G, H), (3, 2), (2, 3))
        put(_avg3(G, H, H), (3, 3))
    elif mode == B_VR:
        put(_avg2(x, A), (0, 0), (1, 2))
        put(_avg2(A, B), (1, 0), (2, 2))
        put(_avg2(B, C), (2, 0), (3, 2))
        put(_avg2(C, D), (3, 0))
        put(_avg3(K, J, I), (0, 3))
        put(_avg3(J, I, x), (0, 2))
        put(_avg3(I, x, A), (0, 1), (1, 3))
        put(_avg3(x, A, B), (1, 1), (2, 3))
        put(_avg3(A, B, C), (2, 1), (3, 3))
        put(_avg3(B, C, D), (3, 1))
    elif mode == B_VL:
        put(_avg2(A, B), (0, 0))
        put(_avg2(B, C), (1, 0), (0, 2))
        put(_avg2(C, D), (2, 0), (1, 2))
        put(_avg2(D, E), (3, 0), (2, 2))
        put(_avg3(A, B, C), (0, 1))
        put(_avg3(B, C, D), (1, 1), (0, 3))
        put(_avg3(C, D, E), (2, 1), (1, 3))
        put(_avg3(D, E, F), (3, 1), (2, 3))
        put(_avg3(E, F, G), (3, 2))
        put(_avg3(F, G, H), (3, 3))
    elif mode == B_HU:
        put(_avg2(I, J), (0, 0))
        put(_avg2(J, K), (2, 0), (0, 1))
        put(_avg2(K, L), (2, 1), (0, 2))
        put(_avg3(I, J, K), (1, 0))
        put(_avg3(J, K, L), (3, 0), (1, 1))
        put(_avg3(K, L, L), (3, 1), (1, 2))
        put(L, (3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3))
    else:  # B_HD
        put(_avg2(I, x), (0, 0), (2, 1))
        put(_avg2(J, I), (0, 1), (2, 2))
        put(_avg2(K, J), (0, 2), (2, 3))
        put(_avg2(L, K), (0, 3))
        put(_avg3(A, B, C), (3, 0))
        put(_avg3(x, A, B), (2, 0))
        put(_avg3(I, x, A), (1, 0), (3, 1))
        put(_avg3(J, I, x), (1, 1), (3, 2))
        put(_avg3(K, J, I), (1, 2), (3, 3))
        put(_avg3(L, K, J), (1, 3))
    return o


def _pred_block(mode: int, top: list, left: list, x: int, size: int) -> list:
    """A 16x16 or 8x8 prediction (row-major); ``mode`` is DC, TM, V, H or
    one of the edge DCs."""
    shift = 4 if size == 16 else 3
    if mode == B_DC:
        return [(sum(top) + sum(left) + size) >> (shift + 1)] * (size * size)
    if mode == DC_NOTOP:
        return [(sum(left) + size // 2) >> shift] * (size * size)
    if mode == DC_NOLEFT:
        return [(sum(top) + size // 2) >> shift] * (size * size)
    if mode == DC_NOTOPLEFT:
        return [0x80] * (size * size)
    if mode == B_TM:
        return [min(max(left[y] + top[k] - x, 0), 255) for y in range(size) for k in range(size)]
    if mode == B_VE:
        return list(top) * size
    return [v for v in left for _ in range(size)]  # B_HE


def _edge_mode(mode: int, mb_x: int, mb_y: int) -> int:
    """CheckMode: DC without the missing neighbours at the frame's edges."""
    if mode != B_DC:
        return mode
    if mb_x == 0:
        return DC_NOTOPLEFT if mb_y == 0 else DC_NOLEFT
    return DC_NOTOP if mb_y == 0 else B_DC


def _parse_modes(br: _BoolDecoder, P: dict, mb_w: int, top_ctx: list) -> list:
    """ParseIntraModeRow: per macroblock (segment, skip, is_i4, y modes,
    uv mode); ``top_ctx`` holds the 4 i4 contexts above each macroblock."""
    row, left = [], [B_DC] * 4
    for mb_x in range(mb_w):
        top = top_ctx[4 * mb_x:4 * mb_x + 4]
        if P["update_map"]:
            s = P["segment_probs"]
            segment = br.bit(s[1]) if not br.bit(s[0]) else br.bit(s[2]) + 2
        else:
            segment = 0
        skip = br.bit(P["skip_p"]) if P["use_skip"] else 0
        is_i4 = not br.bit(145)
        if not is_i4:
            ymode = (B_TM if br.bit(128) else B_HE) if br.bit(156) else (B_VE if br.bit(163) else B_DC)
            modes = [ymode]
            top, left = [ymode] * 4, [ymode] * 4
        else:
            modes = []
            for y in range(4):
                ymode = left[y]
                for x in range(4):
                    prob = _BMODES[top[x]][ymode]
                    i = YMODES_TREE[br.bit(prob[0])]
                    while i > 0:
                        i = YMODES_TREE[2 * i + br.bit(prob[i])]
                    ymode = -i
                    top[x] = ymode
                modes += top
                left[y] = ymode
        uv = B_DC if not br.bit(142) else B_VE if not br.bit(114) else B_TM if br.bit(183) else B_HE
        top_ctx[4 * mb_x:4 * mb_x + 4] = top
        row.append((segment, skip, is_i4, modes, uv))
    return row


def _residuals(br: _BoolDecoder, P: dict, is_i4: bool, q, nz: list, mb_x: int, left: list) -> tuple:
    """ParseResiduals: (coefficients [25 * 16]: 16 luma, 4 u, 4 v blocks,
    whether any is nonzero). ``nz[mb_x]`` and ``left`` are the
    [nz bits, nz_dc] contexts above and to the left."""
    probs = P["probs"]
    c = [0] * 384
    top = nz[mb_x]
    if not is_i4:
        dc = [0] * 16
        n = _coeffs(br, probs[1], top[1] + left[1], (q[2], q[3]), 0, dc, 0)
        top[1] = left[1] = int(n > 0)
        for i, v in enumerate(_iwht(dc)):
            c[16 * i] = v
        first, ac = 1, probs[0]
    else:
        first, ac = 0, probs[3]
    non_zero = False
    tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
    for y in range(4):
        lbit = lnz & 1
        for x in range(4):
            n = _coeffs(br, ac, lbit + (tnz & 1), (q[0], q[1]), first, c, 16 * (4 * y + x))
            lbit = int(n > first)
            tnz = (tnz >> 1) | (lbit << 7)
            non_zero |= n > 1 or c[16 * (4 * y + x)] != 0
        tnz >>= 4
        lnz = (lnz >> 1) | (lbit << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz, lnz = top[0] >> (4 + ch), left[0] >> (4 + ch)
        for y in range(2):
            lbit = lnz & 1
            for x in range(2):
                base = 16 * (16 + 2 * ch + 2 * y + x)
                n = _coeffs(br, probs[2], lbit + (tnz & 1), (q[4], q[5]), 0, c, base)
                lbit = int(n > 0)
                tnz = (tnz >> 1) | (lbit << 3)
                non_zero |= n > 1 or c[base] != 0
            tnz >>= 2
            lnz = (lnz >> 1) | (lbit << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0], left[0] = out_t, out_l
    return c, non_zero


def _reconstruct(Y: list, U: list, V: list, sy: int, suv: int, mb_x: int, mb_y: int, mb, c: list) -> None:
    """Predict and add the residuals of one macroblock into the bordered
    planes (row -1 and column -1 are the frame's 127 / 129 edges; columns
    W .. W+3 hold each macroblock row's replicated top-right)."""
    _, _, is_i4, modes, uv = mb
    x0, y0 = 16 * mb_x + 1, 16 * mb_y + 1
    if is_i4:
        tr = [Y[(y0 - 1) * sy + x0 + 16 + k] for k in range(4)]  # the macroblock's top-right
        for n in range(16):
            bx, by = n & 3, n >> 2
            at = (y0 + 4 * by) * sy + x0 + 4 * bx
            top = [Y[at - sy + k] for k in range(4)]
            top += tr if bx == 3 else [Y[at - sy + 4 + k] for k in range(4)]
            left = [Y[at + k * sy - 1] for k in range(4)]
            pred = _pred4(modes[n], top, left, Y[at - sy - 1])
            for k in range(4):
                Y[at + k * sy:at + k * sy + 4] = pred[4 * k:4 * k + 4]
            _idct_add(c, 16 * n, Y, at, sy)
    else:
        at = y0 * sy + x0
        pred = _pred_block(_edge_mode(modes[0], mb_x, mb_y), Y[at - sy:at - sy + 16],
                           [Y[at + k * sy - 1] for k in range(16)], Y[at - sy - 1], 16)
        for k in range(16):
            Y[at + k * sy:at + k * sy + 16] = pred[16 * k:16 * k + 16]
        for n in range(16):
            _idct_add(c, 16 * n, Y, at + 4 * (n >> 2) * sy + 4 * (n & 3), sy)
    mode = _edge_mode(uv, mb_x, mb_y)
    for plane, first in ((U, 16), (V, 20)):
        at = (8 * mb_y + 1) * suv + 8 * mb_x + 1
        pred = _pred_block(mode, plane[at - suv:at - suv + 8], [plane[at + k * suv - 1] for k in range(8)],
                           plane[at - suv - 1], 8)
        for k in range(8):
            plane[at + k * suv:at + k * suv + 8] = pred[8 * k:8 * k + 8]
        for n in range(4):
            _idct_add(c, 16 * (first + n), plane, at + 4 * (n >> 1) * suv + 4 * (n & 1), suv)


# the loop filter (libwebp's dsp/dec.c, on the unbordered planes)

def _clip(v, lo, hi):
    return lo if v < lo else hi if v > hi else v


def _filter2(p: list, i: int, s: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0) + _clip(p1 - q1, -128, 127)
    a1, a2 = _clip((a + 4) >> 3, -16, 15), _clip((a + 3) >> 3, -16, 15)
    p[i - s], p[i] = _clip(p0 + a2, 0, 255), _clip(q0 - a1, 0, 255)


def _filter4(p: list, i: int, s: int) -> None:
    p1, p0, q0, q1 = p[i - 2 * s], p[i - s], p[i], p[i + s]
    a = 3 * (q0 - p0)
    a1, a2 = _clip((a + 4) >> 3, -16, 15), _clip((a + 3) >> 3, -16, 15)
    a3 = (a1 + 1) >> 1
    p[i - 2 * s], p[i - s] = _clip(p1 + a3, 0, 255), _clip(p0 + a2, 0, 255)
    p[i], p[i + s] = _clip(q0 - a1, 0, 255), _clip(q1 - a3, 0, 255)


def _filter6(p: list, i: int, s: int) -> None:
    p2, p1, p0, q0, q1, q2 = p[i - 3 * s], p[i - 2 * s], p[i - s], p[i], p[i + s], p[i + 2 * s]
    a = _clip(3 * (q0 - p0) + _clip(p1 - q1, -128, 127), -128, 127)
    a1, a2, a3 = (27 * a + 63) >> 7, (18 * a + 63) >> 7, (9 * a + 63) >> 7
    p[i - 3 * s], p[i - 2 * s], p[i - s] = _clip(p2 + a3, 0, 255), _clip(p1 + a2, 0, 255), _clip(p0 + a1, 0, 255)
    p[i], p[i + s], p[i + 2 * s] = _clip(q0 - a1, 0, 255), _clip(q1 - a2, 0, 255), _clip(q2 - a3, 0, 255)


def _edge_ok(p: list, i: int, s: int, t: int) -> bool:
    return 4 * abs(p[i - s] - p[i]) + abs(p[i - 2 * s] - p[i + s]) <= t


def _edge_ok2(p: list, i: int, s: int, t: int, it: int) -> bool:
    if not _edge_ok(p, i, s, t):
        return False
    p3, p2, p1, p0 = p[i - 4 * s], p[i - 3 * s], p[i - 2 * s], p[i - s]
    q0, q1, q2, q3 = p[i], p[i + s], p[i + 2 * s], p[i + 3 * s]
    return (abs(p3 - p2) <= it and abs(p2 - p1) <= it and abs(p1 - p0) <= it and abs(q3 - q2) <= it
            and abs(q2 - q1) <= it and abs(q1 - q0) <= it)


def _loop(p, i, hs, vs, size, thresh, ithresh, hev, mb_edge):
    """FilterLoop26 (macroblock edges) / FilterLoop24 (inner edges)."""
    t = 2 * thresh + 1
    for _ in range(size):
        if _edge_ok2(p, i, hs, t, ithresh):
            if abs(p[i - 2 * hs] - p[i - hs]) > hev or abs(p[i + hs] - p[i]) > hev:
                _filter2(p, i, hs)
            elif mb_edge:
                _filter6(p, i, hs)
            else:
                _filter4(p, i, hs)
        i += vs


def _simple(p, i, hs, vs, thresh):
    t = 2 * thresh + 1
    for _ in range(16):
        if _edge_ok(p, i, hs, t):
            _filter2(p, i, hs)
        i += vs


def _loop_filter_py(Y: list, U: list, V: list, w: int, mb_w: int, mb_h: int, simple: bool, finfo: list) -> None:
    """DoFilter on every macroblock in raster order; ``finfo[mb]`` is
    (limit, ilevel, hev threshold, inner), limit 0 for none."""
    uw = w // 2
    for mb_y in range(mb_h):
        for mb_x in range(mb_w):
            limit, ilevel, hev, inner = finfo[mb_y * mb_w + mb_x]
            if not limit:
                continue
            y0 = 16 * mb_y * w + 16 * mb_x
            if simple:
                if mb_x > 0:
                    _simple(Y, y0, 1, w, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple(Y, y0 + k, 1, w, limit)
                if mb_y > 0:
                    _simple(Y, y0, w, 1, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        _simple(Y, y0 + k * w, w, 1, limit)
                continue
            c0 = 8 * mb_y * uw + 8 * mb_x
            if mb_x > 0:
                _loop(Y, y0, 1, w, 16, limit + 4, ilevel, hev, True)
                for p in (U, V):
                    _loop(p, c0, 1, uw, 8, limit + 4, ilevel, hev, True)
            if inner:
                for k in (4, 8, 12):
                    _loop(Y, y0 + k, 1, w, 16, limit, ilevel, hev, False)
                for p in (U, V):
                    _loop(p, c0 + 4, 1, uw, 8, limit, ilevel, hev, False)
            if mb_y > 0:
                _loop(Y, y0, w, 1, 16, limit + 4, ilevel, hev, True)
                for p in (U, V):
                    _loop(p, c0, uw, 1, 8, limit + 4, ilevel, hev, True)
            if inner:
                for k in (4, 8, 12):
                    _loop(Y, y0 + k * w, w, 1, 16, limit, ilevel, hev, False)
                for p in (U, V):
                    _loop(p, c0 + 4 * uw, uw, 1, 8, limit, ilevel, hev, False)


def _decode_frame_py(br: _BoolDecoder, parts: list, mb_w: int, mb_h: int, P: dict):
    """The macroblocks of a key frame after its header: modes from the
    first partition ``br``, tokens from ``parts`` (row r from partition
    r % len(parts)), reconstruction and the loop filter. Returns the
    macroblock-aligned planes ``(Y, U, V)`` uint8, or -1 when a partition
    ended early."""
    w, h = 16 * mb_w, 16 * mb_h
    sy, suv = w + 5, w // 2 + 1
    Y = [127] * (sy * (h + 1))
    U = [127] * (suv * (h // 2 + 1))
    V = list(U)
    for r in range(1, h + 1):
        Y[r * sy] = 129
    for r in range(1, h // 2 + 1):
        U[r * suv] = V[r * suv] = 129
    top_ctx = [B_DC] * (4 * mb_w)
    nz = [[0, 0] for _ in range(mb_w)]
    finfo = []
    for mb_y in range(mb_h):
        row = _parse_modes(br, P, mb_w, top_ctx)
        tb = parts[mb_y % len(parts)]
        left = [0, 0]
        for mb_x, mb in enumerate(row):
            segment, skip, is_i4 = mb[:3]
            if skip and P["use_skip"]:
                c, non_zero = [0] * 384, False
                nz[mb_x][0] = left[0] = 0
                if not is_i4:
                    nz[mb_x][1] = left[1] = 0
            else:
                c, non_zero = _residuals(tb, P, is_i4, P["quant"][segment], nz, mb_x, left)
            limit, ilevel, hev = P["fstrengths"][segment][int(is_i4)]
            finfo.append((limit, ilevel, hev, is_i4 or non_zero))
            _reconstruct(Y, U, V, sy, suv, mb_x, mb_y, mb, c)
        # the rightmost macroblock's top-right for the next row: its last row's last pixel
        last = (16 * mb_y + 16) * sy
        Y[last + w + 1:last + w + 5] = [Y[last + w]] * 4
    if br.eof or any(p.eof for p in parts):
        return -1
    Yp = [v for r in range(1, h + 1) for v in Y[r * sy + 1:r * sy + 1 + w]]
    Up = [v for r in range(1, h // 2 + 1) for v in U[r * suv + 1:(r + 1) * suv]]
    Vp = [v for r in range(1, h // 2 + 1) for v in V[r * suv + 1:(r + 1) * suv]]
    if P["filter_type"]:
        _loop_filter_py(Yp, Up, Vp, w, mb_w, mb_h, P["filter_type"] == 1, finfo)
    return (np.array(Yp, np.uint8).reshape(h, w), np.array(Up, np.uint8).reshape(h // 2, w // 2),
            np.array(Vp, np.uint8).reshape(h // 2, w // 2))


# --- the frame header ---


def _quant_steps(q: int, dq) -> tuple:
    """VP8ParseQuant: the (y1 dc, y1 ac, y2 dc, y2 ac, uv dc, uv ac) steps
    of base index ``q`` with the deltas ``dq`` (y1 dc, y2 dc, y2 ac, uv dc,
    uv ac), libwebp's clamps included."""
    cl = lambda v, hi=127: min(max(v, 0), hi)  # noqa: E731
    return (int(DC_TABLE[cl(q + dq[0])]), int(AC_TABLE[cl(q)]), int(DC_TABLE[cl(q + dq[1])]) * 2,
            max((int(AC_TABLE[cl(q + dq[2])]) * 101581) >> 16, 8), int(DC_TABLE[cl(q + dq[3], 117)]),
            int(AC_TABLE[cl(q + dq[4])]))


def header(data: bytes) -> tuple[int, int, int]:
    """VP8GetInfo's checks on a VP8 chunk's payload: (width, height, first
    partition size)."""
    if len(data) < 10:
        raise ValueError("VP8: truncated frame header")
    bits = data[0] | data[1] << 8 | data[2] << 16
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= len(data):
        raise ValueError("VP8: not a shown key frame of a known profile")
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("VP8: bad start code")
    w, h = (data[6] | data[7] << 8) & 0x3FFF, (data[8] | data[9] << 8) & 0x3FFF
    if not w or not h:
        raise ValueError("VP8: empty frame")
    return w, h, bits >> 5


def _parse_header(data: bytes):
    """VP8GetHeaders: (the first partition's reader after the header,
    the token partitions' data, the parameters of the macroblock decode)."""
    w, h, size0 = header(data)
    buf = data[10:]
    if size0 > len(buf):
        raise ValueError("VP8: bad partition length")
    br = _BoolDecoder(buf[:size0])
    br.bit(0x80)  # colour space
    br.bit(0x80)  # clamping type
    use_segment = br.bit(0x80)
    update_map, absolute = 0, 0
    seg_q, seg_f, seg_probs = [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.bit(0x80)
        if br.bit(0x80):
            absolute = br.bit(0x80)
            seg_q = [br.signed(7) if br.bit(0x80) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.bit(0x80) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_of(8) if br.bit(0x80) else 255 for _ in range(3)]
    simple, level, sharpness = br.bit(0x80), br.value_of(6), br.value_of(3)
    ref_lf, mode_lf = [0] * 4, [0] * 4
    use_lf_delta = br.bit(0x80)
    if use_lf_delta and br.bit(0x80):
        ref_lf = [br.signed(6) if br.bit(0x80) else 0 for _ in range(4)]
        mode_lf = [br.signed(6) if br.bit(0x80) else 0 for _ in range(4)]
    if br.eof:
        raise ValueError("VP8: cannot parse the segment and filter headers")
    last = (1 << br.value_of(2)) - 1
    rest = buf[size0:]
    if len(rest) < 3 * last:
        raise ValueError("VP8: cannot parse the partition sizes")
    parts, pos, left = [], 3 * last, len(rest) - 3 * last
    for p in range(last):
        size = min(rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16, left)
        parts.append(rest[pos:pos + size])
        pos, left = pos + size, left - size
    parts.append(rest[pos:])
    if pos >= len(rest):
        raise ValueError("VP8: cannot parse the partitions")
    base_q = br.value_of(7)
    dq = [br.signed(4) if br.bit(0x80) else 0 for _ in range(5)]  # y1 dc, y2 dc, y2 ac, uv dc, uv ac
    quant = []
    for s in range(4):
        quant.append(_quant_steps((seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q, dq))
    br.bit(0x80)  # refresh entropy probabilities: ignored
    probs = np.empty((4, 8, 3, 11), np.uint8)
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for n in range(11):
                    probs[t, b, c, n] = (br.value_of(8) if br.bit(int(_UPDATE_PROBA[t, b, c, n]))
                                         else _COEFF_PROBA0[t, b, c, n])
    use_skip = br.bit(0x80)
    skip_p = br.value_of(8) if use_skip else 0
    filter_type = 0 if level == 0 else 1 if simple else 2
    fstrengths = []
    for s in range(4):
        base = (seg_f[s] + (0 if absolute else level)) if use_segment else level
        per = []
        for i4 in (0, 1):
            lv = base + ((ref_lf[0] + (mode_lf[0] if i4 else 0)) if use_lf_delta else 0)
            lv = min(max(lv, 0), 63)
            if lv:
                il = lv
                if sharpness:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                per.append((2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0))
            else:
                per.append((0, 0, 0))
        fstrengths.append(per)
    P = {"update_map": update_map, "segment_probs": seg_probs, "use_skip": use_skip, "skip_p": skip_p,
         "probs": probs, "quant": quant, "filter_type": filter_type, "fstrengths": fstrengths}
    return w, h, br, parts, P


def _decode_planes(data: bytes):
    w, h, br, parts, P = _parse_header(data)
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    if native.available():
        res = native.vp8_decode_frame(data[10:10 + len(br.data)], br.state(), parts, mb_w, mb_h, P, BMODES_PROBA)
    else:
        P = dict(P, probs=P["probs"].tolist())
        res = _decode_frame_py(br, [_BoolDecoder(p) for p in parts], mb_w, mb_h, P)
    if isinstance(res, int):
        raise ValueError(f"VP8: {ERRORS.get(res, 'corrupt frame')}")
    return w, h, res


# --- YUV 4:2:0 -> RGB as libwebp hands it to Pillow ---


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """UpsampleRgbaLinePair's chroma ("fancy" upsampling): ``c`` the
    chroma plane ``[ceil(h/2), ceil(w/2)]`` -> ``[h, w]``, int32."""
    c = c.astype(np.int32)
    ch = c.shape[0]
    r = np.arange(h)
    near = np.where(r % 2 == 1, (r - 1) // 2, r // 2)  # the chroma row each output row leans on
    far = np.where(r % 2 == 1, np.minimum((r + 1) // 2, ch - 1), np.maximum(r // 2 - 1, 0))
    n, f = c[near], c[far]  # the near row plays "top" (tl, t), the far row "cur" (l, c)
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        tl, t, l_, cc = n[:, :pairs], n[:, 1:pairs + 1], f[:, :pairs], f[:, 1:pairs + 1]
        avg = tl + t + l_ + cc + 8
        d12 = (avg + 2 * (t + l_)) >> 3
        d03 = (avg + 2 * (tl + cc)) >> 3
        out[:, 1:2 * pairs:2] = (d12 + tl) >> 1
        out[:, 2:2 * pairs + 1:2] = (d03 + t) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * n[:, pairs] + f[:, pairs] + 2) >> 2
    return out


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Cropped Y ``[h, w]`` and its chroma -> uint8 RGB by the fancy
    upsampler and VP8YUVToR/G/B."""
    h, w = y.shape
    uu, vv = _upsample(u, h, w), _upsample(v, h, w)
    yy = (y.astype(np.int32) * 19077) >> 8
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def decode_vp8(data: bytes) -> np.ndarray:
    """A VP8 chunk's payload (one key frame) -> uint8 RGB ``[H, W, 3]``,
    libwebp's decode. Raises ``ValueError`` on a corrupt frame."""
    w, h, (Y, U, V) = _decode_planes(data)
    return yuv_to_rgb(Y[:h, :w], U[:(h + 1) // 2, :(w + 1) // 2], V[:(h + 1) // 2, :(w + 1) // 2])


# --- encoding ---

# the cost of coding a 0 at probability p (of a 0), in 1/256 bits; a 1 costs _BIT_COST[256 - p]
BIT_COST = np.concatenate([[0], np.round(-np.log2(np.arange(1, 257) / 256.0) * 256)]).astype(np.int32)
_BIT_COST = BIT_COST.tolist()
# lambda = LAMBDA * q_ac^2 / 16 (squared error per bit) and the quantizer's rounding (/128 of the
# step), chosen on assets/sky.png, renders/asset_scene_cpu.png and renders/mesh_scene.png against
# Pillow's quality-80 files (tests/test_torch_webp.py holds the writer to them)
LAMBDA = 8
_ROUND_DC, _ROUND_AC = 80, 64
QUALITY = 80  # WebPImagePlugin._save's default, the only quality the port writes


def _fdct(src: list, pred: list) -> list:
    """FTransform: the VP8 forward DCT of ``src - pred`` (row-major 4x4)."""
    tmp, out = [0] * 16, [0] * 16
    for i in range(4):
        d0, d1, d2, d3 = (src[4 * i + k] - pred[4 * i + k] for k in range(4))
        a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
        tmp[4 * i] = (a0 + a1) * 8
        tmp[4 * i + 1] = (a2 * 2217 + a3 * 5352 + 1812) >> 9
        tmp[4 * i + 2] = (a0 - a1) * 8
        tmp[4 * i + 3] = (a3 * 2217 - a2 * 5352 + 937) >> 9
    for i in range(4):
        a0, a1 = tmp[i] + tmp[12 + i], tmp[4 + i] + tmp[8 + i]
        a2, a3 = tmp[4 + i] - tmp[8 + i], tmp[i] - tmp[12 + i]
        out[i] = (a0 + a1 + 7) >> 4
        out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0)
        out[8 + i] = (a0 - a1 + 7) >> 4
        out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return out


def _fwht(dc: list) -> list:
    """FTransformWHT: the y2 block of the 16 luma DCs (raster order)."""
    tmp, out = [0] * 16, [0] * 16
    for i in range(4):
        a0, a1 = dc[4 * i] + dc[4 * i + 2], dc[4 * i + 1] + dc[4 * i + 3]
        a2, a3 = dc[4 * i + 1] - dc[4 * i + 3], dc[4 * i] - dc[4 * i + 2]
        tmp[4 * i:4 * i + 4] = [a0 + a1, a3 + a2, a3 - a2, a0 - a1]
    for i in range(4):
        a0, a1 = tmp[i] + tmp[8 + i], tmp[4 + i] + tmp[12 + i]
        a2, a3 = tmp[4 + i] - tmp[12 + i], tmp[i] - tmp[8 + i]
        out[i], out[4 + i], out[8 + i], out[12 + i] = (a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1, (a0 - a1) >> 1
    return out


def _quantize(coef: list, first: int, qdc: int, qac: int) -> tuple:
    """Levels in zigzag order from ``first`` (0 before it) and the
    dequantized coefficients (raster order)."""
    levels, deq = [0] * 16, [0] * 16
    for n in range(first, 16):
        j = ZIGZAG[n]
        q, rnd = (qdc, _ROUND_DC) if n == 0 else (qac, _ROUND_AC)
        v = coef[j]
        lv = min((abs(v) + ((q * rnd) >> 7)) // q, 2047)
        if lv:
            levels[n] = lv if v > 0 else -lv
            deq[j] = levels[n] * q
    return levels, deq


def _block_cost(levels: list, first: int, probs, ctx: int) -> int:
    """The tokens' cost of one block (1/256 bits) under ``probs`` of its
    type, as `_put_block` would code it."""
    cost = [0]

    def put(bit, prob):
        cost[0] += _BIT_COST[256 - prob] if bit else _BIT_COST[prob]

    _put_block(put, levels, first, probs, ctx)
    return cost[0]


def _put_block(put, levels: list, first: int, probs, ctx: int) -> int:
    """Code one block's levels (zigzag order) as GetCoeffs reads them;
    ``put(bit, prob)`` takes each decision. Returns whether a level is
    nonzero (the block's nz context)."""
    last = 15
    while last >= first and not levels[last]:
        last -= 1
    n = first
    p = probs[BANDS[n]][ctx]
    if last < first:
        put(0, p[0])
        return 0
    while n < 16:
        put(1, p[0])
        while not levels[n]:
            put(0, p[1])
            n += 1
            p = probs[BANDS[n]][0]
        put(1, p[1])
        v = abs(levels[n])
        if v == 1:
            put(0, p[2])
            nxt = 1
        else:
            put(1, p[2])
            if v <= 4:
                put(0, p[3])
                if v == 2:
                    put(0, p[4])
                else:
                    put(1, p[4])
                    put(v - 3, p[5])
            elif v <= 10:
                put(1, p[3])
                put(0, p[6])
                if v <= 6:
                    put(0, p[7])
                    put(v - 5, 159)
                else:
                    put(1, p[7])
                    put((v - 7) >> 1, 165)
                    put((v - 7) & 1, 145)
            else:
                put(1, p[3])
                put(1, p[6])
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                put(cat >> 1, p[8])
                put(cat & 1, p[9 + (cat >> 1)])
                extra = v - 3 - (8 << cat)
                tab = CAT_PROBA[cat]
                for k, prob in enumerate(tab):
                    put((extra >> (len(tab) - 1 - k)) & 1, prob)
            nxt = 2
        put(int(levels[n] < 0), 0x80)
        n += 1
        if n == 16 or n > last:
            if n < 16:
                put(0, probs[BANDS[n]][nxt][0])
            return 1
        p = probs[BANDS[n]][nxt]
    return 1


def _ymode_bits(mode: int) -> tuple:
    return {B_DC: ((0, 156), (0, 163)), B_VE: ((0, 156), (1, 163)), B_HE: ((1, 156), (0, 128)),
            B_TM: ((1, 156), (1, 128))}[mode]


def _uvmode_bits(mode: int) -> tuple:
    return {B_DC: ((0, 142),), B_VE: ((1, 142), (0, 114)), B_HE: ((1, 142), (1, 114), (0, 183)),
            B_TM: ((1, 142), (1, 114), (1, 183))}[mode]


def _bmode_bits(mode: int, prob) -> list:
    """The tree decisions of an i4 mode under its context's ``prob``."""
    path, node = [], 0

    def find(i, acc):
        for bit in (0, 1):
            nxt = YMODES_TREE[i + bit]
            if nxt <= 0 and -nxt == mode:
                return acc + [(bit, prob[i >> 1])]
            if nxt > 0:
                got = find(2 * nxt, acc + [(bit, prob[i >> 1])])
                if got:
                    return got
        return None

    return find(node, path)


_BMODE_BITS = [[[_bmode_bits(m, BMODES_PROBA[t][l].tolist()) for m in range(10)] for l in range(10)]
               for t in range(10)]


def _bits_cost(bits) -> int:
    return sum(_BIT_COST[256 - p] if b else _BIT_COST[p] for b, p in bits)


def _sse(a: list, b: list) -> int:
    return sum((x - y) * (x - y) for x, y in zip(a, b))


def _recon4(pred: list, deq: list) -> list:
    block = list(pred)
    _idct_add(deq, 0, block, 0, 4)
    return block


def _encode_mbs_py(Y: np.ndarray, U: np.ndarray, V: np.ndarray, segs: np.ndarray, quant: list,
                   lambdas: list) -> tuple:
    """The macroblock encode: for each macroblock in raster order, the i16
    and i4 luma modes and the chroma mode by squared error + lambda x the
    tokens' cost under the default probabilities (the contexts tracked as
    the decoder tracks them), quantized, and reconstructed as the decoder
    will. ``Y``, ``U``, ``V`` macroblock-aligned uint8 planes, ``segs``
    each macroblock's segment, ``quant[s]`` its (y1 dc, y1 ac, y2 dc,
    y2 ac, uv dc, uv ac) steps, ``lambdas[s]``. Returns ``modes``
    ``int32 [mbs, 18]`` (is_i4, 16 luma modes (i16: the first), the chroma
    mode) and ``levels`` ``int16 [mbs, 25, 16]`` (16 luma blocks, 4 u, 4 v,
    y2; zigzag order)."""
    h, w = Y.shape
    mb_w, mb_h = w // 16, h // 16
    probs = _COEFF_PROBA0.tolist()
    sy, suv = w + 5, w // 2 + 1
    R = [127] * (sy * (h + 1))  # the reconstruction, bordered as the decoder's
    RU = [127] * (suv * (h // 2 + 1))
    RV = list(RU)
    for r in range(1, h + 1):
        R[r * sy] = 129
    for r in range(1, h // 2 + 1):
        RU[r * suv] = RV[r * suv] = 129
    Yl, Ul, Vl = Y.astype(np.int32).tolist(), U.astype(np.int32).tolist(), V.astype(np.int32).tolist()
    modes = np.zeros((mb_w * mb_h, 18), np.int32)
    levels = np.zeros((mb_w * mb_h, 25, 16), np.int16)
    top_ctx = [B_DC] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]  # 4 luma, 2 u, 2 v block flags and y2
    for mb_y in range(mb_h):
        left_ctx = [B_DC] * 4
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            mb = mb_y * mb_w + mb_x
            q = quant[segs[mb]]
            lam = lambdas[segs[mb]]
            x0, y0 = 16 * mb_x + 1, 16 * mb_y + 1
            src = [Yl[16 * mb_y + k][16 * mb_x:16 * mb_x + 16] for k in range(16)]
            top = R[(y0 - 1) * sy + x0:(y0 - 1) * sy + x0 + 16]
            tr = R[(y0 - 1) * sy + x0 + 16:(y0 - 1) * sy + x0 + 20]
            left = [R[(y0 + k) * sy + x0 - 1] for k in range(16)]
            corner = R[(y0 - 1) * sy + x0 - 1]
            blocks_src = [[v for k in range(4) for v in src[4 * by + k][4 * bx:4 * bx + 4]]
                          for by in range(4) for bx in range(4)]
            # i16
            best = None
            for mode in (B_DC, B_TM, B_VE, B_HE):
                pred = _pred_block(_edge_mode(mode, mb_x, mb_y), top, left, corner, 16)
                bpred = [[v for k in range(4) for v in pred[16 * (4 * by + k) + 4 * bx:16 * (4 * by + k) + 4 * bx + 4]]
                         for by in range(4) for bx in range(4)]
                coefs = [_fdct(blocks_src[n], bpred[n]) for n in range(16)]
                y2lv, y2deq = _quantize(_fwht([c[0] for c in coefs]), 0, q[2], q[3])
                dcs = _iwht(y2deq)
                rate = _bits_cost(((1, 145),) + _ymode_bits(mode))
                rate += _block_cost(y2lv, 0, probs[1], nz_top[mb_x][8] + nz_left[8])
                lv_all, recon, sse = [], [], 0
                tnz, lnz = nz_top[mb_x][:4], nz_left[:4]
                for n in range(16):
                    lv, deq = _quantize(coefs[n], 1, q[0], q[1])
                    deq[0] = dcs[n]
                    bx, by = n & 3, n >> 2
                    rate += _block_cost(lv, 1, probs[0], tnz[bx] + lnz[by])
                    tnz[bx] = lnz[by] = int(any(lv[1:]))
                    rb = _recon4(bpred[n], deq)
                    sse += _sse(rb, blocks_src[n])
                    lv_all.append(lv)
                    recon.append(rb)
                score = 256 * sse + lam * rate
                if best is None or score < best[0]:
                    best = (score, mode, lv_all, y2lv, recon, tnz, lnz)
            # i4: each block in turn over the 10 modes, on a local copy of the edges
            local = [[0] * 21 for _ in range(17)]
            local[0] = [corner] + top + tr
            for k in range(16):
                local[k + 1][0] = left[k]
            score4 = lam * _bits_cost(((0, 145),))
            tctx, lctx = top_ctx[4 * mb_x:4 * mb_x + 4], list(left_ctx)
            tnz4, lnz4 = nz_top[mb_x][:4], nz_left[:4]
            modes4, lv4, recon4 = [], [], []
            for n in range(16):
                bx, by = n & 3, n >> 2
                ax, ay = 4 * bx + 1, 4 * by + 1
                btop = local[ay - 1][ax:ax + 4] + (local[0][17:21] if bx == 3 else local[ay - 1][ax + 4:ax + 8])
                bleft = [local[ay + k][ax - 1] for k in range(4)]
                bcorner = local[ay - 1][ax - 1]
                ctx = tnz4[bx] + lnz4[by]
                bbest = None
                for m in range(10):
                    pred = _pred4(m, btop, bleft, bcorner)
                    lv, deq = _quantize(_fdct(blocks_src[n], pred), 0, q[0], q[1])
                    rb = _recon4(pred, deq)
                    rate = _block_cost(lv, 0, probs[3], ctx) + _bits_cost(_BMODE_BITS[tctx[bx]][lctx[by]][m])
                    s = 256 * _sse(rb, blocks_src[n]) + lam * rate
                    if bbest is None or s < bbest[0]:
                        bbest = (s, m, lv, rb)
                s, m, lv, rb = bbest
                score4 += s
                tctx[bx] = lctx[by] = m
                tnz4[bx] = lnz4[by] = int(any(lv))
                for k in range(4):
                    local[ay + k][ax:ax + 4] = rb[4 * k:4 * k + 4]
                modes4.append(m)
                lv4.append(lv)
                recon4.append(rb)
            if score4 < best[0]:
                is_i4, ymodes, ylv, y2lv, yrec, tnz, lnz = 1, modes4, lv4, [0] * 16, recon4, tnz4, lnz4
                top_ctx[4 * mb_x:4 * mb_x + 4], left_ctx = tctx, lctx
            else:
                _, mode, ylv, y2lv, yrec, tnz, lnz = best
                is_i4, ymodes = 0, [mode] + [0] * 15
                top_ctx[4 * mb_x:4 * mb_x + 4], left_ctx = [mode] * 4, [mode] * 4
                nz_top[mb_x][8] = nz_left[8] = int(any(y2lv))
            nz_top[mb_x][:4], nz_left[:4] = tnz, lnz
            for n in range(16):
                at = (y0 + 4 * (n >> 2)) * sy + x0 + 4 * (n & 3)
                for k in range(4):
                    R[at + k * sy:at + k * sy + 4] = yrec[n][4 * k:4 * k + 4]
            # chroma
            cbest = None
            cx, cy = 8 * mb_x + 1, 8 * mb_y + 1
            planes = []
            for P, S in ((RU, Ul), (RV, Vl)):
                top_at = (cy - 1) * suv + cx
                planes.append((P[top_at:top_at + 8], [P[(cy + k) * suv + cx - 1] for k in range(8)], P[top_at - 1],
                               [[v for k in range(4) for v in S[8 * mb_y + 4 * by + k][8 * mb_x + 4 * bx:][:4]]
                                for by in range(2) for bx in range(2)]))
            for mode in (B_DC, B_TM, B_VE, B_HE):
                rate, sse, lv_all, recs = _bits_cost(_uvmode_bits(mode)), 0, [], []
                tn, ln = list(nz_top[mb_x][4:8]), list(nz_left[4:8])
                for ch, (ptop, pleft, pcorner, bsrc) in enumerate(planes):
                    pred = _pred_block(_edge_mode(mode, mb_x, mb_y), ptop, pleft, pcorner, 8)
                    for n in range(4):
                        bx, by = n & 1, n >> 1
                        bp = [v for k in range(4) for v in pred[8 * (4 * by + k) + 4 * bx:][:4]]
                        lv, deq = _quantize(_fdct(bsrc[n], bp), 0, q[4], q[5])
                        rate += _block_cost(lv, 0, probs[2], tn[2 * ch + bx] + ln[2 * ch + by])
                        tn[2 * ch + bx] = ln[2 * ch + by] = int(any(lv))
                        rb = _recon4(bp, deq)
                        sse += _sse(rb, bsrc[n])
                        lv_all.append(lv)
                        recs.append(rb)
                score = 256 * sse + lam * rate
                if cbest is None or score < cbest[0]:
                    cbest = (score, mode, lv_all, recs, tn, ln)
            _, uvmode, uvlv, uvrec, tn, ln = cbest
            nz_top[mb_x][4:8], nz_left[4:8] = tn, ln
            for ch, P in enumerate((RU, RV)):
                for n in range(4):
                    at = (cy + 4 * (n >> 1)) * suv + cx + 4 * (n & 1)
                    for k in range(4):
                        P[at + k * suv:at + k * suv + 4] = uvrec[4 * ch + n][4 * k:4 * k + 4]
            modes[mb, 0], modes[mb, 1:17], modes[mb, 17] = is_i4, ymodes, uvmode
            levels[mb, :16], levels[mb, 16:24], levels[mb, 24] = ylv, uvlv, y2lv
        last = (16 * mb_y + 16) * sy
        R[last + w + 1:last + w + 5] = [R[last + w]] * 4
    return modes, levels


class _BoolEncoder:
    """RFC 6386 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom = (self.bottom + split) & 0xFFFFFFFF
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & 0x80000000:
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


# token probabilities by position, for the statistics: entry >= 256 is position + 256
_POSITIONS = (np.arange(4 * 8 * 3 * 11) + 256).reshape(4, 8, 3, 11).tolist()


def _put_tokens(put_for_row, probs, modes: np.ndarray, levels: np.ndarray, skips: np.ndarray, mb_w: int) -> None:
    """Code every macroblock's tokens: ``put_for_row(mb_y)`` gives the
    row's ``put(bit, prob)``; skipped macroblocks code nothing and clear
    their contexts as the decoder does."""
    n_mb = len(modes)
    nz_top = [[0] * 9 for _ in range(mb_w)]
    for mb_y in range(n_mb // mb_w):
        put = put_for_row(mb_y)
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            mb = mb_y * mb_w + mb_x
            is_i4 = modes[mb, 0]
            top = nz_top[mb_x]
            if skips[mb]:
                top[:8] = nz_left[:8] = [0] * 8
                if not is_i4:
                    top[8] = nz_left[8] = 0
                continue
            lv = levels[mb].tolist()
            if not is_i4:
                top[8] = nz_left[8] = _put_block(put, lv[24], 0, probs[1], top[8] + nz_left[8])
                first, ac = 1, probs[0]
            else:
                first, ac = 0, probs[3]
            for n in range(16):
                bx, by = n & 3, n >> 2
                top[bx] = nz_left[by] = _put_block(put, lv[n], first, ac, top[bx] + nz_left[by])
            for n in range(8):
                ch, bx, by = n >> 2, n & 1, (n >> 1) & 1
                top[4 + 2 * ch + bx] = nz_left[4 + 2 * ch + by] = _put_block(
                    put, lv[16 + n], 0, probs[2], top[4 + 2 * ch + bx] + nz_left[4 + 2 * ch + by])


def _write_tokens_py(modes, levels, skips, probs: np.ndarray, mb_w: int, n_parts: int):
    """The token partitions' bytes (row r in partition r % n_parts), or
    with ``probs`` None the statistics ``int64 [4, 8, 3, 11, 2]`` of each
    probability's zeros and ones."""
    if probs is None:
        stats = np.zeros((4 * 8 * 3 * 11, 2), np.int64)

        def count(bit, pos):
            if pos >= 256:
                stats[pos - 256, bit] += 1

        _put_tokens(lambda mb_y: count, _POSITIONS, modes, levels, skips, mb_w)
        return stats.reshape(4, 8, 3, 11, 2)
    encs = [_BoolEncoder() for _ in range(n_parts)]
    _put_tokens(lambda mb_y: encs[mb_y % n_parts].put, probs.tolist(), modes, levels, skips, mb_w)
    return [e.flush() for e in encs]


def _write_modes_py(header_bits: np.ndarray, modes, segs, skips, seg_probs, skip_p: int, mb_w: int) -> bytes:
    """The first partition: the frame header's decisions ``[(bit, prob)]``,
    then each macroblock's segment (with ``seg_probs``, when given), skip
    flag (``skip_p`` > 0) and modes."""
    enc = _BoolEncoder()
    for bit, prob in header_bits.tolist():
        enc.put(bit, prob)
    top_ctx = [B_DC] * (4 * mb_w)
    for mb, m in enumerate(modes.tolist()):
        mb_x = mb % mb_w
        if mb_x == 0:
            left_ctx = [B_DC] * 4
        if seg_probs is not None:
            s = int(segs[mb])
            enc.put(s >> 1, seg_probs[0])
            enc.put(s & 1, seg_probs[1 + (s >> 1)])
        if skip_p:
            enc.put(int(skips[mb]), skip_p)
        enc.put(1 - m[0], 145)
        if m[0]:
            for n in range(16):
                bx, by = n & 3, n >> 2
                for bit, prob in _BMODE_BITS[top_ctx[4 * mb_x + bx]][left_ctx[by]][m[1 + n]]:
                    enc.put(bit, prob)
                top_ctx[4 * mb_x + bx] = left_ctx[by] = m[1 + n]
        else:
            for bit, prob in _ymode_bits(m[1]):
                enc.put(bit, prob)
            top_ctx[4 * mb_x:4 * mb_x + 4] = left_ctx[:] = [m[1]] * 4
        for bit, prob in _uvmode_bits(m[17]):
            enc.put(bit, prob)
    return enc.flush()


def rgb_to_yuv(rgb8: np.ndarray) -> tuple:
    """libwebp's VP8RGBToY / VP8RGBToU / VP8RGBToV (chroma from 2x2 sums),
    on the image padded to whole macroblocks by repeating its last row and
    column: Y ``[16 mb_h, 16 mb_w]``, U and V ``[8 mb_h, 8 mb_w]`` uint8."""
    h, w, _ = rgb8.shape
    hp, wp = -(-h // 16) * 16, -(-w // 16) * 16
    px = np.pad(rgb8.astype(np.int64), ((0, hp - h), (0, wp - w), (0, 0)), mode="edge")
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (1 << 15) + (16 << 16)) >> 16
    s4 = px.reshape(hp // 2, 2, wp // 2, 2, 3).sum(axis=(1, 3))
    r4, g4, b4 = s4[..., 0], s4[..., 1], s4[..., 2]
    u = np.clip((-9719 * r4 - 19081 * g4 + 28800 * b4 + (1 << 17) + (128 << 18)) >> 18, 0, 255)
    v = np.clip((28800 * r4 - 24116 * g4 - 4684 * b4 + (1 << 17) + (128 << 18)) >> 18, 0, 255)
    return y.astype(np.uint8), u.astype(np.uint8), v.astype(np.uint8)


def quality_to_q(quality: float) -> int:
    """libwebp's VP8SetSegmentParams for one segment without SNS: the
    quality -> compression mapping (QualityToCompression: linear below 0.75
    as 2/3 c, else 2c - 1; the cube root), q = 127 (1 - c)."""
    c = quality / 100.0
    linear = c * 2.0 / 3.0 if c < 0.75 else 2.0 * c - 1.0
    return min(max(int(127.0 * (1.0 - linear ** (1.0 / 3.0))), 0), 127)


def filter_level(q: int) -> int:
    """The loop-filter level for quantizer index ``q``: 5/16 of the AC step
    (chosen beside `LAMBDA`)."""
    return min(63, (int(AC_TABLE[q]) * 5) >> 4)




def _encode_mbs(Y, U, V, segs, quant, lambdas):
    if native.available():
        return native.vp8_encode_mbs(Y, U, V, segs, quant, lambdas, (_ROUND_DC, _ROUND_AC), _COEFF_PROBA0,
                                     BIT_COST, BMODES_PROBA)
    return _encode_mbs_py(Y, U, V, segs, quant, lambdas)


def _write_tokens(modes, levels, skips, probs, mb_w, n_parts):
    if native.available():
        return native.vp8_write_tokens(modes, levels, skips, probs, mb_w, n_parts)
    return _write_tokens_py(modes, levels, skips, probs, mb_w, n_parts)


def _write_modes(header_bits, modes, segs, skips, seg_probs, skip_p, mb_w):
    if native.available():
        return native.vp8_write_modes(header_bits, modes, segs, skips, seg_probs, skip_p, mb_w, BMODES_PROBA)
    return _write_modes_py(header_bits, modes, segs, skips, seg_probs, skip_p, mb_w)


def _prob(zeros, total) -> int:
    return 255 if not total else min(max(255 - ((total - zeros) * 255) // total, 1), 255)


def encode_vp8(rgb8: np.ndarray, *, partitions: int = 1, simple: bool = False, segments: int = 1) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> a VP8 key frame (the VP8 chunk's
    payload) at ``QUALITY``. ``partitions`` (1, 2, 4 or 8), ``simple`` (the simple loop
    filter) and ``segments`` (1 or 4: macroblocks by their luma variance
    in quartiles, quantizer indices q-4, q, q+4, q+8) are internal
    arguments for the tests."""
    h, w, _ = rgb8.shape
    if not 0 < w < 16384 or not 0 < h < 16384:
        raise ValueError(f"VP8: {w}x{h} is outside 1..16383")
    Y, U, V = rgb_to_yuv(rgb8)
    mb_w, mb_h = Y.shape[1] // 16, Y.shape[0] // 16
    q = quality_to_q(QUALITY)
    dq = (0, 0, 0, -2, 0)  # uv dc: libwebp's -4 x sns_strength (50) / 100
    if segments == 4:
        var = Y.reshape(mb_h, 16, mb_w, 16).astype(np.float64).var(axis=(1, 3)).reshape(-1)
        segs = np.searchsorted(np.quantile(var, [0.25, 0.5, 0.75]), var, side="right").astype(np.int32)
        seg_q = [min(max(q + d, 0), 127) for d in (-4, 0, 4, 8)]
    else:
        segs = np.zeros(mb_w * mb_h, np.int32)
        seg_q = [q] * 4
    quant = np.array([_quant_steps(sq, dq) for sq in seg_q], np.int32)
    lambdas = np.array([(LAMBDA * int(AC_TABLE[sq]) ** 2) >> 4 for sq in seg_q], np.int64)
    modes, levels = _encode_mbs(Y, U, V, segs, quant, lambdas)
    n_mb = mb_w * mb_h
    empty = ~levels.reshape(n_mb, -1).any(axis=1)
    skip_p = _prob(n_mb - int(empty.sum()), n_mb)
    use_skip = skip_p < 250
    skips = (empty & use_skip).astype(np.uint8)
    stats = _write_tokens(modes, levels, skips, None, mb_w, partitions)
    bits = []

    def val(v, n):
        bits.extend(((v >> i) & 1, 0x80) for i in reversed(range(n)))

    def signed(v, n):
        bits.append((int(v != 0), 0x80))
        if v:
            val(abs(v), n)
            bits.append((int(v < 0), 0x80))

    val(0, 2)  # colour space, clamping type
    levels_f = [filter_level(sq) for sq in seg_q]
    seg_probs = None
    if segments == 4:
        counts = np.bincount(segs, minlength=4)
        seg_probs = [_prob(counts[:2].sum(), n_mb), _prob(counts[0], counts[:2].sum()),
                     _prob(counts[2], counts[2:].sum())]
        val(0b111, 3)  # segmentation on, update the map, update the data
        bits.append((1, 0x80))  # absolute values
        for sq in seg_q:
            signed(sq, 7)
        for lf in levels_f:
            signed(lf, 6)
        for p in seg_probs:
            bits.append((1, 0x80))
            val(p, 8)
    else:
        val(0, 1)
    bits.append((int(simple), 0x80))
    val(levels_f[0] if segments == 1 else max(levels_f), 6)
    val(0, 3)  # sharpness
    val(0, 1)  # no loop-filter deltas
    val({1: 0, 2: 1, 4: 2, 8: 3}[partitions], 2)
    val(q, 7)
    for d in dq:
        signed(d, 4)
    val(0, 1)  # refresh entropy probabilities
    probs = _COEFF_PROBA0.copy()
    zeros, total = stats[..., 0], stats.sum(-1)
    for idx in np.ndindex(4, 8, 3, 11):
        old, upd = int(_COEFF_PROBA0[idx]), int(_UPDATE_PROBA[idx])
        new = _prob(int(zeros[idx]), int(total[idx]))
        n0, n1 = int(zeros[idx]), int(total[idx] - zeros[idx])
        cost = lambda p: n0 * _BIT_COST[p] + n1 * _BIT_COST[256 - p]  # noqa: E731
        gain = cost(old) - cost(new) - 8 * 256 - _BIT_COST[256 - upd] + _BIT_COST[upd]
        if total[idx] and new != old and gain > 0:
            probs[idx] = new
            bits.append((1, upd))
            val(new, 8)
        else:
            bits.append((0, upd))
    bits.append((int(use_skip), 0x80))
    if use_skip:
        val(skip_p, 8)
    part0 = _write_modes(np.array(bits, np.int32), modes, segs, skips, seg_probs, skip_p if use_skip else 0, mb_w)
    parts = _write_tokens(modes, levels, skips, probs, mb_w, partitions)
    if len(part0) >= 1 << 19:
        raise ValueError("VP8: the first partition exceeds 512 KiB")
    tag = (int(simple) << 1) | (1 << 4) | (len(part0) << 5)
    head = tag.to_bytes(3, "little") + b"\x9d\x01\x2a" + w.to_bytes(2, "little") + h.to_bytes(2, "little")
    sizes = b"".join(len(p).to_bytes(3, "little") for p in parts[:-1])
    return head + part0 + sizes + b"".join(parts)
