"""CCITT bilevel coding in TIFF (ITU-T T.4 and T.6), as libtiff's
``tif_fax3.c`` decodes it for Pillow: compression 2 (modified Huffman,
rows byte-aligned, no EOLs), 3 (Group 3: an EOL before each row, fill bits
allowed; 1-D, or with T4Options bit 0 a tag bit then a 1-D or 2-D row) and
4 (Group 4: 2-D rows against the row above, an imaginary white row first).

`decode_py` is the Python twin of ``native.ccitt_decode``: the data of one
strip or tile (bits MSB-first; fill order 2 is reversed by the caller) ->
its rows, packed MSB-first, a run of the second colour ("black") as 1
bits, as libtiff fills them; the photometric interpretation is the
caller's. Uncompressed mode and rows whose runs do not add up to the width
raise, where libtiff warns and pads.
"""

from __future__ import annotations

import numpy as np

# T.4 Tables 2 and 3: terminating codes (runs 0-63) and make-up codes (64-1728),
# then the extended make-up codes (1792-2560) shared by both colours
_WHITE_TERM = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 110100 110101 "
    "101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 "
    "00000010 00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110 00010111 00101000 "
    "00101001 00101010 00101011 00101100 00101101 00000100 00000101 00001010 00001011 01010010 01010011 "
    "01010100 01010101 00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100")
_WHITE_MAKEUP = (
    "11011 10010 010111 0110111 00110110 00110111 01100100 01100101 01101000 01100111 011001100 011001101 "
    "011010010 011010011 011010100 011010101 011010110 011010111 011011000 011011001 011011010 011011011 "
    "010011000 010011001 010011010 011000 010011011")
_BLACK_TERM = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 00000111 "
    "000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 00000110111 "
    "00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 000011001101 000001101000 "
    "000001101001 000001101010 000001101011 000011010010 000011010011 000011010100 000011010101 "
    "000011010110 000011010111 000001101100 000001101101 000011011010 000011011011 000001010100 "
    "000001010101 000001010110 000001010111 000001100100 000001100101 000001010010 000001010011 "
    "000000100100 000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111")
_BLACK_MAKEUP = (
    "0000001111 000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 0000001110010 "
    "0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 0000001010010 0000001010011 "
    "0000001010100 0000001010101 0000001011010 0000001011011 0000001100100 0000001100101")
_EXT_MAKEUP = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 000000010101 "
               "000000010110 000000010111 000000011100 000000011101 000000011110 000000011111")
EOL = "000000000001"
# T.4 Table 4: the 2-D mode codes -> (mode, vertical offset)
_MODES = {"0001": ("P", 0), "001": ("H", 0), "1": ("V", 0), "011": ("V", 1), "000011": ("V", 2),
          "0000011": ("V", 3), "010": ("V", -1), "000010": ("V", -2), "0000010": ("V", -3)}
ERRORS = {-1: "bad CCITT code in the TIFF data", -2: "CCITT TIFF data is truncated",
          -3: "CCITT row whose runs do not add up to the image width",
          -4: "uncompressed-mode CCITT TIFF is not supported"}


def _codes(term: str, makeup: str) -> dict:
    """``{code: run}`` of one colour (make-up runs >= 64)."""
    out = {c: r for r, c in enumerate(term.split())}
    out.update({c: 64 * (i + 1) for i, c in enumerate(makeup.split())})
    out.update({c: 1792 + 64 * i for i, c in enumerate(_EXT_MAKEUP.split())})
    return out


WHITE, BLACK = _codes(_WHITE_TERM, _WHITE_MAKEUP), _codes(_BLACK_TERM, _BLACK_MAKEUP)


def _lut(codes: dict, bits: int) -> list:
    """A ``bits``-wide lookahead table: ``run << 4 | length``, -1 for EOL,
    0 for no code."""
    lut = [0] * (1 << bits)
    for c, run in list(codes.items()) + [(EOL, -1)]:
        lo = int(c, 2) << (bits - len(c))
        for i in range(lo, lo + (1 << (bits - len(c)))):
            lut[i] = -1 if run < 0 else run << 4 | len(c)
    return lut


WHITE_LUT, BLACK_LUT = _lut(WHITE, 12), _lut(BLACK, 13)


def decode_py(data: bytes, width: int, rows: int, code: int, options: int) -> tuple[bytes, int]:
    """One strip's (or tile's) CCITT data -> (``rows`` packed rows of
    ``width`` bits, 0), or (b"", a negative code of `ERRORS`). ``code`` is
    the TIFF compression (2, 3 or 4), ``options`` its T4Options (3) or
    T6Options (4)."""
    nbits = len(data) * 8
    big = int.from_bytes(bytes(data) + bytes(4), "big")
    total = nbits + 32
    pos = 0

    def peek(n):
        return (big >> (total - pos - n)) & ((1 << n) - 1)

    def run(lut, n):
        """One colour's run: make-up codes, then a terminating code."""
        nonlocal pos
        length = 0
        while True:
            if pos >= nbits:
                return -2
            e = lut[peek(n)]
            if e <= 0:
                return -1
            pos += e & 15
            length += e >> 4
            if e >> 4 < 64:
                return length

    out = np.zeros((rows, (width + 7) // 8 * 8), np.uint8)
    ref = [width, width]  # changing elements of the row above: an imaginary white row
    for r in range(rows):
        two_d = code == 4
        if code == 3:  # SYNC_EOL: 11 zeros or more, then a 1
            while pos + 11 <= nbits and peek(11) != 0:
                pos += 1
            if pos + 11 > nbits:
                return b"", -2
            while pos < nbits and not peek(1):
                pos += 1
            if pos >= nbits:
                return b"", -2
            pos += 1
            if options & 1:
                if pos >= nbits:
                    return b"", -2
                two_d = not peek(1)
                pos += 1
        cur = []
        if not two_d:  # 1-D: runs alternate, white first
            a0, colour = 0, 0
            while a0 < width:
                n = run(BLACK_LUT if colour else WHITE_LUT, 13 if colour else 12)
                if n < 0:
                    return b"", n
                a0 += n
                cur.append(a0)
                colour ^= 1
            if a0 != width:
                return b"", -3
            if code == 2:  # rows byte-aligned
                pos = (pos + 7) // 8 * 8
        else:
            a0, colour = -1, 0
            while a0 < width:
                i = 0  # b1: the first change on the row above past a0 to the other colour
                while i < len(ref) and (ref[i] <= a0 or i % 2 != colour):
                    i += 1
                b1 = ref[i] if i < len(ref) else width
                b2 = ref[i + 1] if i + 1 < len(ref) else width
                if pos >= nbits:
                    return b"", -2
                for k in range(1, 8):
                    mode = _MODES.get(format(peek(k), f"0{k}b"))
                    if mode:
                        pos += k
                        break
                else:
                    if peek(12) == 1 and code == 4:  # EOFB: the data ends before its rows do
                        return b"", -2
                    return b"", -4 if peek(7) == 1 else -1
                kind, d = mode
                if kind == "P":
                    a0 = b2
                elif kind == "H":
                    start = max(a0, 0)
                    n1 = run(BLACK_LUT if colour else WHITE_LUT, 13 if colour else 12)
                    n2 = run(WHITE_LUT if colour else BLACK_LUT, 12 if colour else 13) if n1 >= 0 else n1
                    if n2 < 0:
                        return b"", n2
                    a1, a2 = start + n1, start + n1 + n2
                    if a2 > width:
                        return b"", -3
                    cur += [a1, a2]
                    a0 = a2
                else:
                    a1 = b1 + d
                    if a1 < max(a0, 0) or a1 > width:
                        return b"", -3
                    cur.append(a1)
                    a0 = a1
                    colour ^= 1
        # the row: black (1) from each odd change to the next
        row = np.zeros(out.shape[1], np.uint8)
        edges = cur + [width] if len(cur) % 2 else cur
        for s, t in zip(edges[0::2], edges[1::2]):
            row[s:t] = 1
        out[r] = row
        ref = [c for c in cur if c < width] + [width, width]
    return np.packbits(out, axis=1).tobytes(), 0
