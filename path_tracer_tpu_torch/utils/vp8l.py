"""VP8L, WebP's lossless bitstream (RFC 9649), decoded without Pillow to
the pixels libwebp gives Pillow.

* `decode_stream`: an entropy-coded image at the top level (the VP8L
  chunk after its 5-byte header, or an ``ALPH`` chunk's lossless alpha):
  the transforms and their sub-images, the colour cache, the meta prefix
  codes (the entropy image), the five prefix codes of each group (simple
  and normal, with their code-length codes), LZ77 back references with
  the 120-entry distance map. Returns the transforms as read and the
  residual pixels, packed ARGB ``uint32``.
* `apply_transforms`: the inverse transforms in reverse order: colour
  indexing (pixel bundling at 1, 2 and 4 bits, indices past the palette
  transparent black), subtract green, cross colour and the predictor (all
  14 modes; 14 and 15 predict black as in libwebp; the rightmost column's
  top-right is the row's first pixel). NumPy: the predictor runs over
  the wavefronts ``x + 2y`` (each pixel's left, top, top-left and
  top-right neighbours lie on earlier ones).
* `decode_vp8l`: a VP8L chunk's payload -> ARGB ``uint32 [H, W]``.

The bit reader and decode loop run in `native` (host C++) where g++
built it, else in `_decode_stream_py`, which gives the same output. A
corrupt stream raises ``ValueError``; reading past the end is an error
as in libwebp (which reads a stream shorter than 8 bytes as if padded
with zeros to 8).
"""

from __future__ import annotations

import numpy as np

from path_tracer_tpu_torch import native

PREDICTOR, CROSS_COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)
MAGIC = 0x2F
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
# the 120 short distance codes as (dx, dy): distance = dx + dy * xsize (RFC 9649 4.2.2)
_DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2), (-1, 2), (2, 1), (-2, 1), (2, 2), (-2, 2),
    (0, 3), (3, 0), (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2), (-3, 2), (0, 4), (4, 0),
    (1, 4), (-1, 4), (4, 1), (-4, 1), (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5), (3, 4),
    (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5), (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2),
    (4, 4), (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0), (1, 6), (-1, 6), (6, 1), (-6, 1),
    (2, 6), (-2, 6), (6, 2), (-6, 2), (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6), (6, 3), (-6, 3),
    (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5), (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4),
    (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7), (7, 3), (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5),
    (8, 0), (4, 7), (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6), (8, 3), (5, 7), (-5, 7),
    (7, 5), (-7, 5), (8, 4), (6, 7), (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6), (8, 7))
DISTANCE_MAP = np.array(_DISTANCE_MAP, np.int32)  # also the native loop's table
# the error codes of the decode loop, shared with the native one
ERRORS = {-1: "corrupt prefix code", -2: "bad colour cache size", -3: "transform repeated",
          -4: "back reference out of range", -5: "truncated stream"}


class _Corrupt(Exception):
    def __init__(self, code):
        super().__init__(code)
        self.code = code


class _BitReader:
    """LSB-first bits; reading past ``max(8 * len, 64)`` bits (libwebp's
    end-of-stream test) marks the stream as ended."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(12)
        self.pos = 0
        self.limit = max(8 * len(data), 64)

    def peek(self, n: int) -> int:
        p = self.pos
        return (int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little") >> (p & 7)) & ((1 << n) - 1)

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos += n
        return v

    def check(self) -> None:
        if self.pos > self.limit:
            raise _Corrupt(-5)


def _build_code(lengths) -> tuple:
    """Code lengths -> (lookup table of (symbol, length) by the next
    ``bits`` stream bits, bits). One used symbol is a zero-bit code; else
    the code must be complete (libwebp's BuildHuffmanTable)."""
    used = [s for s, n in enumerate(lengths) if n]
    if len(used) == 1:
        return [(used[0], 0)], 0
    if not used:
        raise _Corrupt(-1)
    bits = max(lengths)
    if sum(1 << (bits - lengths[s]) for s in used) != 1 << bits:
        raise _Corrupt(-1)
    table = [None] * (1 << bits)
    code = 0
    for n in range(1, bits + 1):
        for s in used:
            if lengths[s] != n:
                continue
            rev = int(format(code, f"0{n}b")[::-1], 2)
            for k in range(rev, 1 << bits, 1 << n):
                table[k] = (s, n)
            code += 1
        code <<= 1
    return table, bits


def _read_symbol(br: _BitReader, code) -> int:
    table, bits = code
    s, n = table[br.peek(bits)] if bits else table[0]
    br.pos += n
    return s


def _read_code(br: _BitReader, size: int):
    lengths = [0] * size
    if br.read(1):  # simple code: one or two symbols
        count = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        symbols = [first] + ([br.read(8)] if count == 2 else [])
        for s in symbols:
            if s < size:
                lengths[s] = 1
    else:
        cl = [0] * 19
        for i in range(br.read(4) + 4):
            cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_code = _build_code(cl)
        max_symbol = size
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > size:
                raise _Corrupt(-1)
        symbol, prev = 0, 8
        while symbol < size:
            if max_symbol == 0:
                break
            max_symbol -= 1
            n = _read_symbol(br, cl_code)
            if n < 16:
                lengths[symbol] = n
                symbol += 1
                if n:
                    prev = n
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
                repeat = br.read(extra) + offset
                if symbol + repeat > size:
                    raise _Corrupt(-1)
                lengths[symbol:symbol + repeat] = [prev if n == 16 else 0] * repeat
                symbol += repeat
    br.check()
    return _build_code(lengths)


def _copy_value(br: _BitReader, symbol: int) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _sub(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _image(br: _BitReader, xsize: int, ysize: int, top: bool, transforms: list) -> np.ndarray:
    """DecodeImageStream: an entropy-coded image of ``xsize x ysize``
    (top: with transforms and meta codes), its ARGB pixels."""
    if top:
        seen = 0
        while br.read(1):
            kind = br.read(2)
            if seen >> kind & 1:
                raise _Corrupt(-3)
            seen |= 1 << kind
            if kind in (PREDICTOR, CROSS_COLOR):
                bits = br.read(3) + 2
                data = _image(br, _sub(xsize, bits), _sub(ysize, bits), False, transforms)
                transforms.append((kind, bits, xsize, data))
            elif kind == COLOR_INDEXING:
                colors = br.read(8) + 1
                bits = 0 if colors > 16 else 1 if colors > 4 else 2 if colors > 2 else 3
                data = _image(br, colors, 1, False, transforms)
                transforms.append((kind, bits, xsize, data))
                xsize = _sub(xsize, bits)
            else:
                transforms.append((kind, 0, xsize, np.zeros(0, np.uint32)))
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise _Corrupt(-2)
    meta_bits, groups_of = 0, None
    if top and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _sub(xsize, meta_bits)
        entropy = _image(br, meta_w, _sub(ysize, meta_bits), False, transforms)
        groups_of = ((entropy >> 8) & 0xFFFF).reshape(-1)
    n_groups = int(groups_of.max()) + 1 if groups_of is not None else 1
    cache_size = (1 << cache_bits) if cache_bits else 0
    groups = [[_read_code(br, size) for size in (280 + cache_size, 256, 256, 256, 40)]
              for _ in range(n_groups)]
    total = xsize * ysize
    out = [0] * total
    cache = [0] * cache_size
    shift = 32 - cache_bits
    pos = x = y = 0
    group = groups[0]

    def cache_insert(lo, hi):
        for i in range(lo, hi):
            cache[((out[i] * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = out[i]

    while pos < total:
        if groups_of is not None:
            group = groups[groups_of[(y >> meta_bits) * meta_w + (x >> meta_bits)]]
        code = _read_symbol(br, group[0])
        if code < 256:
            red = _read_symbol(br, group[1])
            blue = _read_symbol(br, group[2])
            alpha = _read_symbol(br, group[3])
            out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
            length = 1
        elif code < 280:
            length = _copy_value(br, code - 256)
            dist_code = _copy_value(br, _read_symbol(br, group[4]))
            if dist_code > 120:
                dist = dist_code - 120
            else:
                dx, dy = _DISTANCE_MAP[dist_code - 1]
                dist = max(dx + dy * xsize, 1)
            br.check()
            if dist > pos or length > total - pos:
                raise _Corrupt(-4)
            for i in range(pos, pos + length):
                out[i] = out[i - dist]
        else:
            out[pos] = cache[code - 280]
            length = 1
        if cache_size:
            cache_insert(pos, pos + length)
        pos += length
        x += length
        while x >= xsize:
            x -= xsize
            y += 1
    br.check()
    return np.array(out, np.uint32).reshape(ysize, xsize)


def _decode_stream_py(data: bytes, xsize: int, ysize: int, bit_pos: int = 0):
    """The Python decode loop: (transforms ``[(type, bits, xsize before,
    sub-image)]`` in stream order, residual pixels ``uint32 [ysize,
    xsize after colour indexing]``), or an error code of `ERRORS`."""
    br = _BitReader(data)
    br.pos = bit_pos
    transforms = []
    try:
        pixels = _image(br, xsize, ysize, True, transforms)
    except _Corrupt as err:
        return err.code
    return transforms, pixels


def decode_stream(data: bytes, xsize: int, ysize: int, bit_pos: int = 0):
    """`_decode_stream_py`'s output through the native loop where g++
    built it. Raises ``ValueError`` (without a file name) on a corrupt
    stream."""
    if native.available():
        res = native.vp8l_decode(data, xsize, ysize, bit_pos, DISTANCE_MAP)
    else:
        res = _decode_stream_py(data, xsize, ysize, bit_pos)
    if isinstance(res, int):
        raise ValueError(f"VP8L: {ERRORS.get(res, 'corrupt stream')}")
    return res


def _channels(px: np.ndarray) -> np.ndarray:
    """ARGB uint32 -> int32 ``[..., 4]`` (a, r, g, b)."""
    return np.stack([(px >> s) & 0xFF for s in (24, 16, 8, 0)], axis=-1).astype(np.int32)


def _pack(ch: np.ndarray) -> np.ndarray:
    ch = ch.astype(np.uint32) & 0xFF
    return (ch[..., 0] << 24) | (ch[..., 1] << 16) | (ch[..., 2] << 8) | ch[..., 3]


def _avg(a, b):
    return (a + b) >> 1


def _inverse_predictor(res: np.ndarray, bits: int, modes: np.ndarray) -> np.ndarray:
    h, w = res.shape
    r = _channels(res)
    o = np.zeros_like(r)
    o[0] = np.cumsum(r[0], axis=0)  # (0, 0): black (alpha 255) + residual; row 0: left
    o[0, :, 0] += 255
    if h > 1:
        o[1:, 0] = o[0, 0] + np.cumsum(r[1:, 0], axis=0)  # column 0: top
    o &= 0xFF
    if h == 1 or w == 1:
        return _pack(o)
    mode = ((modes >> 8) & 0xF).astype(np.int32)
    ys_all, xs_all = np.mgrid[1:h, 1:w]
    t_all = (xs_all + 2 * ys_all).reshape(-1)
    order = np.argsort(t_all, kind="stable")
    ys_all, xs_all, t_sorted = ys_all.reshape(-1)[order], xs_all.reshape(-1)[order], t_all[order]
    cuts = np.flatnonzero(np.diff(t_sorted)) + 1
    for ys, xs in zip(np.split(ys_all, cuts), np.split(xs_all, cuts)):
        left, top, tl = o[ys, xs - 1], o[ys - 1, xs], o[ys - 1, xs - 1]
        tr = np.where((xs + 1 < w)[:, None], o[ys - 1, np.minimum(xs + 1, w - 1)], o[ys, 0])
        m = mode[ys >> bits, xs >> bits]
        black = np.zeros_like(left)
        black[:, 0] = 255
        sel_lt = np.abs(left - tl).sum(-1) - np.abs(top - tl).sum(-1)  # Select(T, L, TL)
        avg_lt = _avg(left, top)
        half = avg_lt - tl
        preds = np.stack([
            black, left, top, tr, tl, _avg(_avg(left, tr), top), _avg(left, tl), avg_lt, _avg(tl, top),
            _avg(top, tr), _avg(_avg(left, tl), _avg(top, tr)),
            np.where((sel_lt <= 0)[:, None], top, left),
            np.clip(left + top - tl, 0, 255),
            np.clip(avg_lt + np.where(half < 0, -((-half) >> 1), half >> 1), 0, 255),
            black, black])
        o[ys, xs] = (r[ys, xs] + preds[m, np.arange(len(ys))]) & 0xFF
    return _pack(o)


def _inverse_cross_color(px: np.ndarray, bits: int, codes: np.ndarray) -> np.ndarray:
    h, w = px.shape
    c = codes[np.arange(h)[:, None] >> bits, np.arange(w)[None] >> bits]
    s8 = lambda v: ((v.astype(np.int32) & 0xFF) ^ 0x80) - 0x80  # noqa: E731
    g2r, g2b, r2b = s8(c), s8(c >> 8), s8(c >> 16)
    green = s8(px >> 8)
    red = ((px >> 16).astype(np.int32) + ((g2r * green) >> 5)) & 0xFF
    blue = (px.astype(np.int32) + ((g2b * green) >> 5) + ((r2b * ((red ^ 0x80) - 0x80)) >> 5)) & 0xFF
    return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def _inverse_subtract_green(px: np.ndarray) -> np.ndarray:
    g = (px >> 8) & 0xFF
    red = (((px >> 16) & 0xFF) + g) & 0xFF
    blue = ((px & 0xFF) + g) & 0xFF
    return (px & 0xFF00FF00) | (red << 16) | blue


def _inverse_color_indexing(px: np.ndarray, bits: int, width: int, colors: np.ndarray) -> np.ndarray:
    palette = np.zeros(256, np.uint32)
    ch = _channels(colors.reshape(-1))
    palette[:len(ch)] = _pack(np.cumsum(ch, axis=0) & 0xFF)  # delta-coded entries
    idx = ((px >> 8) & 0xFF).astype(np.int32)
    if bits:
        per = 1 << bits
        depth = 8 >> bits
        shifts = depth * np.arange(per)
        idx = ((idx[..., None] >> shifts) & ((1 << depth) - 1)).reshape(px.shape[0], -1)[:, :width]
    return palette[idx]


def apply_transforms(transforms, pixels: np.ndarray) -> np.ndarray:
    """The inverse transforms, last read first: residual pixels -> ARGB
    ``uint32 [H, W]``."""
    px = pixels
    for kind, bits, xsize, data in reversed(transforms):
        if kind == PREDICTOR:
            px = _inverse_predictor(px, bits, data)
        elif kind == CROSS_COLOR:
            px = _inverse_cross_color(px, bits, data)
        elif kind == SUBTRACT_GREEN:
            px = _inverse_subtract_green(px)
        else:
            px = _inverse_color_indexing(px, bits, xsize, data)
    return px


def header(data: bytes) -> tuple[int, int]:
    """The VP8L header: (width, height); raises on a bad signature or
    version."""
    if len(data) < 5 or data[0] != MAGIC or data[4] >> 5:
        raise ValueError("VP8L: bad header")
    v = int.from_bytes(data[1:5], "little")
    return (v & 0x3FFF) + 1, ((v >> 14) & 0x3FFF) + 1


def decode_vp8l(data: bytes) -> np.ndarray:
    """A VP8L chunk's payload -> ARGB ``uint32 [H, W]``."""
    w, h = header(data)
    return apply_transforms(*decode_stream(data, w, h, 40))
