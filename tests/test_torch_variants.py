"""The JPEG and TIFF variants the JAX package opens through Pillow
(``path_tracer_tpu_torch/utils/``): arithmetic-coded and lossless JPEG;
TIFF with JPEG, CCITT or LZMA data, float, signed and 32-bit gray, CMYK,
YCbCr, CIELab, fill order 2, BigTIFF and every orientation.

Reading: ``envmap.load_image`` equals the JAX package's bit for bit on
every variant. Pillow writes none of them (nor does it write arithmetic
or lossless JPEG), so the functions below write the files: an arithmetic
encoder (``jcarith.c``) that transcodes a Pillow JPEG's coefficients, a
lossless encoder, CCITT and TIFF writers. Pillow's decode of their bytes
is the reference, so a fault in one of them cannot hide one in the port.
Each native loop equals its Python twin, corrupt files raise only
``ValueError``, the committed digests equal Pillow's, and the
lossless-sky scene's host tables equal the JAX package's.

``PYTHONPATH=. python tests/test_torch_variants.py`` rewrites the
variant assets (``assets/sky_arith.jpg``, ``assets/sky_lossless.jpg``,
``assets/variant_*.tif``) and ``assets/variant_digests.json``, the
SHA-256 of Pillow's ``convert("RGB")`` bytes of each, which
``chip_smoke.py`` holds the port's decoders to on the card's machine.
"""

import hashlib
import io
import json
import lzma
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image
from test_torch_inputs import _assert_scenes_equal

from path_tracer_tpu import native as jnative
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.utils import config as jconfig
from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.utils import ccitt, imageio, jpeg_arith, jpeg_lossless
from path_tracer_tpu_torch.utils import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pixels(h, w, seed, channels=3):
    """A smooth pattern with noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 5 + c) * np.cos(y / 4 - c) for c in range(channels)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def pillow(img, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


# --- arithmetic JPEG: jcarith.c ---


class ArithEncoder:
    """T.81 Annex D's encoder with jcarith.c's byte output (carry
    propagation over stacked 0xFF bytes, stuffing, the final flush)."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe = int(jpeg_arith.QE[sv & 0x7F])
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            b = (self.c >> 19) & 0xFF
            self._emit(b)
            if b == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                b = (self.c >> 11) & 0xFF
                self._emit(b)
                if b == 0xFF:
                    self._emit(0)
        self.zc = 0


def _arith_value(enc, stats, st, v, x1, ac):
    """Figures F.8 / F.9: the magnitude category and bits of ``v`` >= 1
    (``st`` at the first category bin, ``x1`` the X1 bin)."""
    v -= 1
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        if ac:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                st = x1
                while v2 >> 1:
                    v2 >>= 1
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        else:
            st = x1
            while v2 >> 1:
                v2 >>= 1
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1


def arith_scan(blocks, comp_of, tabs, script, cond, restart_every, mcu_len):
    """Entropy-code one scan: ``blocks`` the scan's blocks in order (natural
    order, int), ``comp_of[i]`` each block's scan component, ``tabs[c] =
    (dc, ac)`` its tables, ``script = (ss, se, ah, al)`` (None:
    sequential), ``cond = (L, U, K)``, a restart marker after every
    ``restart_every`` MCUs of ``mcu_len`` blocks. Returns the data with its
    RSTn markers."""
    nat = imageio._ZIGZAG.tolist()
    dl, du, kx = cond
    enc = ArithEncoder()
    fixed = [jpeg_arith.FIXED]
    seq = script is None
    ss, se, ah, al = script or (0, 63, 0, 0)
    n_comps = max(comp_of) + 1
    out, rst = bytearray(), 0
    n_mcu = len(blocks) // mcu_len
    per = restart_every or n_mcu
    for start in range(0, n_mcu, per):
        if start:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + rst % 8])
            rst += 1
            enc.out = bytearray()
            enc.reset()
        dcs = [[0] * 64 for _ in range(16)]
        acs = [[0] * 256 for _ in range(16)]
        last, ctx = [0] * n_comps, [0] * n_comps
        for b in range(start * mcu_len, min(n_mcu, start + per) * mcu_len):
            blk, ci = blocks[b], comp_of[b]
            t_dc, t_ac = tabs[ci]
            if seq or (ss == 0 and ah == 0):  # DC (F.1.4.1, G.1.3.1)
                dc = blk[0] if seq else blk[0] >> al
                v = dc - last[ci]
                stats, st = dcs[t_dc], ctx[ci]
                if v == 0:
                    enc.encode(stats, st, 0)
                    ctx[ci] = 0
                else:
                    last[ci] = dc
                    enc.encode(stats, st, 1)
                    sign = v < 0
                    enc.encode(stats, st + 1, int(sign))
                    st += 3 if sign else 2
                    mag = -v if sign else v
                    m = (mag - 1).bit_length() and 1 << ((mag - 1).bit_length() - 1)
                    ctx[ci] = 0 if m < (1 << dl[t_dc]) >> 1 else (12 if m > (1 << du[t_dc]) >> 1 else 4) + 4 * sign
                    _arith_value(enc, stats, st, mag, 20, False)
                if not seq:
                    continue
            elif ss == 0:  # DC refinement
                enc.encode(fixed, 0, (blk[0] >> al) & 1)
                continue
            stats = acs[t_ac]
            lo, hi = (1, 63) if seq else (ss, se)

            def val(k):  # the point-transformed value, rounded towards 0
                x = blk[nat[k]]
                return (x >> al) if x >= 0 else -((-x) >> al)

            ke = hi
            while ke >= lo and val(ke) == 0:
                ke -= 1
            if seq or not ah:  # sequential, or AC first (F.1.4.2, G.1.3.2)
                k = lo
                while k <= ke:
                    st = 3 * (k - 1)
                    enc.encode(stats, st, 0)
                    while val(k) == 0:
                        enc.encode(stats, st + 1, 0)
                        st += 3
                        k += 1
                    v = val(k)
                    enc.encode(stats, st + 1, 1)
                    enc.encode(fixed, 0, int(v < 0))
                    _arith_value(enc, stats, st + 2, abs(v), 189 if k <= kx[t_ac] else 217, True)
                    k += 1
            else:  # AC refinement (G.1.3.3)
                kex = ke
                while kex >= lo and abs(val(kex)) >> 1 == 0:
                    kex -= 1
                k = lo
                while k <= ke:
                    st = 3 * (k - 1)
                    if k > kex:
                        enc.encode(stats, st, 0)
                    while True:
                        v = abs(val(k))
                        if v:
                            if v >> 1:
                                enc.encode(stats, st + 2, v & 1)
                            else:
                                enc.encode(stats, st + 1, 1)
                                enc.encode(fixed, 0, int(val(k) < 0))
                            break
                        enc.encode(stats, st + 1, 0)
                        st += 3
                        k += 1
                    k += 1
            if k <= hi:
                enc.encode(stats, 3 * (k - 1), 1)  # EOB
    enc.finish()
    return bytes(out + enc.out)


# the progressive script of jcparam.c jpeg_simple_progression (YCbCr, or
# its luma scans for gray): (components, Ss, Se, Ah, Al)
PROGRESSION = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))


def arith_jpeg(src: bytes, progressive=False, restart=0, dac=None) -> bytes:
    """``src`` (a Huffman JPEG) with its coefficients coded arithmetically:
    SOF9, or SOF10 with `PROGRESSION`; a restart interval of ``restart``
    MCUs; ``dac = (L, U, K)`` written as a DAC segment (else the
    defaults)."""
    frame, comps, jfif, _ = imageio._read_jpeg(src, "src")
    hmax, vmax = frame["hmax"], frame["vmax"]
    mx, my = -(-frame["wid"] // (8 * hmax)), -(-frame["hgt"] // (8 * vmax))
    n = len(comps)
    cond = ([0] * 16, [1] * 16, [5] * 16)
    tabs = [(min(i, 1), min(i, 1)) for i in range(n)]
    if dac:
        cond = ([dac[0]] * 16, [dac[1]] * 16, [dac[2]] * 16)
    coef = [c["coef"].astype(np.int64) for c in comps]
    scans = b""
    script = ([(tuple(i for i in s[0] if i < n),) + s[1:] for s in PROGRESSION if min(s[0]) < n] if progressive
              else [(tuple(range(n)), None)])
    for entry in script:
        ids, sp = entry[0], (entry[1:] if progressive else None)
        if len(ids) > 1 or n == 1 and not progressive:
            geom = [(comps[i]["h"], comps[i]["v"]) if n > 1 else (1, 1) for i in ids]
            blocks, comp_of = [], []
            mxs, mys = (mx, my) if n > 1 else (-(-comps[0]["w"] // 8), -(-comps[0]["hgt"] // 8))
            for y in range(mys):
                for x in range(mxs):
                    for si, i in enumerate(ids):
                        h, v = geom[si]
                        for by in range(v):
                            for bx in range(h):
                                blocks.append(coef[i][y * v + by, x * h + bx].tolist())
                                comp_of.append(si)
            mcu_len = sum(h * v for h, v in geom)
        else:
            i = ids[0]
            bh, bw = -(-comps[i]["hgt"] // 8), -(-comps[i]["w"] // 8)
            blocks = [coef[i][y, x].tolist() for y in range(bh) for x in range(bw)]
            comp_of, mcu_len = [0] * len(blocks), 1
        data = arith_scan(blocks, comp_of, [tabs[i] for i in ids], sp, cond, restart, mcu_len)
        ss, se, ah, al = sp or (0, 63, 0, 0)
        scans += seg(0xDA, bytes([len(ids)]) + b"".join(bytes([comps[i]["id"], tabs[i][0] << 4 | tabs[i][1]])
                                                          for i in ids) + bytes([ss, se, ah << 4 | al])) + data
    qts = sorted({c["tq"] for c in comps})
    q_by = {c["tq"]: c["q"] for c in comps}
    dqt = b"".join(seg(0xDB, bytes([t]) + q_by[t][imageio._ZIGZAG].astype(np.uint8).tobytes()) for t in qts)
    sof = seg(0xCA if progressive else 0xC9, struct.pack(">BHHB", 8, frame["hgt"], frame["wid"], n)
              + b"".join(bytes([c["id"], c["h"] << 4 | c["v"], c["tq"]]) for c in comps))
    dac_seg = seg(0xCC, b"".join(bytes([t, dac[1] << 4 | dac[0], 16 + t, dac[2]]) for t in range(2))) if dac else b""
    dri = seg(0xDD, struct.pack(">H", restart)) if restart else b""
    return b"\xff\xd8" + (imageio._JFIF_APP0 if jfif else b"") + dqt + sof + dac_seg + dri + scans + b"\xff\xd9"


# --- lossless JPEG ---

# a DC-style table extended to the 17 categories of lossless JPEG
LL_COUNTS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0)


def optimal_table(freq) -> tuple:
    """jchuff.c jpeg_gen_optimal_table: (counts by length 1..16, symbols)
    of a Huffman table for the symbol frequencies ``freq`` (at most 256)."""
    freq = list(freq) + [0] * (257 - len(freq))
    freq[256] = 1  # the reserved code point: no code is all ones
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v:
                v, c1 = freq[i], i
        v = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v and i != c1:
                v, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved code point
    order = sorted((codesize[k], k) for k in range(256) if codesize[k])
    return tuple(bits[1:17]), bytes(k for _, k in order)


def lossless_jpeg(planes, factors=None, predictor=1, pt=0, restart_rows=0, ids=None, marker=None,
                  separate=False, optimal=False) -> bytes:
    """SOF3 of uint8 ``planes`` (each at its own size: subsampled planes
    given subsampled), the given sampling ``factors``, predictor, point
    transform, a restart every ``restart_rows`` MCU rows, component
    ``ids``, an optional ``marker`` (``jfif`` or ``adobe0``/``adobe1``), one
    scan (interleaved) or a scan per component (``separate``); the
    extended DC table, or (``optimal``) one built from the differences."""
    n = len(planes)
    factors = factors or [(1, 1)] * n
    ids = ids or list(range(1, n + 1))
    hmax, vmax = max(f[0] for f in factors), max(f[1] for f in factors)
    wid = max(p.shape[1] * hmax // f[0] for p, f in zip(planes, factors))
    hgt = max(p.shape[0] * vmax // f[1] for p, f in zip(planes, factors))
    planes = [np.pad(p, ((0, -(-hgt * f[1] // vmax) - p.shape[0]), (0, -(-wid * f[0] // hmax) - p.shape[1])),
                     mode="edge") for p, f in zip(planes, factors)]
    table = (LL_COUNTS, bytes(range(17)))
    seed = 1 << (8 - pt - 1)

    def diffs(p, resets):
        s = p.astype(np.int64) >> pt
        h, w = s.shape
        d = np.zeros_like(s)
        for y in range(h):
            for x in range(w):
                ra = s[y, x - 1] if x else 0
                rb = s[y - 1, x] if y else 0
                rc = s[y - 1, x - 1] if x and y else 0
                if y in resets:
                    pr = seed if x == 0 else ra
                elif x == 0:
                    pr = rb
                else:
                    pr = [ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                          (ra + rb) >> 1][predictor - 1]
                d[y, x] = (s[y, x] - pr) & 0xFFFF
        return np.where(d >= 32768, d - 65536, d)

    bits = []

    def put(v, nbits):
        bits.extend((v >> (nbits - 1 - i)) & 1 for i in range(nbits))

    def put_diff(v):
        if v == -32768:
            put(int(codes[16]), int(sizes[16]))
            return
        s = abs(v).bit_length()
        put(int(codes[s]), int(sizes[s]))
        if s:
            put(v if v >= 0 else v - 1 & ((1 << s) - 1), s)

    def flush():
        nonlocal bits
        if len(bits) % 8:
            bits.extend([1] * (8 - len(bits) % 8))
        raw = np.packbits(np.array(bits, np.uint8)).tobytes() if bits else b""
        bits = []
        return raw.replace(b"\xff", b"\xff\x00")

    scans = b""
    groups = [[i] for i in range(n)] if separate or n == 1 else [list(range(n))]
    per = restart_rows
    coded = []
    for grp in groups:
        inter = len(grp) > 1
        geom = [factors[i] if inter else (1, 1) for i in grp]
        mxs = -(-wid // hmax) if inter else planes[grp[0]].shape[1]
        mys = -(-hgt // vmax) if inter else planes[grp[0]].shape[0]
        ds = []
        for i, (h, v) in zip(grp, geom):
            resets = jpeg_lossless.reset_rows(mys, v, factors[i][1], per)
            pad = np.pad(planes[i], ((0, mys * v - planes[i].shape[0]), (0, mxs * h - planes[i].shape[1])), mode="edge")
            ds.append(diffs(pad, resets))
        coded.append((grp, geom, mxs, mys, ds))
    if optimal:
        cats = np.concatenate([np.where(d == -32768, 16, np.abs(d).astype(np.int64)).ravel() for *_, ds in coded
                               for d in ds])
        cats = np.where(cats == 16, 16, np.ceil(np.log2(cats + 1)).astype(np.int64))
        table = optimal_table(np.bincount(cats, minlength=17))
    codes, sizes = imageio._encode_table(*table)
    for grp, geom, mxs, mys, ds in coded:
        data, rst = b"", 0
        for my in range(mys):
            if per and my and my % per == 0:
                data += flush() + bytes([0xFF, 0xD0 + rst % 8])
                rst += 1
            for mx in range(mxs):
                for d, (h, v) in zip(ds, geom):
                    for y in range(v):
                        for x in range(h):
                            put_diff(int(d[my * v + y, mx * h + x]))
        data += flush()
        scans += seg(0xDA, bytes([len(grp)]) + b"".join(bytes([ids[i], 0]) for i in grp)
                     + bytes([predictor, 0, pt])) + data
    app = {None: b"", "jfif": imageio._JFIF_APP0, "adobe0": seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00"),
           "adobe1": seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x01")}[marker]
    sof = seg(0xC3, struct.pack(">BHHB", 8, hgt, wid, n)
              + b"".join(bytes([ids[i], factors[i][0] << 4 | factors[i][1], 0]) for i in range(n)))
    dht = seg(0xC4, b"\x00" + bytes(table[0]) + table[1])
    dri = seg(0xDD, struct.pack(">H", restart_rows * (-(-wid // hmax) if len(groups) == 1 and n > 1
                                                      else planes[0].shape[1]))) if restart_rows else b""
    return b"\xff\xd8" + app + sof + dht + dri + scans + b"\xff\xd9"


# --- TIFF ---

_TYPE_FMT = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 18: "Q"}


def tiff_bytes(tags: dict, blocks, order="<", big=False, tiled=False) -> bytes:
    """A TIFF (BigTIFF: ``big``) of one IFD with ``tags`` (``{tag: (type,
    values)}``) and the strips or tiles ``blocks``; the offsets and byte
    counts are filled in (as LONG, or LONG8 in a BigTIFF)."""
    tags = dict(tags)
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    long_t = 16 if big else 4
    tags[off_tag] = (long_t, [0] * len(blocks))
    tags[cnt_tag] = (long_t, [len(b) for b in blocks])
    entry, inline, head = (20, 8, 16) if big else (12, 4, 8)
    ifd_size = (8 if big else 2) + entry * len(tags) + (8 if big else 4)
    packed = {t: struct.pack(order + _TYPE_FMT[typ] * len(v), *v) for t, (typ, v) in tags.items()}
    heap_at = head + ifd_size
    heap_len = sum(len(p) + len(p) % 2 for t, p in packed.items() if len(p) > inline)
    data_at = heap_at + heap_len
    offsets = np.cumsum([data_at] + [len(b) for b in blocks])[:-1].tolist()
    packed[off_tag] = struct.pack(order + _TYPE_FMT[long_t] * len(blocks), *offsets)
    entries, heap = [], b""
    for tag in sorted(tags):
        typ, vals = tags[tag]
        p = packed[tag]
        count = len(vals) // (2 if typ in (5, 10) else 1)
        if len(p) <= inline:
            body = p.ljust(inline, b"\0")
        else:
            body = struct.pack(order + ("Q" if big else "I"), heap_at + len(heap))
            heap += p + b"\0" * (len(p) % 2)
        entries.append(struct.pack(order + ("HHQ" if big else "HHI"), tag, typ, count) + body)
    if big:
        hdr = (b"II" if order == "<" else b"MM") + struct.pack(order + "HHHQ", 43, 8, 0, 16)
        ifd = struct.pack(order + "Q", len(entries)) + b"".join(entries) + bytes(8)
    else:
        hdr = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(order + "I", 8)
        ifd = struct.pack(order + "H", len(entries)) + b"".join(entries) + bytes(4)
    return hdr + ifd + heap + b"".join(blocks)


def lzw(raw: bytes) -> bytes:
    """TIFF LZW of ``raw`` (Pillow's encoder: the bytes as an 8-bit image
    of one strip)."""
    im = Image.frombytes("L", (len(raw), 1), raw)
    d = pillow(im, "TIFF", compression="tiff_lzw")
    t = Image.open(io.BytesIO(d)).tag_v2
    return d[t[273][0]:t[273][0] + t[279][0]]


def compress(raw: bytes, code: int) -> bytes:
    return {5: lambda: lzw(raw), 8: lambda: zlib.compress(raw),
            34925: lambda: lzma.compress(raw, format=lzma.FORMAT_XZ)}.get(code, lambda: raw)()


def ycbcr_blocks(rgb: np.ndarray, sub=(2, 2), rows_per_strip=None):
    """``rgb`` as YCbCr (jccolor.c's transform) in TIFF's subsampled data
    units: for each ``sub`` block of Y samples, then its Cb and Cr (the
    block's top-left chroma); the strips' raw bytes."""
    y, cb, cr = imageio._rgb_to_ycc(rgb)
    sh, sv = sub
    h, w = y.shape
    rps = rows_per_strip or h
    strips = []
    for y0 in range(0, h, rps):
        out = bytearray()
        for by in range(y0, min(h, y0 + rps), sv):
            for bx in range(0, w, sh):
                ys = [int(y[min(by + j, h - 1), min(bx + i, w - 1)]) for j in range(sv) for i in range(sh)]
                out += bytes(ys + [int(cb[by, bx]), int(cr[by, bx])])
        strips.append(bytes(out))
    return strips


def reverse_bits(data: bytes) -> bytes:
    table = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
    return data.translate(table)


def jpeg_parts(data: bytes):
    """A JPEG stream split into libtiff's JPEGTables (SOI, DQT, DHT, EOI)
    and an abbreviated image stream (SOI, the rest)."""
    frame, _, _, _ = imageio._read_jpeg(data, "src")
    pos, tables, image = 2, b"\xff\xd8", b"\xff\xd8"
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xDA:
            image += data[pos:]
            break
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m in (0xDB, 0xC4):
            tables += data[pos:pos + 2 + n]
        elif m != 0xE0:
            image += data[pos:pos + 2 + n]
        pos += 2 + n
    return tables + b"\xff\xd9", image


def jpeg_tiff(px: np.ndarray, photometric: int, tile=None, rows_per_strip=None, order="<", quality=80,
              big=False, orientation=None, fill=None) -> bytes:
    """A JPEG TIFF of ``px`` (``[h, w]`` gray, ``[h, w, 3]`` RGB or ``[h, w,
    4]`` CMYK), each strip or tile Pillow's JPEG of its pixels (edge tiles
    padded), the tables in JPEGTables. Photometric 2 codes the RGB planes
    as they are (Pillow's RGB TIFF writer's streams), 6 as YCbCr 4:2:0."""
    h, w = px.shape[:2]
    spp = 1 if px.ndim == 2 else px.shape[2]
    bw, bh = tile or (w, rows_per_strip or h)
    blocks, tables = [], None
    for y in range(0, h, bh):
        for x in range(0, w, bw):
            part = px[y:y + bh, x:x + bw]
            if tile:
                part = np.pad(part, ((0, bh - part.shape[0]), (0, bw - part.shape[1])) + ((0, 0),) * (px.ndim - 2),
                              mode="edge")
            if photometric == 2:  # an RGB stream: Pillow's RGB JPEG TIFF of the block
                d = pillow(Image.fromarray(part), "TIFF", compression="jpeg", quality=quality)
                t = Image.open(io.BytesIO(d)).tag_v2
                tab, img = bytes(t[347]), d[t[273][0]:t[273][0] + t[279][0]]
            else:
                mode = {1: "L", 3: "RGB", 4: "CMYK"}[spp]
                tab, img = jpeg_parts(pillow(Image.fromarray(part, mode), "JPEG", quality=quality))
            tables = tables or tab
            blocks.append(img)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp), 259: (3, [7]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [1]), 347: (7, list(tables))}
    if photometric == 6:
        tags[530] = (3, [2, 2])
    if orientation:
        tags[274] = (3, [orientation])
    if fill:
        tags[266] = (3, [fill])
    if tile:
        tags.update({322: (3, [bw]), 323: (3, [bh])})
    else:
        tags[278] = (3, [bh])
    return tiff_bytes(tags, blocks, order=order, big=big, tiled=bool(tile))


def sample_tiff(samples: np.ndarray, bits: int, photometric: int, *, fmt=1, code=1, order="<", big=False,
                rows_per_strip=None, extra=(), fill=1, orientation=None, tile=None, predictor=1, more=None) -> bytes:
    """A TIFF of ``samples [h, w, spp]`` (values of ``bits`` bits, NumPy
    dtype ``fmt``-typed at 16 / 32 bits) with the given compression
    (1, 5, 8 or 34925), byte order, layout and tags."""
    h, w, spp = samples.shape
    bw, bh = tile or (w, rows_per_strip or h)
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    blocks = []
    for y in range(0, h, bh):
        for x in range(0, w, bw):
            blk = samples[y:y + bh, x:x + bw]
            if tile:
                blk = np.pad(blk, ((0, bh - blk.shape[0]), (0, bw - blk.shape[1]), (0, 0)))
            if predictor == 2:
                blk = np.diff(blk.astype(np.int64), axis=1, prepend=0) % (1 << bits)
            if bits >= 8:
                raw = blk.astype(f"{order}{kind}{bits // 8}").tobytes()
            else:
                v = blk.reshape(blk.shape[0], -1).astype(np.int64)
                bitrows = ((v[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(v.shape[0], -1)
                raw = np.packbits(bitrows.astype(np.uint8), axis=1).tobytes()
            raw = compress(raw, code)
            blocks.append(reverse_bits(raw) if fill == 2 else raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [code]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [1])}
    if fmt != 1:
        tags[339] = (3, [fmt] * spp)
    if extra:
        tags[338] = (3, list(extra))
    if fill != 1:
        tags[266] = (3, [fill])
    if orientation:
        tags[274] = (3, [orientation])
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (3, [bw]), 323: (3, [bh])})
    else:
        tags[278] = (3, [bh])
    tags.update(more or {})
    return tiff_bytes(tags, blocks, order=order, big=big, tiled=bool(tile))


def ycbcr_tiff(px, sub=(2, 2), code=8, rows_per_strip=None, more=None, order="<") -> bytes:
    """A YCbCr TIFF (photometric 6) of ``px``, ``sub``-sampled, compressed."""
    h, w = px.shape[:2]
    rps = rows_per_strip or h
    strips = [compress(s, code) for s in ycbcr_blocks(px, sub, rps)]
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [code]), 262: (3, [6]), 277: (3, [3]),
            278: (3, [rps]), 284: (3, [1]), 530: (3, list(sub)), **(more or {})}
    return tiff_bytes(tags, strips, order=order)


def bilevel(h, w, seed):
    """Bilevel pixels with runs: blocks of noise."""
    rng = np.random.default_rng(seed)
    return np.kron(rng.random((h // 3 + 1, w // 4 + 1)) > 0.5, np.ones((3, 4), bool))[:h, :w] ^ (rng.random((h, w)) > 0.93)


def ccitt_tiff(bw: np.ndarray, compression: str, t4=None, photometric=None, fill=None) -> bytes:
    """Pillow's (libtiff's) CCITT TIFF of bilevel ``bw``; the photometric
    and fill order rewritten (the data's bits reversed for fill order 2)."""
    d = pillow(Image.fromarray(bw), "TIFF", compression=compression, tiffinfo={292: t4} if t4 is not None else {})
    t = Image.open(io.BytesIO(d)).tag_v2
    if photometric is None and fill is None:
        return d
    strip = d[t[273][0]:t[273][0] + t[279][0]]
    tags = {256: (4, [bw.shape[1]]), 257: (4, [bw.shape[0]]), 258: (3, [1]), 259: (3, [t[259]]),
            262: (3, [photometric if photometric is not None else 1]), 278: (4, [bw.shape[0]])}
    if t4 is not None:
        tags[292] = (4, [t4])
    if fill:
        tags[266] = (3, [fill])
    return tiff_bytes(tags, [reverse_bits(strip) if fill == 2 else strip])


# --- the cases ---

RGB = pixels(17, 33, 1)
GRAY = RGB[..., 0]
ODD = pixels(1, 1, 2)
_RNG = np.random.default_rng(7)
_S16 = _RNG.integers(-3000, 60000, (9, 13)) - 20000
_S32 = _RNG.integers(-300, 700, (9, 13))
_U32 = _RNG.integers(0, 1 << 32, (9, 13), dtype=np.uint64).astype(np.int64) % 1000 + (1 << 31) * (_RNG.random((9, 13)) < 0.2)
_F32 = np.concatenate([(_RNG.random((8, 13)) * 400 - 50), np.array([[62.87, -3, 255.9, 256, 1e10, np.inf, -np.inf,
                                                                       np.nan, 3e9, 0.99, 0.0, 17.5, 254.99]])]).astype(np.float32)
_CMYK = pixels(11, 14, 3, 4)
_CMYK16 = _RNG.integers(0, 65536, (9, 13, 4))
_BW = bilevel(21, 45, 4)


def _jpeg(px, **kw):
    return pillow(Image.fromarray(px), "JPEG", **kw)


def _ll(planes, **kw):
    return lossless_jpeg(planes, **kw)


_PLANES = [RGB[..., i] for i in range(3)]
_SUB21 = [RGB[..., 0], RGB[:, ::2, 1], RGB[:, ::2, 2]]

READ_CASES = {
    # arithmetic-coded JPEG: a Pillow file's coefficients transcoded
    "arith_seq_420": lambda: arith_jpeg(_jpeg(RGB)),
    "arith_seq_444": lambda: arith_jpeg(_jpeg(RGB, quality=92, subsampling=0)),
    "arith_seq_gray": lambda: arith_jpeg(_jpeg(GRAY)),
    "arith_seq_restart": lambda: arith_jpeg(_jpeg(RGB), restart=2),
    "arith_seq_dac": lambda: arith_jpeg(_jpeg(RGB, subsampling=0), dac=(2, 5, 3)),
    "arith_prog_420": lambda: arith_jpeg(_jpeg(RGB), progressive=True),
    "arith_prog_444_restart_dac": lambda: arith_jpeg(_jpeg(RGB, subsampling=0), progressive=True, restart=3,
                                                     dac=(1, 3, 2)),
    "arith_prog_gray": lambda: arith_jpeg(_jpeg(GRAY), progressive=True),
    "arith_1x1": lambda: arith_jpeg(_jpeg(ODD), progressive=True),
    "arith_17x33_from_progressive": lambda: arith_jpeg(_jpeg(RGB, progressive=True)),
    # lossless JPEG
    **{f"lossless_gray_p{p}": (lambda p: lambda: _ll([GRAY], predictor=p))(p) for p in range(1, 8)},
    "lossless_gray_pt2": lambda: _ll([GRAY], predictor=4, pt=2),
    "lossless_gray_restart": lambda: _ll([GRAY], predictor=7, restart_rows=3),
    "lossless_gray_v2_restart": lambda: _ll([GRAY], factors=[(2, 2)], predictor=6, restart_rows=1),
    "lossless_rgb_ids": lambda: _ll(_PLANES, predictor=5, ids=[82, 71, 66]),
    "lossless_123_ids": lambda: _ll(_PLANES, predictor=3, pt=1),
    "lossless_123_adobe0": lambda: _ll(_PLANES, predictor=1, marker="adobe0"),
    "lossless_sampled_21": lambda: _ll(_SUB21, factors=[(2, 1), (1, 1), (1, 1)], predictor=4, restart_rows=2),
    "lossless_separate_scans_22": lambda: _ll([RGB[..., 0], RGB[::2, ::2, 1], RGB[::2, ::2, 2]],
                                              factors=[(2, 2), (1, 1), (1, 1)], predictor=2, separate=True),
    "lossless_1x1": lambda: _ll([ODD[..., 0]], predictor=6),
    # TIFF: JPEG strips and tiles
    "tiff_jpeg_pillow_rgb": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="jpeg"),
    "tiff_jpeg_pillow_gray": lambda: pillow(Image.fromarray(GRAY), "TIFF", compression="jpeg"),
    "tiff_jpeg_pillow_cmyk": lambda: pillow(Image.fromarray(_CMYK, "CMYK"), "TIFF", compression="jpeg"),
    "tiff_jpeg_ycbcr_strips": lambda: jpeg_tiff(RGB, 6, rows_per_strip=16),
    "tiff_jpeg_ycbcr_tiles_be": lambda: jpeg_tiff(RGB, 6, tile=(16, 16), order=">"),
    "tiff_jpeg_rgb_tiles": lambda: jpeg_tiff(RGB, 2, tile=(16, 16)),
    "tiff_jpeg_gray_tiles": lambda: jpeg_tiff(GRAY, 1, tile=(32, 16)),
    "tiff_jpeg_cmyk_strips": lambda: jpeg_tiff(_CMYK, 5, rows_per_strip=8),
    "tiff_jpeg_fill_order_2": lambda: jpeg_tiff(RGB, 2, fill=2),
    # CCITT at both photometrics and fill orders
    "tiff_ccitt_rle": lambda: ccitt_tiff(_BW, "tiff_ccitt"),
    "tiff_ccitt_rle_white_is_zero": lambda: ccitt_tiff(_BW, "tiff_ccitt", photometric=0),
    "tiff_ccitt_g3_1d": lambda: ccitt_tiff(_BW, "group3"),
    "tiff_ccitt_g3_1d_fill_bits": lambda: ccitt_tiff(_BW, "group3", t4=4, photometric=0),
    "tiff_ccitt_g3_2d": lambda: ccitt_tiff(_BW, "group3", t4=1),
    "tiff_ccitt_g3_2d_fill_order_2": lambda: ccitt_tiff(_BW, "group3", t4=5, fill=2),
    "tiff_ccitt_g4": lambda: ccitt_tiff(_BW, "group4"),
    "tiff_ccitt_g4_white_is_zero_fill_order_2": lambda: ccitt_tiff(_BW, "group4", photometric=0, fill=2),
    "tiff_ccitt_g4_wide_runs": lambda: ccitt_tiff(np.tile(np.arange(3000) % 700 < 350, (3, 1)), "group4"),
    # LZMA, BigTIFF, fill order 2
    "tiff_lzma_rgb": lambda: pillow(Image.fromarray(RGB), "TIFF", compression="lzma"),
    "tiff_bigtiff_le": lambda: pillow(Image.fromarray(RGB), "TIFF", big_tiff=True),
    "tiff_bigtiff_pillow_deflate": lambda: pillow(Image.fromarray(RGB), "TIFF", big_tiff=True,
                                                  compression="tiff_deflate"),
    "tiff_fill2_gray8_raw": lambda: sample_tiff(GRAY[..., None], 8, 1, fill=2),
    "tiff_fill2_gray8_lzw": lambda: sample_tiff(GRAY[..., None], 8, 1, fill=2, code=5),
    "tiff_fill2_gray4_deflate": lambda: sample_tiff(GRAY[..., None] >> 4, 4, 0, fill=2, code=8),
    "tiff_fill2_bilevel": lambda: sample_tiff(_BW[..., None].astype(np.uint8), 1, 1, fill=2),
    "tiff_fill2_rgb_lzw": lambda: sample_tiff(RGB, 8, 2, fill=2, code=5),
    "tiff_fill2_palette4_deflate": lambda: sample_tiff(GRAY[..., None] >> 4, 4, 3, fill=2, code=8,
                                                       more={320: (3, _RNG.integers(0, 65536, 48).tolist())}),
    "tiff_bigtiff_le_lzw_tiles": lambda: sample_tiff(RGB, 8, 2, code=5, big=True, tile=(16, 16)),
    # sample formats
    "tiff_float32": lambda: sample_tiff(_F32[..., None], 32, 1, fmt=3),
    "tiff_float32_white_is_zero_lzw": lambda: sample_tiff(_F32[..., None], 32, 0, fmt=3, code=5),
    "tiff_float32_be_deflate": lambda: sample_tiff(_F32[..., None], 32, 1, fmt=3, code=8, order=">"),
    "tiff_float32_be_raw": lambda: sample_tiff(_F32[..., None], 32, 1, fmt=3, order=">"),
    "tiff_float32_pillow": lambda: pillow(Image.fromarray(_F32), "TIFF"),
    "tiff_signed8": lambda: sample_tiff(_S32[..., None] % 256, 8, 1, fmt=2, code=8),
    "tiff_signed32": lambda: sample_tiff(_S32[..., None], 32, 1, fmt=2, code=8),
    "tiff_signed32_be": lambda: sample_tiff(_S32[..., None] * 70001, 32, 1, fmt=2, order=">"),
    "tiff_signed32_be_deflate": lambda: sample_tiff(_S32[..., None], 32, 1, fmt=2, code=8, order=">"),
    "tiff_signed32_pillow": lambda: pillow(Image.fromarray(_S32.astype(np.int32)), "TIFF", compression="tiff_lzw"),
    "tiff_unsigned32": lambda: sample_tiff(_U32[..., None], 32, 1),
    "tiff_unsigned32_lzma": lambda: sample_tiff(_U32[..., None], 32, 1, code=34925),
    # CMYK
    "tiff_cmyk8": lambda: pillow(Image.fromarray(_CMYK, "CMYK"), "TIFF"),
    "tiff_cmyk8_lzw": lambda: pillow(Image.fromarray(_CMYK, "CMYK"), "TIFF", compression="tiff_lzw"),
    "tiff_cmyk8_extra": lambda: sample_tiff(np.dstack([_CMYK, _CMYK[..., :1]]), 8, 5, extra=(0,), code=8),
    "tiff_cmyk8_two_extra_be": lambda: sample_tiff(np.dstack([_CMYK, _CMYK[..., :2]]), 8, 5, extra=(0, 0), order=">"),
    "tiff_cmyk16": lambda: sample_tiff(_CMYK16, 16, 5),
    "tiff_cmyk16_be_deflate": lambda: sample_tiff(_CMYK16, 16, 5, code=8, order=">"),
    # CIELab through Pillow's LittleCMS transform
    "tiff_cielab_pillow": lambda: pillow(Image.fromarray(RGB, "LAB"), "TIFF"),
    "tiff_cielab_deflate": lambda: sample_tiff(_RNG.integers(0, 256, (64, 64, 3)), 8, 8, code=8),
    "tiff_cielab_be_lzw_tiles": lambda: sample_tiff(pixels(20, 35, 8), 8, 8, code=5, order=">", tile=(16, 16)),
    "tiff_cielab_from_rgb": lambda: pillow(Image.fromarray(RGB).convert("LAB"), "TIFF", compression="tiff_lzw"),
    # YCbCr through libtiff's RGBA read
    "tiff_ycbcr_11_deflate": lambda: ycbcr_tiff(RGB, (1, 1), 8),
    "tiff_ycbcr_21_lzw": lambda: ycbcr_tiff(RGB, (2, 1), 5, rows_per_strip=5),
    "tiff_ycbcr_22_deflate": lambda: ycbcr_tiff(RGB, (2, 2), 8, rows_per_strip=6),
    "tiff_ycbcr_42_lzw_be": lambda: ycbcr_tiff(RGB, (4, 2), 5, order=">"),
    "tiff_ycbcr_22_reference_black_white": lambda: ycbcr_tiff(
        RGB, (2, 2), 8, more={532: (5, [15, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
    "tiff_ycbcr_default_subsampling_coefficients": lambda: ycbcr_tiff(
        RGB[:16, :32], (2, 2), 8, more={529: (5, [2126, 10000, 7152, 10000, 722, 10000])}),
}
# orientation 1-8 on raw, LZW and JPEG strips (Pillow applies tag 274 in its load)
for _o in range(1, 9):
    READ_CASES[f"tiff_orientation{_o}_raw"] = (lambda o: lambda: pillow(Image.fromarray(RGB), "TIFF",
                                                                        tiffinfo={274: o}))(_o)
    READ_CASES[f"tiff_orientation{_o}_lzw"] = (lambda o: lambda: pillow(Image.fromarray(RGB), "TIFF", tiffinfo={274: o},
                                                                        compression="tiff_lzw"))(_o)
    READ_CASES[f"tiff_orientation{_o}_jpeg"] = (lambda o: lambda: jpeg_tiff(RGB, 6, rows_per_strip=8,
                                                                            orientation=o))(_o)
READ_CASES["tiff_orientation6_ycbcr"] = lambda: ycbcr_tiff(RGB, (2, 2), 8, more={274: (3, [6])})
READ_CASES["tiff_orientation3_bigtiff_ccitt"] = lambda: sample_tiff(_BW[..., None].astype(np.uint8), 1, 0,
                                                                    big=True, orientation=3)


def _case_file(tmp_path, case) -> str:
    path = tmp_path / f"{case}.img"
    path.write_bytes(READ_CASES[case]())
    return str(path)


@pytest.mark.parametrize("case", list(READ_CASES))
def test_load_matches_jax(tmp_path, case):
    """``envmap.load_image``: the decode and linearization bit for bit as
    the JAX package's Pillow loader, shape included."""
    path = _case_file(tmp_path, case)
    got, want = tenv.load_image(path), jenv.load_image(path)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["tiff_gray16_lzma_predictor", "tiff_signed16", "tiff_signed16_be_lzw"])
def test_sixteen_bit_gray_diverges(tmp_path, case):
    """16-bit gray, unsigned or signed: Pillow's mode ``I;16`` / ``I``
    value clips to 0..255 in ``convert("RGB")``; the port keeps the high
    byte of the value, negatives at 0 (``ROADMAP.md``, known faults of the
    reference). Both rules asserted."""
    data = {"tiff_gray16_lzma_predictor": lambda: sample_tiff(_RNG.integers(0, 256, (9, 13, 1)) * 257, 16, 1,
                                                             code=34925, predictor=2),
            "tiff_signed16": lambda: sample_tiff(_S16[..., None], 16, 1, fmt=2),
            "tiff_signed16_be_lzw": lambda: sample_tiff(_S16[..., None], 16, 1, fmt=2, code=5, order=">")}[case]()
    path = tmp_path / f"{case}.img"
    path.write_bytes(data)
    im = Image.open(path)
    value = np.asarray(im).astype(np.int64)  # the value Pillow holds
    assert im.mode in ("I;16", "I")
    want_pillow = np.clip(value, 0, 255)
    np.testing.assert_array_equal(np.asarray(im.convert("RGB"))[..., 0], want_pillow)
    if case == "tiff_signed16_be_lzw":  # Pillow's value: libtiff's little-endian bytes read big-endian
        true = _S16.astype(">i2").view("<i2").astype(np.int64)
        np.testing.assert_array_equal(value, true)
    got = imageio.decode_image(data, str(path))
    np.testing.assert_array_equal(got, np.repeat((np.maximum(value, 0) >> 8)[..., None], 3, axis=2))
    assert (np.maximum(value, 0) >> 8 != want_pillow).any()


# what still raises, in the port and (where marked) in Pillow too
STILL_RAISE = {
    "jpeg_lossless_arithmetic_sof11": (lambda: _ll([GRAY]).replace(b"\xff\xc3", b"\xff\xcb", 1), "SOF11", True),
    "jpeg_lossless_jfif_ycbcr": (lambda: _ll(_PLANES, marker="jfif"), "lossless JPEG in YCbCr", True),
    "jpeg_lossless_adobe_ycbcr": (lambda: _ll(_PLANES, marker="adobe1"), "lossless JPEG in YCbCr", True),
    "jpeg_lossless_12_bit": (lambda: _ll([GRAY]).replace(b"\xff\xc3\x00\x0b\x08", b"\xff\xc3\x00\x0b\x0c", 1),
                             "12-bit", True),
    "jpeg_hierarchical_sof7": (lambda: _ll([GRAY]).replace(b"\xff\xc3", b"\xff\xc7", 1), "hierarchical", True),
    "jpeg_hierarchical_sof13": (lambda: arith_jpeg(_jpeg(GRAY)).replace(b"\xff\xc9", b"\xff\xcd", 1),
                                "hierarchical", True),
    "tiff_bigtiff_big_endian": (lambda: sample_tiff(RGB, 8, 2, order=">", big=True), "big-endian BigTIFF", True),
    "tiff_ycbcr_uncompressed": (lambda: ycbcr_tiff(RGB, (2, 2), 1), "uncompressed YCbCr", True),
    "tiff_fill2_palette4_raw": (lambda: sample_tiff(GRAY[..., None] >> 4, 4, 3, fill=2,
                                                    more={320: (3, list(range(48)))}), "fill order 2", True),
    "tiff_float_rgb": (lambda: sample_tiff(RGB.astype(np.float32), 32, 2, fmt=3), "floating-point", True),
    "tiff_unsigned32_be": (lambda: sample_tiff(_U32[..., None], 32, 1, order=">"), "32 bits", True),
    "tiff_zstd": (lambda: pillow(Image.fromarray(RGB), "TIFF", compression="zstd"), "Zstandard", False),
    "tiff_old_jpeg": (lambda: sample_tiff(RGB, 8, 6, code=6), "old-style JPEG", True),
    "tiff_logl": (lambda: sample_tiff(GRAY[..., None], 8, 32844), "LogL", True),
}


@pytest.mark.parametrize("case", list(STILL_RAISE))
def test_still_unsupported_raise(tmp_path, case):
    """What the port does not read raises ``ValueError`` naming the file and
    what it lacks; where Pillow raises on the file too, that is asserted
    (Zstandard Pillow reads: ``ROADMAP.md`` queues it)."""
    make, what, pillow_raises = STILL_RAISE[case]
    path = tmp_path / f"{case}.img"
    path.write_bytes(make())
    with pytest.raises(ValueError, match=what) as err:
        tenv.load_image(path)
    assert str(path) in str(err.value)
    if pillow_raises:
        with pytest.raises(Exception):
            Image.open(path).convert("RGB")
    else:
        assert Image.open(path).convert("RGB").size == (RGB.shape[1], RGB.shape[0])


# --- native against the Python twins ---


def _scan_args(data: bytes):
    """The arguments of each scan decode of a JPEG file, as `imageio` makes
    them (recorded through its dispatch)."""
    calls = []
    saved = (imageio._arith_scan, imageio._lossless_scan)
    imageio._arith_scan = lambda *a: calls.append(("arith", a)) or jpeg_arith.decode_scan_py(*a)
    imageio._lossless_scan = lambda *a: calls.append(("lossless", a)) or jpeg_lossless.decode_scan_py(*a)
    try:
        imageio._read_jpeg(data, "x")
    except ValueError:  # a corrupt header after some scans: those scans are compared
        pass
    finally:
        imageio._arith_scan, imageio._lossless_scan = saved
    return calls


def _copy(a):
    return [x.copy() if isinstance(x, np.ndarray) else ([y.copy() for y in x] if isinstance(x, list) and x
                                                        and isinstance(x[0], np.ndarray) else x) for x in a]


def _native_jpeg_cases():
    rng = np.random.default_rng(31)

    def corrupt(d, k=4):  # scan bytes changed, no marker made or broken
        b = bytearray(d)
        for j in rng.integers(len(b) // 2, len(b) - 2, k):
            if b[j] != 0xFF and b[j - 1] != 0xFF:
                b[j] = rng.integers(0, 255)
        return bytes(b)

    big = pixels(40, 70, 9)
    return {
        "arith_sequential": arith_jpeg(_jpeg(big), restart=5, dac=(1, 4, 9)),
        "arith_progressive": arith_jpeg(_jpeg(big, subsampling=0), progressive=True),
        "arith_progressive_corrupt": corrupt(arith_jpeg(_jpeg(big), progressive=True), 12),
        "arith_cut": arith_jpeg(_jpeg(big))[:300] + b"\xff\xd9",
        "lossless_interleaved": _ll([big[..., i] for i in range(3)], predictor=7, restart_rows=4, ids=[82, 71, 66]),
        "lossless_sampled": _ll([big[..., 0], big[:, ::2, 1], big[:, ::2, 2]], factors=[(2, 1), (1, 1), (1, 1)],
                                predictor=5, pt=1),
        "lossless_v2_restart": _ll([big[..., 1]], factors=[(1, 2)], predictor=4, restart_rows=3),
    }


@pytest.mark.parametrize("case", ["arith_sequential", "arith_progressive", "arith_progressive_corrupt", "arith_cut",
                                  "lossless_interleaved", "lossless_sampled", "lossless_v2_restart"])
def test_native_scan_matches_python(case):
    """The native arithmetic and lossless scan loops against their Python
    twins: every scan of the file, the same coefficients or samples and
    return code (corrupt and cut-off data included)."""
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    calls = _scan_args(_native_jpeg_cases()[case])
    assert calls
    for kind, args in calls:
        a, b = _copy(args), _copy(args)
        if kind == "arith":
            rc_py, rc_nat = jpeg_arith.decode_scan_py(*a), native.jpeg_arith_decode_scan(*b, jpeg_arith.QE)
        else:
            rc_py, rc_nat = jpeg_lossless.decode_scan_py(*a), native.jpeg_lossless_decode_scan(*b)
        assert rc_py == rc_nat
        for x, y in zip(a[2], b[2]):  # the coefficient arrays or sample planes
            np.testing.assert_array_equal(x, y)


def _ccitt_strip(bw, compression, t4=None):
    d = pillow(Image.fromarray(bw), "TIFF", compression=compression, tiffinfo={292: t4} if t4 is not None else {})
    t = Image.open(io.BytesIO(d)).tag_v2
    return d[t[273][0]:t[273][0] + t[279][0]]


@pytest.mark.parametrize("case", ["rle", "g3_1d", "g3_2d", "g4", "g4_wide", "g4_cut", "g3_corrupt", "g4_corrupt"])
def test_native_ccitt_matches_python(case):
    """The native CCITT row decode against its Python twin: the same rows
    and return code, on Pillow's strips and on cut and corrupted ones."""
    if native._load() is None:
        pytest.skip("no g++: the native library is not built")
    rng = np.random.default_rng(len(case))
    bw = bilevel(40, 77, 5)
    strip, code, opts = {
        "rle": lambda: (_ccitt_strip(bw, "tiff_ccitt"), 2, 0),
        "g3_1d": lambda: (_ccitt_strip(bw, "group3"), 3, 0),
        "g3_2d": lambda: (_ccitt_strip(bw, "group3", 5), 3, 5),
        "g4": lambda: (_ccitt_strip(bw, "group4"), 4, 0),
        "g4_wide": lambda: (_ccitt_strip(np.tile(np.arange(3000) % 1900 < 1850, (3, 1)), "group4"), 4, 0),
        "g4_cut": lambda: (_ccitt_strip(bw, "group4")[:150], 4, 0),
        "g3_corrupt": lambda: (bytes(b ^ (rng.integers(0, 256) if i % 17 == 5 else 0)
                                     for i, b in enumerate(_ccitt_strip(bw, "group3", 1))), 3, 1),
        "g4_corrupt": lambda: (bytes(b ^ (rng.integers(0, 256) if i % 23 == 7 else 0)
                                     for i, b in enumerate(_ccitt_strip(bw, "group4"))), 4, 0),
    }[case]()
    width = 3000 if case == "g4_wide" else 77
    rows = 3 if case == "g4_wide" else 40
    want = ccitt.decode_py(strip, width, rows, code, opts)
    got = native.ccitt_decode(strip, width, rows, code, opts, ccitt.WHITE_LUT, ccitt.BLACK_LUT)
    assert got == want
    if case in ("rle", "g3_1d", "g3_2d", "g4", "g4_wide"):
        src = np.tile(np.arange(3000) % 1900 < 1850, (3, 1)) if case == "g4_wide" else bw
        assert want[1] == 0
        bits = np.unpackbits(np.frombuffer(want[0], np.uint8).reshape(rows, -1), axis=1)[:, :width]
        np.testing.assert_array_equal(bits, src.astype(np.uint8))  # Pillow's "1" pixels as black-run bits


@pytest.mark.parametrize("family", ["jpeg_arith", "jpeg_lossless", "tiff_jpeg", "tiff_ccitt", "tiff_other"])
@pytest.mark.parametrize("impl", ["native", "python"])
def test_corrupt_files_raise_value_error(monkeypatch, family, impl):
    """Files with random bytes overwritten or cut short decode to an image
    or raise ``ValueError`` naming the file: no other exception, and no
    read outside the native loops' buffers."""
    if impl == "native" and native._load() is None:
        pytest.skip("no g++: the native library is not built")
    monkeypatch.setattr(native, "available", (lambda: True) if impl == "native" else (lambda: False))
    small = RGB[:11, :19]
    files = {
        "jpeg_arith": [arith_jpeg(_jpeg(small), restart=1), arith_jpeg(_jpeg(small, subsampling=0), progressive=True)],
        "jpeg_lossless": [_ll([small[..., i] for i in range(3)], predictor=6, restart_rows=2),
                          _ll([small[..., 0], small[:, ::2, 1], small[:, ::2, 2]], factors=[(2, 1), (1, 1), (1, 1)])],
        "tiff_jpeg": [pillow(Image.fromarray(small), "TIFF", compression="jpeg"), jpeg_tiff(small, 6, tile=(16, 16))],
        "tiff_ccitt": [ccitt_tiff(_BW[:9], "group4"), ccitt_tiff(_BW[:9], "group3", t4=1), ccitt_tiff(_BW[:9], "tiff_ccitt")],
        "tiff_other": [ycbcr_tiff(small, (2, 2), 8), sample_tiff(_F32[..., None], 32, 1, fmt=3, code=5),
                       pillow(Image.fromarray(small), "TIFF", compression="lzma", big_tiff=True),
                       sample_tiff(_CMYK16, 16, 5, code=8, orientation=6), sample_tiff(small, 8, 8, code=5)],
    }[family]
    rng = np.random.default_rng(len(family) + len(impl))
    for i in range(40):
        data = bytearray(files[i % len(files)])
        for j in rng.integers(0, len(data), rng.integers(1, 5)):
            data[j] = rng.integers(0, 256)
        if i % 5 == 0:
            data = data[:rng.integers(2, len(data))]
        try:
            out = imageio.decode_image(bytes(data), "corrupt")
        except ValueError as err:
            assert "corrupt" in str(err)
        else:
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3


# --- the committed assets and the lossless-sky scene ---

DIGESTS = "assets/variant_digests.json"
# a 4x4 ordered-dither threshold map, 0..255
BAYER = (np.array([[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]]) * 16 + 8).astype(np.uint8)


def asset_files() -> dict:
    """``{repo path: bytes}`` of the variant assets, made from
    ``assets/sky.jpg`` and ``assets/sky.png`` (512x256)."""
    sky = np.asarray(Image.open(os.path.join(REPO, "assets", "sky.png")).convert("RGB"))
    crop = sky[64:192, 128:384]  # 256x128
    luma = imageio._rgb_to_ycc(sky)[0]
    src = open(os.path.join(REPO, "assets", "sky.jpg"), "rb").read()
    flt = (crop[:48, :64, 0].astype(np.float32) * 1.37 - 40.25)[..., None]
    return {
        "assets/sky_arith.jpg": arith_jpeg(src, progressive=True),
        "assets/sky_lossless.jpg": lossless_jpeg([sky[..., i] for i in range(3)], predictor=1, ids=[82, 71, 66],
                                                 optimal=True),
        "assets/variant_jpeg.tif": pillow(Image.fromarray(sky), "TIFF", compression="jpeg", quality=60),
        "assets/variant_ccitt_g4.tif": pillow(Image.fromarray(luma[64:192, 128:384] > np.tile(BAYER, (32, 64))), "TIFF",
                                              compression="group4"),
        "assets/variant_lzma.tif": pillow(Image.fromarray(crop), "TIFF", compression="lzma", tiffinfo={317: 2}),
        "assets/variant_cmyk.tif": pillow(Image.fromarray(crop).convert("CMYK"), "TIFF", compression="tiff_lzw"),
        "assets/variant_float.tif": sample_tiff(flt, 32, 1, fmt=3, code=8),
        "assets/variant_ycbcr.tif": ycbcr_tiff(crop, (2, 2), 8, rows_per_strip=32),
        "assets/variant_cielab.tif": pillow(Image.fromarray(crop).convert("LAB"), "TIFF", compression="tiff_deflate"),
        "assets/variant_bigtiff.tif": pillow(Image.fromarray(crop), "TIFF", big_tiff=True, compression="tiff_deflate"),
        "assets/variant_orientation6.tif": pillow(Image.fromarray(crop), "TIFF", compression="tiff_lzw",
                                                  tiffinfo={274: 6, 317: 2}),
    }


def write_assets() -> None:
    """Write the assets and their digests (Pillow's decode of each)."""
    digests = {}
    for rel, data in asset_files().items():
        with open(os.path.join(REPO, rel), "wb") as f:
            f.write(data)
        rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        digests[rel] = {"shape": list(rgb.shape), "bytes": len(data),
                        "sha256": hashlib.sha256(rgb.tobytes()).hexdigest()}
    with open(os.path.join(REPO, DIGESTS), "w") as f:
        f.write(json.dumps(digests, indent=1) + "\n")


def test_variant_digests_match_pillow(monkeypatch):
    """``assets/variant_digests.json`` holds the SHA-256 of Pillow's
    ``convert("RGB")`` bytes of each committed variant file (the card's
    machine, without Pillow, holds the port to them); the port's decode
    matches; the lossless sky is under 64 KB (one bit a sample at least),
    every other file under 20 KB."""
    monkeypatch.chdir(REPO)
    digests = json.loads(open(DIGESTS).read())
    assert len(digests) == 11
    for path, d in digests.items():
        data = open(path, "rb").read()
        assert len(data) == d["bytes"] < (64_000 if path == "assets/sky_lossless.jpg" else 20_000)
        want = np.asarray(Image.open(path).convert("RGB"))
        assert list(want.shape) == d["shape"]
        assert hashlib.sha256(want.tobytes()).hexdigest() == d["sha256"]
        got = imageio.decode_image(data, path)
        assert hashlib.sha256(got.tobytes()).hexdigest() == d["sha256"], path


@pytest.mark.parametrize("impl", ["native", "python"])
def test_sky_variants_equal_their_sources(monkeypatch, impl):
    """``sky_arith.jpg`` holds ``sky.jpg``'s coefficients, so it decodes to
    the same pixels; ``sky_lossless.jpg`` decodes to ``sky.png``'s: through
    the native loops and through the Python twins."""
    if impl == "native" and native._load() is None:
        pytest.skip("no g++: the native library is not built")
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(native, "available", (lambda: True) if impl == "native" else (lambda: False))
    read = lambda p: imageio.decode_image(open(p, "rb").read(), p)  # noqa: E731
    np.testing.assert_array_equal(read("assets/sky_arith.jpg"), read("assets/sky.jpg"))
    np.testing.assert_array_equal(read("assets/sky_lossless.jpg"), read("assets/sky.png"))


def test_lossless_sky_scene_tables(monkeypatch):
    """``assets/asset_scene_ljpeg.json`` (``asset_scene.json`` under the
    lossless JPEG copy of ``sky.png``): host tables equal to the JAX
    package's load of it and to the port's PNG-sky scene, sky included
    (both packages on their NumPy builders, as ``tests/torch_builders.py``
    explains)."""
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    scene = os.path.join("assets", "asset_scene_ljpeg.json")
    tsh = tconfig.load_scene_json(scene)
    assert tsh.num_world_tris == 13832 and tsh.env.shape == (256, 512, 3)
    _assert_scenes_equal(jconfig.load_scene_json(scene), tsh)
    png = tconfig.load_scene_json(os.path.join("assets", "asset_scene.json"))
    _assert_scenes_equal(png, tsh)


if __name__ == "__main__":
    write_assets()
    for rel, d in json.loads(open(os.path.join(REPO, DIGESTS)).read()).items():
        print(rel, d["shape"], d["bytes"])
