"""JPEG's arithmetic decoder (ITU-T T.81 Annex D, F.1.4 and G.1.3), as
libjpeg-turbo's ``jdarith.c`` runs it, for the DCT files Pillow opens:
sequential (SOF9) and progressive (SOF10) scans.

`decode_scan_py` fills the same int16 coefficient arrays `imageio`'s
Huffman loop fills, so the dequantization, inverse DCT, upsampling and
colour stages after it are shared. It is the Python twin of
``native.jpeg_arith_decode_scan``:

* the 113-state probability estimator of Table D.2 (`QE`), and the fixed
  state 113 for the sign bits of AC coefficients and the refinement bits
  of DC;
* statistics bins per table (as ``jdarith.c``: components that share a
  table share its bins), DC conditioned on (L, U) and AC on Kx from the DAC
  segment (defaults 0, 1 and 5);
* a restart marker resets the statistics, the DC predictions and the
  decoder; past the end of an interval's data the decoder reads zero
  bytes, as libjpeg does at a marker;
* a bad code (a magnitude or a run past the block) stops the interval's
  decode and keeps what it decoded, as libjpeg warns and goes on.
"""

from __future__ import annotations

import numpy as np

# Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
# Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed estimate.
_D2 = (
    (23069, 1, 1, 1), (9606, 2, 14, 0), (4372, 3, 16, 0), (2059, 4, 18, 0), (984, 5, 20, 0),
    (474, 6, 23, 0), (229, 7, 25, 0), (111, 8, 28, 0), (54, 9, 30, 0), (26, 10, 33, 0), (13, 11, 35, 0),
    (6, 12, 9, 0), (3, 13, 10, 0), (1, 13, 12, 0), (23167, 15, 15, 1), (16165, 16, 36, 0),
    (11506, 17, 38, 0), (8316, 18, 39, 0), (6073, 19, 40, 0), (4482, 20, 42, 0), (3311, 21, 43, 0),
    (2465, 22, 45, 0), (1839, 23, 46, 0), (1372, 24, 48, 0), (1030, 25, 49, 0), (771, 26, 51, 0),
    (576, 27, 52, 0), (433, 28, 54, 0), (324, 29, 56, 0), (245, 30, 57, 0), (183, 31, 59, 0),
    (138, 32, 60, 0), (104, 33, 62, 0), (78, 34, 63, 0), (59, 35, 32, 0), (44, 9, 33, 0),
    (23265, 37, 37, 1), (18508, 38, 64, 0), (14861, 39, 65, 0), (12017, 40, 67, 0), (9759, 41, 68, 0),
    (7987, 42, 69, 0), (6568, 43, 70, 0), (5400, 44, 72, 0), (4471, 45, 73, 0), (3700, 46, 74, 0),
    (3067, 47, 75, 0), (2552, 48, 77, 0), (2145, 49, 78, 0), (1798, 50, 79, 0), (1485, 51, 48, 0),
    (1246, 52, 50, 0), (1039, 53, 50, 0), (867, 54, 51, 0), (724, 55, 52, 0), (604, 56, 53, 0),
    (504, 57, 54, 0), (420, 58, 55, 0), (352, 59, 56, 0), (293, 60, 57, 0), (246, 61, 58, 0),
    (203, 62, 59, 0), (171, 63, 61, 0), (143, 32, 61, 0), (23314, 65, 65, 1), (19716, 66, 80, 0),
    (16684, 67, 81, 0), (14296, 68, 82, 0), (12264, 69, 83, 0), (10556, 70, 84, 0), (9081, 71, 86, 0),
    (7903, 72, 87, 0), (6825, 73, 87, 0), (5966, 74, 72, 0), (5156, 75, 72, 0), (4508, 76, 74, 0),
    (3947, 77, 74, 0), (3409, 78, 75, 0), (2998, 79, 77, 0), (2624, 48, 77, 0), (22578, 81, 80, 1),
    (19740, 82, 88, 0), (17294, 83, 89, 0), (15325, 84, 90, 0), (13550, 85, 91, 0), (11950, 86, 92, 0),
    (10650, 87, 93, 0), (9494, 71, 86, 0), (21872, 89, 88, 1), (19625, 90, 95, 0), (17625, 91, 96, 0),
    (15906, 92, 97, 0), (14372, 93, 99, 0), (12980, 94, 99, 0), (11799, 86, 93, 0), (22184, 96, 95, 1),
    (20294, 97, 101, 0), (18405, 98, 102, 0), (16847, 99, 103, 0), (15421, 100, 104, 0),
    (14174, 93, 99, 0), (21041, 102, 105, 0), (19471, 103, 106, 0), (17977, 104, 107, 0),
    (16734, 99, 103, 0), (22055, 106, 105, 1), (20711, 107, 108, 0), (19333, 103, 109, 0),
    (21911, 109, 110, 0), (20559, 107, 111, 0), (23056, 111, 110, 1), (21794, 109, 112, 0),
    (23019, 111, 112, 1), (23069, 113, 113, 0),
)  # (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS)
QE = np.array([qe << 16 | nm << 8 | sw << 7 | nl for qe, nm, nl, sw in _D2], np.int64)
FIXED = 113  # the fixed-probability state
DC_BINS, AC_BINS, TABLES = 64, 256, 16


def decode_scan_py(data: bytes, starts, coefs, geom, tables, cond, mcus_x, mcus_y,
                   ss, se, ah, al, restart, natural) -> int:
    """Arithmetic-decode one scan into the coefficient arrays, in place.

    ``data``: the scan's bytes with the stuffing removed, restart interval i
    at ``data[starts[i]:starts[i+1]]``; ``coefs[c]`` the int16 ``[rows,
    cols, 64]`` blocks (natural order) of the scan's c-th component,
    ``geom[c] = (h, v)`` its blocks per MCU, ``tables[c] = (dc, ac)`` its
    statistics tables, ``cond = (L, U, K)`` the DAC conditioning (16 each);
    ``natural`` the natural index of each zigzag position (with guards).
    Sequential scans have ``ss, se, ah, al = 0, 63, 0, 0`` and a sequential
    ``restart``; otherwise a progressive scan. Returns 0, or -3 when the
    restart intervals do not match."""
    qe_tab = QE.tolist()
    dl, du, kx = ([int(x) for x in t] for t in cond)
    nat = [int(x) for x in natural]
    lists = [c.reshape(-1).tolist() for c in coefs]
    n_mcu = mcus_x * mcus_y
    interval = restart or n_mcu
    if len(starts) - 1 != -(-n_mcu // interval):
        return -3
    blocks = []
    for ci, (h, v) in enumerate(geom):
        cols = coefs[ci].shape[1]
        blocks += [(ci, (y * cols + x) * 64) for y in range(v) for x in range(h)]
    strides = [(v * coefs[ci].shape[1] * 64, h * 64) for ci, (h, v) in enumerate(geom)]
    progressive = (ss, se, ah, al) != (0, 63, 0, 0)
    dc_scan = not progressive or (ss == 0 and ah == 0)
    ac_scan = not progressive or ss > 0
    dc_stats = [[0] * DC_BINS for _ in range(TABLES)]
    ac_stats = [[0] * AC_BINS for _ in range(TABLES)]
    fixed = [FIXED]
    p1, m1 = 1 << al, -1 << al
    st_ = {"a": 0, "c": 0, "ct": -16, "pos": 0, "end": 0}

    def decode(stats, i):  # arith_decode: one decision on stats[i]
        a, c, ct = st_["a"], st_["c"], st_["ct"]
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                p = st_["pos"]
                byte = data[p] if p < st_["end"] else 0
                st_["pos"] = p + 1
                c = (c << 8) | byte
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = stats[i]
        qe = qe_tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        temp = a - qe
        a = temp
        temp <<= ct
        if c >= temp:
            c -= temp
            if a < qe:
                a = qe
                stats[i] = (sv & 0x80) ^ nm
            else:
                a = qe
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
        elif a < 0x8000:
            if a < qe:
                stats[i] = (sv & 0x80) ^ nl
                sv ^= 0x80
            else:
                stats[i] = (sv & 0x80) ^ nm
        st_["a"], st_["c"], st_["ct"] = a, c, ct
        return sv >> 7

    def dc_diff(ci, t, ctx):
        """Figure F.19: one DC difference and its next context."""
        stats = dc_stats[t]
        st = ctx[ci]
        if not decode(stats, st):
            ctx[ci] = 0
            return 0, True
        sign = decode(stats, st + 1)
        st += 2 + sign
        m = decode(stats, st)
        if m:
            st = 20
            while decode(stats, st):
                m <<= 1
                if m == 0x8000:
                    return 0, False
                st += 1
        if m < (1 << dl[t]) >> 1:
            ctx[ci] = 0
        elif m > (1 << du[t]) >> 1:
            ctx[ci] = 12 + sign * 4
        else:
            ctx[ci] = 4 + sign * 4
        v = m
        st += 14
        m >>= 1
        while m:
            if decode(stats, st):
                v |= m
            m >>= 1
        v += 1
        return (-v if sign else v), True

    def ac_run(stats, t, co, base, k, last, scale):
        """Figure F.20 from ``k`` to ``last``; False on a bad code."""
        while k <= last:
            st = 3 * (k - 1)
            if decode(stats, st):
                break  # EOB
            while not decode(stats, st + 1):
                st += 3
                k += 1
                if k > last:
                    return False
            sign = decode(fixed, 0)
            st += 2
            m = decode(stats, st)
            if m:
                if decode(stats, st):
                    m <<= 1
                    st = 189 if k <= kx[t] else 217
                    while decode(stats, st):
                        m <<= 1
                        if m == 0x8000:
                            return False
                        st += 1
            v = m
            st += 14
            m >>= 1
            while m:
                if decode(stats, st):
                    v |= m
                m >>= 1
            v += 1
            co[base + nat[k]] = (-v if sign else v) * scale
            k += 1
        return True

    for it in range(len(starts) - 1):
        st_.update(a=0, c=0, ct=-16, pos=starts[it], end=starts[it + 1])
        pred = [0] * len(coefs)
        ctx = [0] * len(coefs)
        for ci, (t_dc, t_ac) in enumerate(tables):
            if dc_scan:
                dc_stats[t_dc][:] = [0] * DC_BINS
            if ac_scan:
                ac_stats[t_ac][:] = [0] * AC_BINS
        broken = False
        for m in range(it * interval, min(n_mcu, (it + 1) * interval)):
            if broken:
                break
            my, mx = divmod(m, mcus_x)
            for ci, off in blocks:
                co = lists[ci]
                base = my * strides[ci][0] + mx * strides[ci][1] + off
                t_dc, t_ac = tables[ci]
                if progressive and ss == 0 and ah:  # DC refinement: one bit on the fixed state
                    if decode(fixed, 0):
                        co[base] |= p1
                    continue
                if dc_scan:
                    d, ok = dc_diff(ci, t_dc, ctx)
                    if not ok:
                        broken = True
                        break
                    pred[ci] = (pred[ci] + d) & 0xFFFF
                    val = pred[ci] - 0x10000 if pred[ci] & 0x8000 else pred[ci]
                    co[base] = val << al if progressive else val
                    if progressive:
                        continue
                stats = ac_stats[t_ac]
                if not ah:  # sequential, or an AC first stage
                    if not ac_run(stats, t_ac, co, base, 1 if not progressive else ss,
                                  63 if not progressive else se, p1):
                        broken = True
                        break
                    continue
                # AC refinement (G.1.3.3)
                kex = se
                while kex > 0 and not co[base + nat[kex]]:
                    kex -= 1
                k = ss
                while k <= se:
                    st = 3 * (k - 1)
                    if k > kex and decode(stats, st):
                        break
                    while True:
                        j = base + nat[k]
                        if co[j]:
                            if decode(stats, st + 2):
                                co[j] += m1 if co[j] < 0 else p1
                            break
                        if decode(stats, st + 1):
                            co[j] = m1 if decode(fixed, 0) else p1
                            break
                        st += 3
                        k += 1
                        if k > se:
                            broken = True
                            break
                    if broken:
                        break
                    k += 1
                if broken:
                    break
    for c, lst in zip(coefs, lists):
        c[...] = np.asarray(lst, np.int64).astype(np.int16).reshape(c.shape)  # int16 wrap, as JCOEF
    return 0
