"""Lossless JPEG (ITU-T T.81 Annex H), as libjpeg-turbo 3 decodes it
(``jdlhuff.c``, ``jddiffct.c``, ``jdpred.c``, ``jdlossls.c``), for the
files Pillow opens: SOF3, 8-bit samples, Huffman-coded differences.

`decode_scan_py` decodes one scan's differences and undoes the prediction
into the components' 8-bit sample planes. It is the Python twin of
``native.jpeg_lossless_decode_scan``:

* each difference is a Huffman-coded magnitude category SSSS (0 to 16)
  and SSSS extra bits; category 16 is the difference 32768, with none;
* predictors 1 to 7 (Table H.1) on the point-transformed values, modulo
  2^16: the first row of a scan or restart interval predicts its first
  sample from 2^(P - Pt - 1) and the rest from the left (Ra); the first
  sample of every other row from above (Rb);
* libjpeg undoes the prediction an iMCU row at a time, after decoding its
  MCU rows, so a restart inside an iMCU row (a non-interleaved component
  sampled more than once vertically) resets prediction at the iMCU row's
  first row, as here;
* the samples are scaled back by ``<< Pt`` to 8 bits.
"""

from __future__ import annotations

import numpy as np


def reset_rows(n_mcu_rows: int, rows_per_mcu: int, rows_per_imcu: int, restart_rows: int) -> set:
    """The sample rows of a component where prediction starts afresh: the
    first row of each iMCU row in which the scan starts or a restart
    interval begins."""
    starts = range(0, n_mcu_rows, restart_rows) if restart_rows else (0,)
    return {(k * rows_per_mcu // rows_per_imcu) * rows_per_imcu for k in starts}


def undifference(diff: np.ndarray, out: np.ndarray, resets, predictor: int, pt: int) -> None:
    """Undo the prediction of one component: ``diff [rows, cols]`` the
    decoded differences (at least ``out``'s size), ``out [h, w]`` uint8 the
    samples, written in place."""
    h, w = out.shape
    seed = 1 << (8 - pt - 1)
    prev = [0] * w
    d = diff.tolist()
    for y in range(h):
        row, dr = [0] * w, d[y]
        if y in resets:
            ra = (dr[0] + seed) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                ra = (dr[x] + ra) & 0xFFFF
                row[x] = ra
        else:
            rb = prev[0]
            ra = (dr[0] + rb) & 0xFFFF
            row[0] = ra
            for x in range(1, w):
                rc, rb = rb, prev[x]
                if predictor == 1:
                    p = ra
                elif predictor == 2:
                    p = rb
                elif predictor == 3:
                    p = rc
                elif predictor == 4:
                    p = ra + rb - rc
                elif predictor == 5:
                    p = ra + ((rb - rc) >> 1)
                elif predictor == 6:
                    p = rb + ((ra - rc) >> 1)
                else:
                    p = (ra + rb) >> 1
                ra = (dr[x] + p) & 0xFFFF
                row[x] = ra
        out[y] = (np.asarray(row, np.int64) << pt) & 0xFF
        prev = row


def decode_scan_py(data: bytes, starts, planes, geom, luts, rows_per_imcu, mcus_x, mcus_y,
                   predictor, pt, restart) -> int:
    """Decode one lossless scan into ``planes`` (uint8 ``[h, w]`` each, the
    scan's components in scan order), in place.

    ``data``: the scan's bytes with the stuffing removed, restart interval
    i at ``data[starts[i]:starts[i+1]]`` and 1024 zero bytes after the
    last; ``geom[c] = (h, v)`` the component's samples per MCU (1, 1 in a
    non-interleaved scan), ``luts[c]`` its table as a 16-bit lookahead
    (`imageio._decode_lut`), ``rows_per_imcu[c]`` its vertical sampling
    factor; ``restart`` in MCUs, a multiple of ``mcus_x``. Returns 0, -1
    for a bad Huffman code, -2 for data that ends early, -3 when the
    restart intervals do not match."""
    b = np.frombuffer(data, np.uint8).astype(np.uint32)
    w32 = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
    tabs = [t.tolist() for t in luts]
    n_mcu = mcus_x * mcus_y
    interval = restart or n_mcu
    if len(starts) - 1 != -(-n_mcu // interval):
        return -3
    diffs = [[] for _ in geom]  # rows, added an MCU row at a time (data that ends early allocates little)
    units = [(ci, y, x) for ci, (h, v) in enumerate(geom) for y in range(v) for x in range(h)]
    for it in range(len(starts) - 1):
        pos, end = starts[it] * 8, starts[it + 1] * 8
        for m in range(it * interval, min(n_mcu, (it + 1) * interval)):
            my, mx = divmod(m, mcus_x)
            if mx == 0:
                for (h, v), rows in zip(geom, diffs):
                    rows += [[0] * (mcus_x * h) for _ in range(v)]
            for ci, y, x in units:
                e = tabs[ci][(w32[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                if not e:
                    return -1
                pos += e >> 8
                s = e & 255
                if s == 16:
                    d = 32768
                elif s:
                    if s > 16:
                        return -1
                    d = ((w32[pos >> 3] << (pos & 7)) & 0xFFFFFFFF) >> (32 - s)
                    pos += s
                    if d < (1 << (s - 1)):
                        d -= (1 << s) - 1
                else:
                    d = 0
                h, v = geom[ci]
                diffs[ci][my * v + y][mx * h + x] = d
            if pos > end:
                return -2
    for ci, (h, v) in enumerate(geom):
        resets = reset_rows(mcus_y, v, rows_per_imcu[ci], interval // mcus_x if restart else 0)
        undifference(np.asarray(diffs[ci], np.int64), planes[ci], resets, predictor, pt)
    return 0
