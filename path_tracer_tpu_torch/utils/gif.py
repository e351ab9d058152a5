"""GIF, read and written without Pillow, to Pillow's bytes.

* `decode_gif`: frame 0 as ``Image.open(...).convert("RGB")`` shows it:
  GIF87a and GIF89a, the global or the frame's own colour table (a table
  that is the identity gray ramp makes Pillow read the frame as gray
  levels), interlace, and a frame that is smaller than the logical screen
  or overruns it (the screen grows to hold it). Outside the frame the image
  holds index 0, or the transparency index where the frame has one; a
  transparent index converts to its colour, as Pillow converts it. Image
  data that ends before the frame is full raises, as in Pillow.
* `encode_gif`: the file ``Image.fromarray(rgb8, "RGB").save(path)`` writes
  for a ``.gif``: the median-cut quantizer of libImaging's Quant.c
  (Pillow's ``convert("P", palette=ADAPTIVE)``) and its pixel mapping, the
  palette optimisation of ``GifImagePlugin._get_optimize``, interlace for
  images at least 16 pixels on each side, and GifEncode.c's LZW stream at
  an 8-bit code size in 255-byte sub-blocks.

The LZW loops and the quantizer run in `native` (host C++) where g++ built
it, else in the Python twins here (`_lzw_decode_py`, `_lzw_encode_py`,
`_quantize_py`), which give the same output.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from path_tracer_tpu_torch import native

SIGNATURES = (b"GIF87a", b"GIF89a")


# --- LZW, Python twins of native.gif_lzw_decode / gif_lzw_encode ---


def _lzw_decode_py(data: bytes, min_size: int, size: int) -> tuple[np.ndarray, int]:
    """LSB-first codes from ``min_size + 1`` to 12 bits, Clear and End
    codes (GifDecode.c) -> (``size`` indices, the count decoded, or -1 for
    a code past the table, -2 when the data ends before an End code with
    the image unfilled)."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    strings: list[bytes] = [bytes([i]) for i in range(clear)] + [b"", b""]
    out = bytearray()
    width, old = min_size + 1, None
    bits = int.from_bytes(data, "little")
    pos, total = 0, len(data) * 8
    while len(out) < size:
        if pos + width > total:
            return np.frombuffer(bytes(out[:size]).ljust(size, b"\0"), np.uint8), -2
        code = (bits >> pos) & ((1 << width) - 1)
        pos += width
        if code == clear:
            strings, width, old = strings[:clear + 2], min_size + 1, None
            continue
        if code == end:
            break
        if old is None:
            if code > clear:
                return np.zeros(size, np.uint8), -1
            out += strings[code]
            old = code
            continue
        nxt = len(strings)
        if code > nxt or (code == nxt and nxt >= 4096):
            return np.zeros(size, np.uint8), -1
        if nxt < 4096:
            entry = strings[old] + (strings[code][:1] if code < nxt else strings[old][:1])
            strings.append(entry)
            if len(strings) == 1 << width and width < 12:
                width += 1
        out += strings[code]
        old = code
    n = min(len(out), size)
    return np.frombuffer(bytes(out[:size]).ljust(size, b"\0"), np.uint8), n


def _lzw_encode_py(indices: np.ndarray, min_size: int) -> bytes:
    """GifEncode.c's code stream of ``indices``: a Clear first; a Clear and
    a fresh table when the next code would be 4096; the code width grows
    when a code past the width's largest is added; an End code; the last
    byte zero-padded."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    width = min_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    def fresh():
        return {}, end + 1, 2 * clear - 1, min_size + 1

    table, nxt, max_code, width = fresh()
    put(clear)
    seq = np.asarray(indices, np.uint8).reshape(-1).tolist()
    if seq:
        head = seq[0]
        for tail in seq[1:]:
            key = (head, tail)
            if key in table:
                head = table[key]
                continue
            put(head)
            if nxt < 4096:
                table[key] = nxt
                if nxt > max_code:
                    max_code, width = max_code * 2 + 1, width + 1
                nxt += 1
            else:
                put(clear)
                table, nxt, max_code, width = fresh()
            head = tail
        put(head)
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _lzw_decode(data, min_size, size):
    if native.available():
        return native.gif_lzw_decode(data, min_size, size)
    return _lzw_decode_py(data, min_size, size)


def _lzw_encode(indices, min_size):
    if native.available():
        return native.gif_lzw_encode(indices, min_size)
    return _lzw_encode_py(indices, min_size)


# --- the median cut, Python twin of native.median_cut_quantize ---


def _heap_add(heap, count, v):
    """QuantHeap.c's insert: a 1-based max-heap on ``count``."""
    heap.append(v)
    k = len(heap) - 1
    while k != 1 and count[v] > count[heap[k // 2]]:
        heap[k] = heap[k // 2]
        k //= 2
    heap[k] = v


def _heap_remove(heap, count):
    """QuantHeap.c's removal of the top, or None."""
    if len(heap) <= 1:
        return None
    top, v = heap[1], heap.pop()
    n = len(heap) - 1
    if not n:
        return top
    k = 1
    while k * 2 <= n:
        child = k * 2
        if child < n and count[heap[child]] < count[heap[child + 1]]:
            child += 1
        if count[v] > count[heap[child]]:
            break
        heap[k] = heap[child]
        k = child
    heap[k] = v
    return top


def _quantize_py(rgb8: np.ndarray, colors: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``im.quantize(colors)`` of an RGB image (Quant.c, method 0):
    (palette ``[k, 3]`` uint8, indices ``[H, W]`` uint8). See
    ``csrc/pt_native.cpp`` median_cut_quantize for the steps."""
    px = np.asarray(rgb8, np.uint8).reshape(-1, 3).astype(np.int64)
    if not px.size:
        return np.zeros((0, 3), np.uint8), np.zeros(rgb8.shape[:2], np.uint8)
    scale = 0
    while len(np.unique(px >> scale, axis=0)) > 65536:
        scale += 1
    keys, inv, counts = np.unique(px >> scale, axis=0, return_inverse=True, return_counts=True)
    inv = inv.reshape(-1)
    members, count, children = [np.arange(len(keys))], [px.shape[0]], [None]
    volume = [-1]
    heap = [None]
    _heap_add(heap, count, 0)
    for _ in range(colors - 1):
        while True:
            b = _heap_remove(heap, count)
            if b is None:
                break
            if volume[b] < 0:
                k = keys[members[b]]
                volume[b] = int(np.prod(k.max(0) - k.min(0) + 1)) if len(k) else 0
            if volume[b] != 1:
                break
        if b is None:
            break
        k = keys[members[b]]
        lo, hi = k.min(0), k.max(0)
        f = ((hi - lo) * np.array([77, 150, 29])).tolist()
        axis = 0
        for i in (1, 2):
            if f[axis] < f[i]:
                axis = i
        vals = k[:, axis]
        hist = np.bincount(vals, weights=counts[members[b]], minlength=256)
        run = np.cumsum(hist[::-1])[::-1]  # the count at or above each value
        split = max(v for v in range(256) if hist[v] and run[v] * 2 > count[b])
        left = vals >= (split if split > lo[axis] else lo[axis] + 1)
        for side in (left, ~left):
            members.append(members[b][side])
            count.append(int(counts[members[-1]].sum()))
            children.append(None)
            volume.append(-1)
        children[b] = (len(members) - 2, len(members) - 1)
        members[b] = members[b][:0]
        _heap_add(heap, count, len(members) - 2)
        _heap_add(heap, count, len(members) - 1)
    box_of_key = np.full(len(keys), -1)
    nbox, stack = 0, [0]
    while stack:  # the leaves, left first; empty ones get no entry
        b = stack.pop()
        if children[b] is not None:
            stack += [children[b][1], children[b][0]]
        elif len(members[b]):
            box_of_key[members[b]] = nbox
            nbox += 1
    box = box_of_key[inv]
    sums = np.stack([np.bincount(box, weights=px[:, c], minlength=nbox) for c in range(3)], 1)
    pal = (0.5 + sums / np.bincount(box, minlength=nbox)[:, None]).astype(np.int64)
    dist = ((pal[:, None, :] - pal[None, :, :]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1, kind="stable")
    colours, first, where = np.unique(px, axis=0, return_index=True, return_inverse=True)
    match = np.empty(len(colours), np.int64)
    for i, (c, b) in enumerate(zip(colours.tolist(), box[first].tolist())):
        best = sum((p - q) ** 2 for p, q in zip(pal[b].tolist(), c))
        m, limit = b, best << 2
        for j in order[b].tolist():
            if dist[b, j] > limit:
                break
            d = sum((p - q) ** 2 for p, q in zip(pal[j].tolist(), c))
            if d < best:
                best, m = d, j
        match[i] = m
    return pal.astype(np.uint8), match[where.reshape(-1)].reshape(rgb8.shape[:2]).astype(np.uint8)


def _quantize(rgb8, colors=256):
    if native.available():
        return native.median_cut_quantize(rgb8, colors)
    return _quantize_py(rgb8, colors)


# --- read ---


def _rows(h: int, interlace: bool) -> np.ndarray:
    """The image row of each stored row: passes every 8th from 0, every 8th
    from 4, every 4th from 2, every 2nd from 1 when interlaced."""
    if not interlace:
        return np.arange(h)
    return np.concatenate([np.arange(y0, h, dy) for y0, dy in ((0, 8), (4, 8), (2, 4), (1, 2))])


def _palette_needed(p: bytes) -> bool:
    """GifImagePlugin._is_palette_needed: a table that is not the identity
    gray ramp."""
    return any(not (i == p[3 * i] == p[3 * i + 1] == p[3 * i + 2]) for i in range(len(p) // 3))


def decode_gif(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A GIF file's bytes -> uint8 RGB ``[H, W, 3]``, Pillow's
    ``Image.open(...).convert("RGB")`` (frame 0). Raises ``ValueError``
    naming ``name``."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos, palette = 13, None
    if flags & 128:
        table = data[pos:pos + (3 << ((flags & 7) + 1))]
        pos += len(table)
        if len(table) % 3:
            raise ValueError(f"{name}: GIF colour table is truncated")
        if _palette_needed(table):
            palette = table
    transparency = frame = None
    while pos < len(data) and frame is None:
        kind = data[pos:pos + 1]
        pos += 1
        if kind == b";":
            break
        if kind == b"!":
            label = data[pos] if pos < len(data) else -1
            pos += 1
            first = True
            while pos < len(data) and data[pos]:  # the extension's sub-blocks
                block = data[pos + 1:pos + 1 + data[pos]]
                if first and label == 0xF9 and len(block) >= 4 and block[0] & 1:
                    transparency = block[3]
                first = False
                pos += 1 + data[pos]
            pos += 1
        elif kind == b",":
            if pos + 9 > len(data):
                raise ValueError(f"{name}: GIF image descriptor is truncated")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            if fflags & 128:
                table = data[pos:pos + (3 << ((fflags & 7) + 1))]
                pos += len(table)
                if len(table) % 3:
                    raise ValueError(f"{name}: GIF colour table is truncated")
                palette = table if _palette_needed(table) else None
            frame = (x0, y0, fw, fh, bool(fflags & 64))
        # any other byte between blocks is skipped, as Pillow skips it
    if frame is None:
        raise ValueError(f"{name}: GIF without an image")
    if pos >= len(data):
        raise ValueError(f"{name}: GIF image data is truncated")
    min_size = data[pos]
    pos += 1
    if not 1 <= min_size <= 11:
        raise ValueError(f"{name}: GIF LZW code size {min_size} is not supported")
    chunks = []
    while pos < len(data) and data[pos]:
        chunks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    x0, y0, fw, fh, interlace = frame
    w, h = max(w, x0 + fw), max(h, y0 + fh)
    if w * h > 2 * 89478485:
        raise ValueError(f"{name}: GIF of {w}x{h} pixels is too large")
    idx, n = _lzw_decode(b"".join(chunks), min_size, fw * fh)
    if n == -1:
        raise ValueError(f"{name}: bad code in the GIF image data")
    if n < fw * fh:  # cut off, or an End code before the frame is full: Pillow raises
        raise ValueError(f"{name}: GIF image data is truncated")
    img = np.full((h, w), transparency or 0, np.uint8)
    img[y0:y0 + fh, x0:x0 + fw][_rows(fh, interlace)] = idx.reshape(fh, fw)
    if palette is None:
        return np.repeat(img[..., None], 3, axis=2)
    lut = np.zeros((256, 3), np.uint8)  # an index past the table is black, as in Pillow
    pal = np.frombuffer(palette, np.uint8).reshape(-1, 3)
    lut[:len(pal)] = pal
    return lut[img]


# --- write ---


def _color_table_size(n_colors: int) -> int:
    """GifImagePlugin._get_color_table_size: the header's size field."""
    if n_colors == 0:
        return 0
    if n_colors * 3 < 9:
        return 1
    return math.ceil(math.log(n_colors, 2)) - 1


def _optimize(idx: np.ndarray, n_colors: int) -> list[int] | None:
    """GifImagePlugin._get_optimize for a P image saved with optimize on:
    the palette entries in use, or None to keep the palette."""
    if idx.size >= 512 * 512:
        return None
    used = np.flatnonzero(np.bincount(idx.reshape(-1), minlength=256)).tolist()
    if max(used) >= len(used):
        return used
    size = 1 << (n_colors - 1).bit_length()
    if len(used) <= size // 2 and size > 2:
        return used
    return None


def encode_gif(rgb8: np.ndarray) -> bytes:
    """8-bit RGB ``[H, W, 3]`` -> the file Pillow writes for
    ``Image.fromarray(rgb8, "RGB").save(path)`` with a ``.gif`` path."""
    rgb8 = np.ascontiguousarray(rgb8, np.uint8)
    h, w = rgb8.shape[:2]
    palette, idx = _quantize(rgb8, 256)
    used = _optimize(idx, len(palette))
    if used is not None:
        remap = np.zeros(256, np.uint8)
        remap[used] = np.arange(len(used), dtype=np.uint8)
        palette, idx = palette[used], remap[idx]
    size = _color_table_size(len(palette))
    table = palette.tobytes().ljust(3 * (2 << size), b"\0")
    interlace = min(h, w) >= 16
    codes = _lzw_encode(idx[_rows(h, interlace)], 8)
    blocks = b"".join(bytes([len(codes[i:i + 255])]) + codes[i:i + 255]
                      for i in range(0, len(codes), 255))
    return (b"GIF87a" + struct.pack("<HHBBB", w, h, 128 + size, 0, 0) + table
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 64 if interlace else 0)
            + b"\x08" + blocks + b"\0;")
