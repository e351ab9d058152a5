"""ctypes binding of the port's host library (``csrc/pt_native.cpp``): OBJ
parsing, the binned-SAH BVH build, the walk engine's chunk partition, the
JPEG entropy coder and integer DCTs, and the byte loops of the other raster
codecs (LZW, PackBits, TGA and BMP run lengths, GIF's median-cut quantizer,
WebP's VP8L decode loop, VP8 macroblock decode, encode and token coding,
JPEG's arithmetic and lossless scans, CCITT rows).

The library is host C++ with a plain C interface, compiled at first use
with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into ``_build/`` beside
this package (tagged by the source and the flags, written to a temporary
file and moved into place, so concurrent processes may build it at once).
Without g++ (or if the build fails) `available` is False and the callers
(`scene.model`, `scene.bvh.chunk_partition`, `scene.scene`,
`utils.imageio` and the format modules beside it) run the NumPy builders and
the Python loops, which give the same output contract.

A port of the JAX package's ``native.py``: each function's output equals
its NumPy twin's; the SAH build and the chunk partition equal the JAX
package's native library bit for bit (``tests/test_torch_native.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "pt_native.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def lib_path() -> Path:
    """The library's path, tagged by its source and the flags."""
    tag = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpt_native_{tag}.so"


def build() -> Path | None:
    """Compile the library if it is not built yet; its path, or None
    without g++ or when the build fails."""
    lib = lib_path()
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)], capture_output=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.pt_free.argtypes = [ctypes.c_void_p]
        lib.obj_load.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(_F32P), ctypes.POINTER(_F32P),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.obj_load.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_I64P),
            *[ctypes.POINTER(_F32P)] * 4, *[ctypes.POINTER(_I32P)] * 4,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.bvh_build.restype = ctypes.c_int64
        lib.chunk_build.argtypes = [
            _F32P, _F32P, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_I64P), ctypes.POINTER(_I64P), ctypes.POINTER(_I64P),
        ]
        lib.chunk_build.restype = ctypes.c_int64
        _VPP = ctypes.POINTER(ctypes.c_void_p)
        lib.jpeg_decode_scan.argtypes = [
            ctypes.c_void_p, _I64P, ctypes.c_int64, ctypes.c_int64, _VPP, _I64P, _I64P, _I64P,
            _VPP, _VPP, *[ctypes.c_int64] * 7,
        ]
        lib.jpeg_decode_scan.restype = ctypes.c_int64
        lib.jpeg_encode_scan.argtypes = [
            ctypes.c_void_p, _I32P, ctypes.c_int64, _VPP, _VPP, ctypes.POINTER(ctypes.c_void_p),
        ]
        lib.jpeg_encode_scan.restype = ctypes.c_int64
        lib.jpeg_idct_islow.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        lib.jpeg_idct_islow.restype = None
        lib.jpeg_fdct_quantize.argtypes = [ctypes.c_void_p, ctypes.c_int64, _I64P, _I64P, _I64P,
                                           ctypes.c_void_p]
        lib.jpeg_fdct_quantize.restype = None
        _U8P = ctypes.c_void_p
        _I = ctypes.c_int64
        lib.jpeg_arith_decode_scan.argtypes = [
            _U8P, _I64P, _I, _I, _VPP, *[_I64P] * 10, *[_I] * 7]
        lib.jpeg_arith_decode_scan.restype = _I
        lib.jpeg_lossless_decode_scan.argtypes = [
            _U8P, _I64P, _I, _I, _VPP, *[_I64P] * 4, _VPP, _I64P, *[_I] * 5]
        lib.jpeg_lossless_decode_scan.restype = _I
        lib.ccitt_decode.argtypes = [_U8P, _I, _I, _I, _I, _I, _I32P, _I32P, _U8P]
        lib.ccitt_decode.restype = _I
        for name, args in (("tiff_lzw_decode", [_U8P, _I, _U8P, _I]),
                           ("gif_lzw_decode", [_U8P, _I, _I, _U8P, _I]),
                           ("gif_lzw_encode", [_U8P, _I, _I, _U8P, _I]),
                           ("packbits_decode", [_U8P, _I, _U8P, _I]),
                           ("tga_rle_decode", [_U8P, _I, _I, _I, _I, _U8P]),
                           ("bmp_rle_decode", [_U8P, _I, _I, _I, _I, _U8P, _I]),
                           ("median_cut_quantize", [_U8P, _I, _I, _U8P, _U8P]),
                           ("vp8l_decode", [_U8P, _I, _I, _I, _I, _U8P, _U8P, _I]),
                           ("vp8_decode_frame", [_U8P, _I, _U8P, _U8P, _U8P, _I, _I, _I, _U8P, _U8P, _U8P,
                                                 _U8P, _U8P, _U8P]),
                           ("vp8_encode_mbs", [_U8P, _U8P, _U8P, _I, _I, _U8P, _U8P, _U8P, _I, _I, _U8P, _U8P,
                                               _U8P, _U8P, _U8P]),
                           ("vp8_write_tokens", [_U8P, _U8P, _U8P, _U8P, _I, _I, _I, _U8P, _U8P, _I, _U8P]),
                           ("vp8_write_modes", [_U8P, _I, _U8P, _U8P, _U8P, _U8P, _I, _I, _I, _U8P, _U8P, _I])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int64
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (g++ is there)."""
    return _load() is not None


def _take(lib, ptr, count, np_dtype, shape):
    """Copy a malloc'd C array into NumPy and free it."""
    ctype = {np.float32: ctypes.c_float, np.int32: ctypes.c_int32, np.int64: ctypes.c_int64}[np_dtype]
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), shape=(count,)).copy()
    lib.pt_free(ptr)
    return arr.reshape(shape)


def load_obj(path) -> tuple[np.ndarray, np.ndarray]:
    """Native OBJ parse; the output of `scene.objio.load_obj`."""
    lib = _load()
    assert lib is not None
    pos_p, nrm_p = _F32P(), _F32P()
    n_tris = ctypes.c_int64()
    rc = lib.obj_load(str(path).encode(), ctypes.byref(pos_p), ctypes.byref(nrm_p), ctypes.byref(n_tris))
    if rc != 0:
        raise FileNotFoundError(path)
    t = n_tris.value
    return (_take(lib, pos_p, t * 9, np.float32, (t, 3, 3)),
            _take(lib, nrm_p, t * 9, np.float32, (t, 3, 3)))


def build_bvh(aabb_min: np.ndarray, aabb_max: np.ndarray, max_leaf: int = 4):
    """Native SAH build: ``(flat, perm, depth)``, the output of
    `scene.bvh.build_bvh`."""
    from path_tracer_tpu_torch.scene.bvh import NO_CHILD_BOUND

    lib = _load()
    assert lib is not None
    n = aabb_min.shape[0]
    bbmin = np.ascontiguousarray(aabb_min, np.float32)
    bbmax = np.ascontiguousarray(aabb_max, np.float32)
    perm_p = _I64P()
    f = [_F32P() for _ in range(4)]
    i = [_I32P() for _ in range(4)]
    depth = ctypes.c_int64()
    m = lib.bvh_build(
        bbmin.ctypes.data_as(_F32P), bbmax.ctypes.data_as(_F32P), n, max_leaf,
        ctypes.byref(perm_p), *[ctypes.byref(p) for p in f], *[ctypes.byref(p) for p in i],
        ctypes.byref(depth),
    )
    if m < 0:
        raise ValueError("bvh_build failed")
    perm = _take(lib, perm_p, n, np.int64, (n,))
    flat = {k: _take(lib, p, m * 3, np.float32, (m, 3))
            for k, p in zip(("c0_min", "c0_max", "c1_min", "c1_max"), f)}
    flat.update({k: _take(lib, p, m, np.int32, (m,))
                 for k, p in zip(("c0_idx", "c0_count", "c1_idx", "c1_count"), i)})
    no_c1 = flat["c1_count"][0] == -1
    flat["root_min"] = np.minimum(
        flat["c0_min"][0], np.where(no_c1, NO_CHILD_BOUND, flat["c1_min"][0])).astype(np.float32)
    flat["root_max"] = np.maximum(
        flat["c0_max"][0], np.where(no_c1, -NO_CHILD_BOUND, flat["c1_max"][0])).astype(np.float32)
    return flat, perm, int(depth.value)


def chunk_partition(aabb_min: np.ndarray, aabb_max: np.ndarray, chunk: int):
    """Native spatial chunk partition: ``(perm, starts, spans)``, the output
    of `scene.bvh.chunk_partition_py`, bit for bit."""
    lib = _load()
    assert lib is not None
    n = aabb_min.shape[0]
    bbmin = np.ascontiguousarray(aabb_min, np.float32)
    bbmax = np.ascontiguousarray(aabb_max, np.float32)
    perm_p, starts_p, spans_p = _I64P(), _I64P(), _I64P()
    k = lib.chunk_build(
        bbmin.ctypes.data_as(_F32P), bbmax.ctypes.data_as(_F32P), n, chunk,
        ctypes.byref(perm_p), ctypes.byref(starts_p), ctypes.byref(spans_p),
    )
    if k < 0:
        raise ValueError("chunk_build failed")
    return (_take(lib, perm_p, n, np.int64, (n,)), _take(lib, starts_p, k, np.int64, (k,)),
            _take(lib, spans_p, k, np.int64, (k,)))


def _pointers(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])


def _arr(values) -> np.ndarray:
    return np.ascontiguousarray(values, np.int64)


def _check_coefs(name, coefs, geom, mcus_x, mcus_y):
    for c, (h, v) in zip(coefs, geom):
        if c.dtype != np.int16 or not c.flags.c_contiguous or c.ndim != 3 or c.shape[2] != 64:
            raise ValueError(f"{name}: coefficients must be C-contiguous int16 [rows, cols, 64]")
        if c.shape[0] < mcus_y * v or c.shape[1] < mcus_x * h:
            raise ValueError(f"{name}: coefficient array smaller than the scan's MCUs")


def jpeg_decode_scan(data: bytes, starts, coefs, geom, luts, mcus_x: int, mcus_y: int,
                     ss: int, se: int, ah: int, al: int, restart: int) -> int:
    """Native Huffman decode of one JPEG scan, in place; the arguments and
    the return code of `utils.imageio._decode_scan_py`."""
    from path_tracer_tpu_torch.utils.imageio import _SCAN_PAD

    lib = _load()
    assert lib is not None
    st = np.ascontiguousarray(starts, np.int64)
    if len(data) < int(st[-1]) + _SCAN_PAD:
        raise ValueError("jpeg_decode_scan: the scan data lacks its zero padding")
    _check_coefs("jpeg_decode_scan", coefs, geom, mcus_x, mcus_y)
    tables = [np.ascontiguousarray(t, np.uint16) for pair in luts for t in pair]
    if any(t.shape != (1 << 16,) for t in tables):
        raise ValueError("jpeg_decode_scan: lookahead tables must have 65536 entries")
    buf = np.frombuffer(data, np.uint8)
    cols = np.array([c.shape[1] for c in coefs], np.int64)
    hs = np.array([g[0] for g in geom], np.int64)
    vs = np.array([g[1] for g in geom], np.int64)
    return int(lib.jpeg_decode_scan(
        buf.ctypes.data, st.ctypes.data_as(_I64P), st.size, len(coefs), _pointers(coefs),
        cols.ctypes.data_as(_I64P), hs.ctypes.data_as(_I64P), vs.ctypes.data_as(_I64P),
        _pointers(tables[0::2]), _pointers(tables[1::2]), mcus_x, mcus_y, ss, se, ah, al, restart))


def jpeg_arith_decode_scan(data: bytes, starts, coefs, geom, tables, cond, mcus_x: int, mcus_y: int,
                           ss: int, se: int, ah: int, al: int, restart: int, natural, qe) -> int:
    """Native arithmetic decode of one JPEG scan, in place; the arguments
    and the return code of `utils.jpeg_arith.decode_scan_py`, and ``qe``,
    Table D.2 packed as `utils.jpeg_arith.QE`."""
    lib = _load()
    assert lib is not None
    _check_coefs("jpeg_arith_decode_scan", coefs, geom, mcus_x, mcus_y)
    st = _arr(starts)
    if len(data) < int(st[-1]):
        raise ValueError("jpeg_arith_decode_scan: the restart intervals run past the data")
    if any(not (0 <= t < 16) for pair in tables for t in pair):
        raise ValueError("jpeg_arith_decode_scan: statistics tables are 0 to 15")
    l, u, k = (_arr(t) for t in cond)
    qe, nat = _arr(qe), _arr(natural)
    if l.shape != (16,) or u.shape != (16,) or k.shape != (16,) or qe.shape != (114,) or nat.size < 64:
        raise ValueError("jpeg_arith_decode_scan: conditioning, Qe or natural-order table of the wrong size")
    buf = np.frombuffer(bytes(data) + b"\0", np.uint8)
    cols, hs, vs = (_arr(x) for x in ([c.shape[1] for c in coefs], [g[0] for g in geom], [g[1] for g in geom]))
    dc, ac = _arr([t[0] for t in tables]), _arr([t[1] for t in tables])
    ptr = [a.ctypes.data_as(_I64P) for a in (cols, hs, vs, dc, ac, l, u, k, qe, nat)]
    return int(lib.jpeg_arith_decode_scan(buf.ctypes.data, st.ctypes.data_as(_I64P), st.size, len(coefs),
                                          _pointers(coefs), *ptr, mcus_x, mcus_y, ss, se, ah, al, restart))


def jpeg_lossless_decode_scan(data: bytes, starts, planes, geom, luts, rows_per_imcu, mcus_x: int,
                              mcus_y: int, predictor: int, pt: int, restart: int) -> int:
    """Native decode of one lossless JPEG scan into its components' planes;
    the arguments and the return code of
    `utils.jpeg_lossless.decode_scan_py`."""
    lib = _load()
    assert lib is not None
    st = _arr(starts)
    if len(data) < int(st[-1]):
        raise ValueError("jpeg_lossless_decode_scan: the restart intervals run past the data")
    for p, (h, v) in zip(planes, geom):
        if p.dtype != np.uint8 or not p.flags.c_contiguous or p.ndim != 2:
            raise ValueError("jpeg_lossless_decode_scan: planes must be C-contiguous uint8 [h, w]")
        if p.shape[0] > mcus_y * v or p.shape[1] > mcus_x * h:
            raise ValueError("jpeg_lossless_decode_scan: a plane larger than the scan's MCUs")
    if not (1 <= predictor <= 7 and 0 <= pt < 8) or (restart and restart % mcus_x):
        raise ValueError("jpeg_lossless_decode_scan: bad predictor, point transform or restart interval")
    tables = [np.ascontiguousarray(t, np.uint16) for t in luts]
    if any(t.shape != (1 << 16,) for t in tables):
        raise ValueError("jpeg_lossless_decode_scan: lookahead tables must have 65536 entries")
    buf = np.frombuffer(bytes(data) + bytes(1024), np.uint8)  # a scan's reads run at most 40 bytes past
    widths, heights = _arr([p.shape[1] for p in planes]), _arr([p.shape[0] for p in planes])
    hs, vs, rows = _arr([g[0] for g in geom]), _arr([g[1] for g in geom]), _arr(rows_per_imcu)
    ptr = [a.ctypes.data_as(_I64P) for a in (widths, heights, hs, vs)]
    return int(lib.jpeg_lossless_decode_scan(buf.ctypes.data, st.ctypes.data_as(_I64P), st.size, len(planes),
                                             _pointers(planes), *ptr, _pointers(tables),
                                             rows.ctypes.data_as(_I64P), mcus_x, mcus_y, predictor, pt, restart))


def jpeg_encode_scan(blocks: np.ndarray, sel: np.ndarray, codes, sizes) -> bytes:
    """Native Huffman encode of quantized blocks; the arguments and the
    output of `utils.imageio._encode_scan_py`."""
    lib = _load()
    assert lib is not None
    blk = np.ascontiguousarray(blocks, np.int16)
    sl = np.ascontiguousarray(sel, np.int32)
    if blk.ndim != 2 or blk.shape[1] != 64 or sl.shape != (blk.shape[0],):
        raise ValueError("jpeg_encode_scan: blocks must be [n, 64] with one selector each")
    cs = [np.ascontiguousarray(c, np.uint32) for c in codes]
    zs = [np.ascontiguousarray(z, np.uint8) for z in sizes]
    if sl.size and (sl.min() < 0 or 2 * int(sl.max()) + 1 >= min(len(cs), len(zs))):
        raise ValueError("jpeg_encode_scan: a selector has no tables")
    if any(t.shape != (256,) for t in cs + zs):
        raise ValueError("jpeg_encode_scan: tables must have 256 entries")
    out = ctypes.c_void_p()
    n = lib.jpeg_encode_scan(blk.ctypes.data, sl.ctypes.data_as(_I32P), blk.shape[0],
                             _pointers(cs), _pointers(zs), ctypes.byref(out))
    if n < 0:
        raise MemoryError("jpeg_encode_scan: out of memory")
    data = ctypes.string_at(out.value, n)
    lib.pt_free(out)
    return data


def jpeg_idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Native dequantize and inverse DCT; the output of
    `utils.imageio._idct_islow_np`."""
    lib = _load()
    assert lib is not None
    c = np.ascontiguousarray(coef, np.int16).reshape(-1, 64)
    qs = np.ascontiguousarray(np.asarray(q).astype(np.int16))
    if qs.shape != (64,):
        raise ValueError("jpeg_idct_islow: the quantization table must have 64 entries")
    out = np.empty((c.shape[0], 64), np.uint8)
    lib.jpeg_idct_islow(c.ctypes.data, c.shape[0], qs.ctypes.data, out.ctypes.data)
    return out


def jpeg_fdct_quantize(samples: np.ndarray, recip: np.ndarray, corr: np.ndarray,
                       shift: np.ndarray) -> np.ndarray:
    """Native forward DCT and quantizer; the output of
    `utils.imageio._fdct_quantize_np` with the divisors of its table."""
    lib = _load()
    assert lib is not None
    s = np.ascontiguousarray(samples, np.uint8).reshape(-1, 64)
    tabs = [np.ascontiguousarray(t, np.int64) for t in (recip, corr, shift)]
    if any(t.shape != (64,) for t in tabs):
        raise ValueError("jpeg_fdct_quantize: the divisor tables must have 64 entries")
    out = np.empty((s.shape[0], 64), np.int16)
    lib.jpeg_fdct_quantize(s.ctypes.data, s.shape[0], *[t.ctypes.data_as(_I64P) for t in tabs],
                           out.ctypes.data)
    return out


# --- the raster codecs' byte loops (their Python twins are in utils/) ---


def _buf(data) -> np.ndarray:
    return np.frombuffer(bytes(data), np.uint8)


def tiff_lzw_decode(data: bytes, size: int) -> tuple[bytes, int]:
    """`utils.tiff._lzw_decode_py`: (at most ``size`` bytes, return code)."""
    lib = _load()
    assert lib is not None
    src, out = _buf(data), np.zeros(max(size, 1), np.uint8)
    n = lib.tiff_lzw_decode(src.ctypes.data, len(data), out.ctypes.data, size)
    return out[:max(n, 0)].tobytes(), min(n, 0)


def gif_lzw_decode(data: bytes, min_size: int, size: int) -> tuple[np.ndarray, int]:
    """`utils.gif._lzw_decode_py`: (indices, the count written or a negative
    code)."""
    lib = _load()
    assert lib is not None
    src, out = _buf(data), np.zeros(max(size, 1), np.uint8)
    n = lib.gif_lzw_decode(src.ctypes.data, len(data), min_size, out.ctypes.data, size)
    if n == -1:
        out[:] = 0
    return out[:size], n


def gif_lzw_encode(indices: np.ndarray, min_size: int) -> bytes:
    """`utils.gif._lzw_encode_py`: the code stream of ``indices``."""
    lib = _load()
    assert lib is not None
    src = np.ascontiguousarray(indices, np.uint8).reshape(-1)
    cap = 2 * src.size + 64  # <= 12 bits a code, a code per index, the Clears
    out = np.zeros(cap, np.uint8)
    n = lib.gif_lzw_encode(src.ctypes.data, src.size, min_size, out.ctypes.data, cap)
    if n < 0:
        raise MemoryError("gif_lzw_encode: output buffer too small")
    return out[:n].tobytes()


def packbits_decode(data: bytes, size: int) -> bytes:
    """`utils.tiff._packbits_decode_py`: at most ``size`` bytes."""
    lib = _load()
    assert lib is not None
    src, out = _buf(data), np.zeros(max(size, 1), np.uint8)
    n = lib.packbits_decode(src.ctypes.data, len(data), out.ctypes.data, size)
    return out[:n].tobytes()


def tga_rle_decode(data: bytes, depth: int, row_bytes: int, rows: int) -> tuple[bytes, int]:
    """`utils.tga._rle_decode_py`: (the bytes written, return code)."""
    lib = _load()
    assert lib is not None
    src, out = _buf(data), np.zeros(max(row_bytes * rows, 1), np.uint8)
    n = lib.tga_rle_decode(src.ctypes.data, len(data), depth, row_bytes, rows, out.ctypes.data)
    return out[:max(n, 0)].tobytes(), min(n, 0)


def bmp_rle_decode(data: bytes, base: int, width: int, rle4: bool, size: int) -> tuple[np.ndarray, int]:
    """`utils.bmp._rle_decode_py`: (indices, the count written or -1)."""
    lib = _load()
    assert lib is not None
    src, out = _buf(data), np.zeros(max(size, 1), np.uint8)
    n = lib.bmp_rle_decode(src.ctypes.data, len(data), base, width, int(rle4), out.ctypes.data, size)
    return out[:max(n, 0)], n


def median_cut_quantize(rgb8: np.ndarray, colors: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """`utils.gif._quantize_py`: (palette ``[k, 3]`` uint8, indices
    ``[H, W]`` uint8)."""
    lib = _load()
    assert lib is not None
    px = np.ascontiguousarray(rgb8, np.uint8)
    pal, idx = np.zeros((colors, 3), np.uint8), np.zeros(px.shape[:2], np.uint8)
    k = lib.median_cut_quantize(px.ctypes.data, px.shape[0] * px.shape[1], colors,
                                pal.ctypes.data, idx.ctypes.data)
    return pal[:k], idx


def ccitt_decode(data: bytes, width: int, rows: int, code: int, options: int,
                 white_lut, black_lut) -> tuple[bytes, int]:
    """`utils.ccitt.decode_py` with its lookahead tables (12 and 13 bits
    wide): (the packed rows, 0), or (b"", a negative code)."""
    lib = _load()
    assert lib is not None
    wl, bl = _i32(white_lut), _i32(black_lut)
    if wl.shape != (1 << 12,) or bl.shape != (1 << 13,) or code not in (2, 3, 4) or width <= 0 or rows < 0:
        raise ValueError("ccitt_decode: bad tables, compression or size")
    src = _buf(data)
    out = np.zeros(max(rows * ((width + 7) // 8), 1), np.uint8)
    rc = lib.ccitt_decode(src.ctypes.data, len(data), width, rows, code, options,
                          wl.ctypes.data_as(_I32P), bl.ctypes.data_as(_I32P), out.ctypes.data)
    return (b"", int(rc)) if rc else (out[:rows * ((width + 7) // 8)].tobytes(), 0)


# --- WebP (their Python twins are in utils/vp8l.py and utils/vp8.py) ---


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def vp8l_decode(data: bytes, xsize: int, ysize: int, bit_pos: int, distance_map):
    """`utils.vp8l._decode_stream_py`: (transforms, residual pixels) or an
    error code."""
    lib = _load()
    assert lib is not None
    src = _buf(data)
    sub = ((xsize + 3) >> 2) * ((ysize + 3) >> 2)
    out = np.zeros(1 + xsize * ysize + 2 * sub + 256 + 16, np.uint32)
    n = lib.vp8l_decode(src.ctypes.data, len(data), xsize, ysize, bit_pos, _i32(distance_map).ctypes.data,
                        out.ctypes.data, out.size)
    if n < 0:
        return int(n)
    transforms, i = [], 1
    for _ in range(int(out[0])):
        kind, bits, xs, count = (int(v) for v in out[i:i + 4])
        data_ = out[i + 4:i + 4 + count].copy()
        if kind in (0, 1):
            data_ = data_.reshape((ysize + (1 << bits) - 1) >> bits, (xs + (1 << bits) - 1) >> bits)
        elif kind == 3:
            data_ = data_.reshape(1, count)
            xsize = (xs + (1 << bits) - 1) >> bits
        transforms.append((kind, bits, xs, data_))
        i += 4 + count
    return transforms, out[i:i + xsize * ysize].reshape(ysize, xsize).copy()


def vp8_decode_frame(part0: bytes, state, parts, mb_w: int, mb_h: int, P: dict, bmodes):
    """`utils.vp8._decode_frame_py`: the planes (Y, U, V) or -1."""
    lib = _load()
    assert lib is not None
    p0 = _buf(part0)
    cat = _buf(b"".join(parts))
    offsets = np.cumsum([0] + [len(p) for p in parts]).astype(np.int64)
    params = _i32([P["update_map"], *P["segment_probs"], P["use_skip"], P["skip_p"], P["filter_type"],
                   *np.ravel(P["quant"]), *np.ravel(P["fstrengths"])])
    probs = np.ascontiguousarray(P["probs"], np.uint8)
    st = np.array(state, np.int64)
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
    U, V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8), np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
    rc = lib.vp8_decode_frame(p0.ctypes.data, len(part0), st.ctypes.data, cat.ctypes.data, offsets.ctypes.data,
                              len(parts), mb_w, mb_h, params.ctypes.data, probs.ctypes.data,
                              np.ascontiguousarray(bmodes, np.uint8).ctypes.data, Y.ctypes.data, U.ctypes.data,
                              V.ctypes.data)
    return int(rc) if rc else (Y, U, V)


def vp8_encode_mbs(Y, U, V, segs, quant, lambdas, rounding, probs0, bit_cost, bmodes):
    """`utils.vp8._encode_mbs_py`: (modes, levels)."""
    lib = _load()
    assert lib is not None
    Y, U, V = (np.ascontiguousarray(a, np.uint8) for a in (Y, U, V))
    mb_h, mb_w = Y.shape[0] // 16, Y.shape[1] // 16
    modes = np.zeros((mb_w * mb_h, 18), np.int32)
    levels = np.zeros((mb_w * mb_h, 25, 16), np.int16)
    segs, quant, probs, cost = _i32(segs), _i32(quant), _i32(probs0), _i32(bit_cost)
    lam = np.ascontiguousarray(lambdas, np.int64)
    lib.vp8_encode_mbs(Y.ctypes.data, U.ctypes.data, V.ctypes.data, mb_w, mb_h, segs.ctypes.data,
                       quant.ctypes.data, lam.ctypes.data, rounding[0], rounding[1], probs.ctypes.data,
                       cost.ctypes.data, np.ascontiguousarray(bmodes, np.uint8).ctypes.data, modes.ctypes.data,
                       levels.ctypes.data)
    return modes, levels


def vp8_write_tokens(modes, levels, skips, probs, mb_w: int, n_parts: int):
    """`utils.vp8._write_tokens_py`: the partitions' bytes, or with
    ``probs`` None the statistics."""
    lib = _load()
    assert lib is not None
    modes, skips = _i32(modes), np.ascontiguousarray(skips, np.uint8)
    levels = np.ascontiguousarray(levels, np.int16)
    n_mb = len(modes)
    if probs is None:
        stats = np.zeros((4 * 8 * 3 * 11, 2), np.int64)
        pos = _i32(np.arange(4 * 8 * 3 * 11) + 256)
        lib.vp8_write_tokens(modes.ctypes.data, levels.ctypes.data, skips.ctypes.data, pos.ctypes.data, mb_w,
                             n_mb, n_parts, stats.ctypes.data, None, 0, None)
        return stats.reshape(4, 8, 3, 11, 2)
    probs = _i32(probs)
    cap = 64 * 1024 + 1200 * n_mb  # a macroblock's 400 levels take at most ~1 KB of tokens
    out = np.zeros(cap, np.uint8)
    sizes = np.zeros(n_parts, np.int64)
    n = lib.vp8_write_tokens(modes.ctypes.data, levels.ctypes.data, skips.ctypes.data, probs.ctypes.data, mb_w,
                             n_mb, n_parts, None, out.ctypes.data, cap, sizes.ctypes.data)
    if n < 0:
        raise MemoryError("vp8_write_tokens: output buffer too small")
    ends = np.cumsum(sizes)
    return [out[e - s:e].tobytes() for s, e in zip(sizes, ends)]


def vp8_write_modes(header_bits, modes, segs, skips, seg_probs, skip_p: int, mb_w: int, bmodes) -> bytes:
    """`utils.vp8._write_modes_py`: the first partition's bytes."""
    lib = _load()
    assert lib is not None
    bits, modes, segs = _i32(header_bits), _i32(modes), _i32(segs)
    skips = np.ascontiguousarray(skips, np.uint8)
    sp = _i32(seg_probs) if seg_probs is not None else None
    cap = 4096 + len(bits) // 4 + 64 * len(modes)
    out = np.zeros(cap, np.uint8)
    n = lib.vp8_write_modes(bits.ctypes.data, len(bits), modes.ctypes.data, segs.ctypes.data, skips.ctypes.data,
                            sp.ctypes.data if sp is not None else None, skip_p, mb_w, len(modes),
                            np.ascontiguousarray(bmodes, np.uint8).ctypes.data, out.ctypes.data, cap)
    if n < 0:
        raise MemoryError("vp8_write_modes: output buffer too small")
    return out[:n].tobytes()
