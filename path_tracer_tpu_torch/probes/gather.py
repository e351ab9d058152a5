"""The gather probes on the card: can a per-ray traversal afford random
fetches of table rows, or of entries of a table tile held on chip?

    python -m path_tracer_tpu_torch.probes.gather

The counterparts of the JAX package's two platform probes, as the same
measurements: the CUDA kernels of ``csrc/gather_probe.cu``, their plain torch
versions, and the runs.

* Row gather (``benches/pallas_gather_probe.py``): ``table[idx]`` of
  128-float rows from a ``[65536, 128]`` f32 table for 16,384 indices,
  through a kernel that keeps a few rows per warp in flight with
  ``cp.async`` (the TPU probe's pipeline of row DMAs). Timed alone and in
  the probe's dependent chain of 20 gathers (``c = (c + rows[:, 0] + 1) %
  m``), against ``torch.index_select``.
* In-tile gather (``benches/pallas_lane_gather_probe.py``): mode 0
  ``out[i, j] = x[idx[i, j], j]`` on ``x [M, 128]``, mode 1 ``out[i, j] =
  x[i, idx[i, j]]`` on ``x [8, M]``, the table tile staged into shared
  memory, at the probe's shapes with 1 and 16 gathers per call (gather k
  reads entry (index + k) mod M) and the marginal cost of a gather; against
  ``torch.gather``.

A probe's single launch lasts 15-30 us, where a mean over a run moves by
tens of percent between runs; so each kernel and its library call are
also timed as the median of `MEDIAN_N` single launches each, alternating
(`_median_pair_ms`), and those medians are the probes' ``ms`` and
``library_ms``.

Each kernel has one wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. ``LAUNCHES["row_gather"]`` and
``LAUNCHES["tile_gather"]`` count the launches. Inputs are made from a seed
with NumPy. Every number printed is a device time from CUDA events (the
chain: host clock around work ending in a synchronize), with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time

import numpy as np
import torch

from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load

ROW_W = 128  # floats per row
TABLE_ROWS = 65536
N_INDICES = 16384
CHAIN = 20  # dependent gathers per chain
SUBLANE_M = (8, 64, 128, 256, 512, 1024)  # mode 0: x [M, 128]
LANE_M = (128, 256, 512, 1024, 2048, 4096, 8192)  # mode 1: x [8, M]
WAVE = (512, 128)  # the natural traversal tile, mode 0
REPS = 16
MEDIAN_N = 200  # single launches of each side in a median timing
_TILE_FLOATS = 8192  # shared-memory floats a tile block stages (32 KB)


# --- kernel binding ---


def _lib():
    p, i = ctypes.c_void_p, ctypes.c_int
    return load("gather_probe", {
        "row_gather": [i, p, p, i, p, p],
        "tile_gather": [i, p, p, i, i, i, i, i, i, p, p],
    })


def _check(*named):
    dev = named[0][1].device
    for name, x, dtype in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    return dev


def row_gather_cuda(table, idx) -> torch.Tensor:
    """Kernel ``table[idx]``: ``table [M, 128]`` f32, ``idx [N]`` int32 in
    ``[0, M)`` (not checked: an index out of range faults)."""
    dev = _check(("table", table, torch.float32), ("idx", idx, torch.int32))
    if table.dim() != 2 or table.shape[1] != ROW_W or idx.dim() != 1:
        raise ValueError(f"table must be [M, {ROW_W}] and idx [N]")
    out = torch.empty((idx.shape[0], ROW_W), dtype=torch.float32, device=dev)
    LAUNCHES["row_gather"] += 1
    err = _lib().row_gather(dev.index, table.data_ptr(), idx.data_ptr(), idx.shape[0],
                            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {err}")
    return out


def tile_gather_cuda(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
    """Kernel in-tile gather: the sum over k < ``reps`` of
    ``take_along_axis(x, (idx + k) mod M, axis)``, ``M = x.shape[axis]``;
    ``x`` f32 and ``idx`` int32 of one 2-D shape, ``idx`` in ``[0, M)``."""
    dev = _check(("x", x, torch.float32), ("idx", idx, torch.int32))
    if x.dim() != 2 or idx.shape != x.shape or axis not in (0, 1) or reps < 1:
        raise ValueError("x and idx must share one 2-D shape; axis 0 or 1; reps >= 1")
    rows, cols = x.shape
    # a "table" is a column (axis 0) or a row (axis 1) of x
    n_tables, length = (cols, rows) if axis == 0 else (rows, cols)
    st, se = (1, cols) if axis == 0 else (cols, 1)
    if length > _TILE_FLOATS:
        raise ValueError(f"a table of {length} entries exceeds the tile's {_TILE_FLOATS}")
    tb = max(1, min(n_tables, _TILE_FLOATS // length))
    out = torch.empty_like(x)
    LAUNCHES["tile_gather"] += 1
    err = _lib().tile_gather(dev.index, x.data_ptr(), idx.data_ptr(), n_tables, length, st, se,
                             tb, reps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_gather launch failed: cudaError {err}")
    return out


# --- plain torch versions ---


def row_gather_plain(table, idx) -> torch.Tensor:
    """Plain version of `row_gather_cuda`: advanced indexing."""
    return table[idx.long()]


def _wrapped(idx, k, m):
    """Gather k's indices: (idx + k) mod m (the TPU probe subtracts m once,
    the same where m >= reps)."""
    return (idx + k) % m if k else idx


def tile_gather_plain(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
    """Plain version of `tile_gather_cuda`: advanced indexing, summed in the
    probe's order (0 + g_0 + g_1 + ...)."""
    m = x.shape[axis]
    acc = torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    for k in range(reps):
        ik = _wrapped(idx, k, m).long()
        if axis == 0:
            acc = acc + x[ik, torch.arange(x.shape[1], device=x.device)]
        else:
            acc = acc + x[torch.arange(x.shape[0], device=x.device)[:, None], ik]
    return acc


def tile_gather_library(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
    """The same sum through ``torch.gather``, the library's call."""
    m = x.shape[axis]
    acc = torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    for k in range(reps):
        acc = acc + torch.gather(x, axis, _wrapped(idx, k, m).long())
    return acc


def row_gather(table, idx) -> torch.Tensor:
    """``table[idx]``: the plain version on CPU tensors, the kernel on CUDA."""
    return row_gather_plain(table, idx) if table.device.type == "cpu" else row_gather_cuda(table, idx)


def tile_gather(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
    """The in-tile gather: the plain version on CPU tensors, the kernel on CUDA."""
    if x.device.type == "cpu":
        return tile_gather_plain(x, idx, axis, reps)
    return tile_gather_cuda(x, idx, axis, reps)


def chain(gather, table, idx, steps: int = CHAIN) -> torch.Tensor:
    """The probe's dependent chain: ``steps`` gathers, each one's indices
    made from the rows the one before fetched."""
    m = table.shape[0]
    c = idx
    for _ in range(steps):
        rows = gather(table, c)
        c = (c + rows[:, 0].to(torch.int32) + 1) % m
    return c


# --- the measurements ---


def row_inputs(seed: int, device):
    """The row probe's table [65536, 128] and 16,384 indices, from a seed."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((TABLE_ROWS, ROW_W)).astype(np.float32)
    idx = rng.integers(0, TABLE_ROWS, N_INDICES).astype(np.int32)
    return torch.from_numpy(table).to(device), torch.from_numpy(idx).to(device)


def tile_inputs(seed: int, shape, axis: int, device):
    """A tile probe's x and idx of ``shape``, from a seed."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    idx = rng.integers(0, shape[axis], shape).astype(np.int32)
    return torch.from_numpy(x).to(device), torch.from_numpy(idx).to(device)


def _time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls by CUDA events, after
    one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _median_pair_ms(fn_a, fn_b, n: int = MEDIAN_N) -> tuple:
    """Median device ms of ``n`` single calls each of ``fn_a()`` and
    ``fn_b()``, alternating (a then b, then b then a, so neither always
    follows the other), each call between its own two CUDA events, after
    one warm-up call of each."""
    fn_a()
    fn_b()
    runs = []
    torch.cuda.synchronize()
    for i in range(n):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            (fn_a if side == 0 else fn_b)()
            end.record()
            runs.append((side, start, end))
    torch.cuda.synchronize()
    times = ([], [])
    for side, start, end in runs:
        times[side].append(start.elapsed_time(end))
    return float(np.median(times[0])), float(np.median(times[1]))


def _median_line(what, kernel_ms, library_ms, library) -> str:
    """The printed verdict of a median timing."""
    slower = "kernel" if kernel_ms > library_ms else library
    ratio = max(kernel_ms, library_ms) / min(kernel_ms, library_ms)
    return (f"{what}: median of {MEDIAN_N} single launches each, alternating: kernel "
            f"{kernel_ms * 1e3:.2f} us, {library} {library_ms * 1e3:.2f} us; the {slower} is "
            f"slower ({ratio:.3f}x)")


def _equal(name, a, b):
    if not torch.equal(a, b):
        raise RuntimeError(f"{name}: max |difference| {(a - b).abs().max().item():.3g}")


def run_rows(device, seed: int = 0) -> dict:
    """The row probe: the kernel against plain and library, then the
    three timed alone and in the dependent chain."""
    table, idx = row_inputs(seed, device)
    k = row_gather_cuda(table, idx)
    _equal("row gather kernel vs plain", k, row_gather_plain(table, idx))
    _equal("row gather kernel vs index_select", k, torch.index_select(table, 0, idx))
    c_k = chain(row_gather_cuda, table, idx)
    _equal("row chain kernel vs index_select", c_k,
           chain(lambda t, c: torch.index_select(t, 0, c), table, idx))
    ways = {"kernel": row_gather_cuda, "plain": row_gather_plain,
            "library": lambda t, c: torch.index_select(t, 0, c)}
    res = {"rows": N_INDICES, "bytes": N_INDICES * (2 * ROW_W * 4 + 4), "max_abs_err": 0.0}
    med = _median_pair_ms(lambda: row_gather_cuda(table, idx), lambda: ways["library"](table, idx))
    print(_median_line(f"row gather ({N_INDICES} rows)", *med, "index_select"))
    medians = {"kernel": med[0], "library": med[1]}
    for name, fn in ways.items():
        ms = medians[name] if name in medians else _time_ms(lambda: fn(table, idx), 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain(fn, table, idx)
        torch.cuda.synchronize()
        per = (time.perf_counter() - t0) / CHAIN
        chain_ms = _time_ms(lambda: chain(fn, table, idx), 5) / CHAIN
        res[name] = {"ms": ms, "chain_ms": chain_ms, "chain_host_ms": per * 1e3}
        print(f"row gather {name}: {ms * 1e3:.1f} us per {N_INDICES}-row gather "
              f"({'median' if name != 'plain' else 'mean of 50'}) "
              f"({N_INDICES / ms / 1e3:.1f}M rows/s, {res['bytes'] / ms / 1e6:.1f} GB/s); in the "
              f"chain of {CHAIN}: {chain_ms * 1e3:.1f} us per gather ({N_INDICES / chain_ms / 1e3:.1f}M "
              f"rows/s; host clock {per * 1e6:.1f} us)")
    return res


def run_tiles(device, seed: int = 0) -> dict:
    """The in-tile probe at each shape: kernel, plain and library equal at
    1 and 16 gathers; times and the marginal cost of a gather."""
    cases = ([("sublane", (m, 128), 0) for m in SUBLANE_M] + [("lane", (8, m), 1) for m in LANE_M]
             + [("sublane wave", WAVE, 0)])
    res = {}
    for tag, shape, axis in cases:
        x, idx = tile_inputs(seed, shape, axis, device)
        for reps in (1, REPS):
            k = tile_gather_cuda(x, idx, axis, reps)
            _equal(f"{tag} {shape} x{reps} kernel vs plain", k, tile_gather_plain(x, idx, axis, reps))
            _equal(f"{tag} {shape} x{reps} kernel vs library", k, tile_gather_library(x, idx, axis, reps))
        t = {name: {reps: _time_ms(lambda: fn(x, idx, axis, reps), 50) for reps in (1, REPS)}
             for name, fn in (("kernel", tile_gather_cuda), ("plain", tile_gather_plain),
                              ("library", tile_gather_library))}
        lanes = shape[0] * shape[1]
        marg = {name: (v[REPS] - v[1]) / (REPS - 1) for name, v in t.items()}
        med = _median_pair_ms(lambda: tile_gather_cuda(x, idx, axis, 1),
                              lambda: tile_gather_library(x, idx, axis, 1))
        print(_median_line(f"{tag} {shape} 1-gather", *med, "torch.gather"))
        res[f"{tag} {shape}"] = {"shape": shape, "axis": axis, "lanes": lanes, "bytes": 3 * lanes * 4,
                                 "ms": med[0], "plain_ms": t["plain"][1],
                                 "library_ms": med[1], "mean_ms": t["kernel"][1],
                                 "library_mean_ms": t["library"][1], "marginal_ms": marg["kernel"],
                                 "library_marginal_ms": marg["library"]}
        print(f"{tag:13s} shape={str(shape):12s} M={shape[axis]:5d}: kernel 1-gather call "
              f"{t['kernel'][1] * 1e3:7.2f} us, {REPS}-gather {t['kernel'][REPS] * 1e3:7.2f} us, "
              f"marginal {marg['kernel'] * 1e3:7.3f} us ({lanes / max(marg['kernel'], 1e-9) / 1e6:8.2f} "
              f"Gelem/s); torch.gather 1-gather {t['library'][1] * 1e3:7.2f} us, marginal "
              f"{marg['library'] * 1e3:7.3f} us ({lanes / max(marg['library'], 1e-9) / 1e6:8.2f} "
              f"Gelem/s); plain 1-gather {t['plain'][1] * 1e3:7.2f} us; all equal")
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probes measure the card: torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    out = {"rows": run_rows(dev, args.seed), "tiles": run_tiles(dev, args.seed)}
    print(json.dumps({"row_gather_us": out["rows"]["kernel"]["ms"] * 1e3,
                      "row_gather_chain_us": out["rows"]["kernel"]["chain_ms"] * 1e3,
                      "index_select_chain_us": out["rows"]["library"]["chain_ms"] * 1e3}))
    return out


if __name__ == "__main__":
    main()
