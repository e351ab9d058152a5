"""The gather probes on the card: can a per-ray traversal afford random
fetches of table rows, or of entries of a table tile held on chip?

    python -m path_tracer_tpu_torch.probes.gather
    python -m path_tracer_tpu_torch.probes.gather --parent <another tree's csrc directory>

The counterparts of the JAX package's two platform probes, as the same
measurements: the CUDA kernels of ``csrc/gather_probe.cu``, their plain torch
versions, and the runs.

* Row gather (``benches/pallas_gather_probe.py``): ``table[idx]`` of
  128-float rows from a ``[65536, 128]`` f32 table for 16,384 indices.
  Timed alone and in the probe's dependent chain of 20 gathers (``c = (c +
  rows[:, 0] + 1) % m``), against ``torch.index_select``.
* In-tile gather (``benches/pallas_lane_gather_probe.py``): mode 0
  ``out[i, j] = x[idx[i, j], j]`` on ``x [M, 128]``, mode 1 ``out[i, j] =
  x[i, idx[i, j]]`` on ``x [8, M]``, the table tile staged into shared
  memory, at the probe's shapes with 1 and 16 gathers per call (gather k
  reads entry (index + k) mod M) and the marginal cost of a gather; against
  ``torch.gather``.

How each call is timed. A probe's kernel lasts a few microseconds, less
than the host takes to issue it, so an event pair around a call issued on
an idle card brackets the host's issue time as well. Each kernel and its
library call are therefore timed four ways (`timings`):

* ``ms`` / ``library_ms``, the device-only median (`device_medians`):
  batches of single calls, alternating, each between its own two CUDA
  events, all queued behind one ``torch.cuda._sleep``; the host issues the
  whole batch before the sleep ends (checked on every batch), so every
  event pair brackets device work only;
* ``issue_ms`` / ``library_issue_ms``, the issue-inclusive median of single
  calls issued on an idle card (`_median_pair_ms`, the measure until then);
* ``host_issue_ms`` / ``library_host_issue_ms``, the host clock around
  `MEDIAN_N` calls without a synchronise, over `MEDIAN_N`;
* ``floor_ms``, the device-only median of an empty kernel from the same
  source launched the same way: no single launch takes less.

With ``--parent``, another tree's kernels (its ``gather_probe.cu``, built
here) are held to this tree's outputs and timed beside them, device-only,
in turns (other, this, this, other, ...).

Each kernel has one wrapper: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises. ``LAUNCHES["row_gather"]`` and
``LAUNCHES["tile_gather"]`` count the launches (the empty kernel's and
another tree's are not counted). Inputs are made from a seed with NumPy.
Every time printed is a device time from CUDA events but the host issue
times, with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from path_tracer_tpu_torch.trace import cuda_lib
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES, load

ROW_W = 128  # floats per row
TABLE_ROWS = 65536
N_INDICES = 16384
CHAIN = 20  # dependent gathers per chain
CHAIN_N = 20  # chains of each side in a device-only median
SUBLANE_M = (8, 64, 128, 256, 512, 1024)  # mode 0: x [M, 128]
LANE_M = (128, 256, 512, 1024, 2048, 4096, 8192)  # mode 1: x [8, M]
WAVE = (512, 128)  # the natural traversal tile, mode 0
REPS = 16
MEDIAN_N = 200  # single launches of each side in a median timing
MAX_LEN = 8192  # entries of the longest table the in-tile kernel stages (32 KB)
SLEEP_CYCLES = 40_000_000  # a device-only batch's sleep: 20 ms or more at <= 2 GHz
MAX_SLEEP_CYCLES = 32 * SLEEP_CYCLES  # the longest sleep a one-round batch may grow to
ISSUE_MS = 10.0  # host issue time a device-only batch is sized for


# --- kernel binding ---

_P, _I = ctypes.c_void_p, ctypes.c_int
_ROW_ARGS = [_I, _P, _P, _I, _P, _P]
_TILE_ARGS = [_I, _P, _P, _I, _I, _I, _I, _P, _P]


def _lib():
    return load("gather_probe", {"row_gather": _ROW_ARGS, "tile_gather": _TILE_ARGS,
                                 "empty_launch": [_I, _P]})


def _check(*named):
    dev = named[0][1].device
    for name, x, dtype in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must be a CUDA tensor on {dev}, got {x.device}")
        if x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    return dev


def _aligned(*tensors):
    """The kernels move 16-B vectors: each tensor must start on 16 bytes."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel's tensors must start on a 16-byte boundary")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _row_launch(entry, table, idx, counted: bool = False) -> torch.Tensor:
    """``table[idx]`` through ``entry()``, a ``row_gather`` entry point,
    after the checks; ``counted``: add one to its launch count."""
    dev = _check(("table", table, torch.float32), ("idx", idx, torch.int32))
    if table.dim() != 2 or table.shape[1] != ROW_W or idx.dim() != 1:
        raise ValueError(f"table must be [M, {ROW_W}] and idx [N]")
    _aligned(table)
    out = torch.empty((idx.shape[0], ROW_W), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out  # nothing to launch
    fn = entry()
    LAUNCHES["row_gather"] += int(counted)
    _raise_on(fn(dev.index, table.data_ptr(), idx.data_ptr(), idx.shape[0], out.data_ptr(),
                 _stream(dev)), "row_gather")
    return out


def _tile_check(x, idx, axis, reps):
    """The in-tile gather's device after its checks."""
    dev = _check(("x", x, torch.float32), ("idx", idx, torch.int32))
    if x.dim() != 2 or idx.shape != x.shape or axis not in (0, 1) or reps < 1:
        raise ValueError("x and idx must share one 2-D shape; axis 0 or 1; reps >= 1")
    if x.shape[axis] > MAX_LEN:
        raise ValueError(f"a table of {x.shape[axis]} entries exceeds the tile's {MAX_LEN}")
    _aligned(x, idx)
    return dev


def row_gather_cuda(table, idx) -> torch.Tensor:
    """Kernel ``table[idx]``: ``table [M, 128]`` f32, ``idx [N]`` int32 in
    ``[0, M)`` (not checked: an index out of range faults); with no index,
    no launch."""
    return _row_launch(lambda: _lib().row_gather, table, idx, counted=True)


def tile_gather_cuda(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
    """Kernel in-tile gather: the sum over k < ``reps`` of
    ``take_along_axis(x, (idx + k) mod M, axis)``, ``M = x.shape[axis]`` at
    most `MAX_LEN`; ``x`` f32 and ``idx`` int32 of one 2-D shape whose
    width is a multiple of 4, ``idx`` in ``[0, M)``; an empty ``x``
    launches nothing."""
    dev = _tile_check(x, idx, axis, reps)
    rows, cols = x.shape
    if cols % 4:
        raise ValueError(f"the kernel moves 16-B quads: the width {cols} must be a multiple of 4")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out  # nothing to launch
    lib = _lib()
    LAUNCHES["tile_gather"] += 1
    _raise_on(lib.tile_gather(dev.index, x.data_ptr(), idx.data_ptr(), rows, cols, axis, reps,
                              out.data_ptr(), _stream(dev)), "tile_gather")
    return out


def empty_cuda(dev) -> None:
    """Launch the empty kernel (one block that does nothing): the launch
    floor. Not counted in ``LAUNCHES``."""
    _raise_on(_lib().empty_launch(dev.index, _stream(dev)), "empty_kernel")


def other_probe(lib: ctypes.CDLL, csrc: Path) -> SimpleNamespace:
    """Wrappers ``row(table, idx)`` and ``tile(x, idx, axis, reps)`` of
    another tree's probe kernels: ``lib``, its ``gather_probe.cu`` built
    from ``csrc``. Their launches are not counted."""
    lib.row_gather.argtypes, lib.row_gather.restype = _ROW_ARGS, ctypes.c_int
    lib.tile_gather.argtypes, lib.tile_gather.restype = _TILE_ARGS, ctypes.c_int

    def tile(x, idx, axis: int, reps: int = 1) -> torch.Tensor:
        dev = _tile_check(x, idx, axis, reps)
        rows, cols = x.shape
        out = torch.empty_like(x)
        if out.numel() == 0:
            return out
        _raise_on(lib.tile_gather(dev.index, x.data_ptr(), idx.data_ptr(), rows, cols, axis, reps,
                                  out.data_ptr(), _stream(dev)), "other tile_gather")
        return out

    def row(table, idx) -> torch.Tensor:
        return _row_launch(lambda: lib.row_gather, table, idx)

    return SimpleNamespace(label=str(csrc), row=row, tile=tile)


def load_other(csrc: Path) -> SimpleNamespace:
    """`other_probe` of the ``gather_probe.cu`` in ``csrc``, built here."""
    return other_probe(ctypes.CDLL(str(cuda_lib.build("gather_probe", csrc=csrc)[0])), csrc)


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


def _event():
    return torch.cuda.Event(enable_timing=True)


def _time_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls by CUDA events, after
    one warm-up call."""
    fn()
    start, end = _event(), _event()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_medians(fns, n: int = MEDIAN_N) -> tuple:
    """Device-only median ms of ``n`` single calls of each of ``fns``:
    (medians, {"sleep_ms", "issue_ms", "batches"}).

    Each batch queues one ``torch.cuda._sleep`` of `SLEEP_CYCLES`, then
    rounds of one call of each function, the order rotating from round to
    round, each call between its own two CUDA events (made before the
    sleep). The rounds per batch are sized from one timed round so that the
    host issues the batch in about `ISSUE_MS`; a batch whose host issue
    time is not below its sleep's device time (the event pair around the
    sleep) is discarded and the rounds halved, or, at one round, the sleep
    doubled (a stall of the host can outlast one sleep), up to
    `MAX_SLEEP_CYCLES`. So every event pair kept brackets device work
    queued behind device work: none of the host's issue time."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in fns:
        fn()
    per_round = time.perf_counter() - t0
    torch.cuda.synchronize()
    rounds = max(1, int(ISSUE_MS * 1e-3 / per_round))
    cycles = SLEEP_CYCLES
    k = len(fns)
    times = [[] for _ in fns]
    worst = {"sleep_ms": float("inf"), "issue_ms": 0.0, "batches": 0}
    while len(times[0]) < n:
        r = min(rounds, n - len(times[0]))
        pairs = [(_event(), _event()) for _ in range(r * k)]
        sleep_start = _event()
        t0 = time.perf_counter()
        sleep_start.record()
        torch.cuda._sleep(cycles)
        sides = []
        for i in range(r):
            for j in range(k):
                side = (i + j) % k
                start, end = pairs[i * k + j]
                start.record()
                fns[side]()
                end.record()
                sides.append(side)
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        sleep_ms = sleep_start.elapsed_time(pairs[0][0])
        if issue_ms >= sleep_ms:
            if r > 1:
                rounds = max(1, r // 2)
            elif cycles < MAX_SLEEP_CYCLES:
                cycles *= 2
            else:
                raise RuntimeError(f"one round takes {issue_ms:.2f} ms to issue, over the "
                                   f"{sleep_ms:.2f} ms sleep of {cycles} cycles")
            continue
        worst = {"sleep_ms": min(worst["sleep_ms"], sleep_ms),
                 "issue_ms": max(worst["issue_ms"], issue_ms), "batches": worst["batches"] + 1}
        for side, (start, end) in zip(sides, pairs):
            times[side].append(start.elapsed_time(end))
    return [float(np.median(t)) for t in times], worst


def _median_pair_ms(fn_a, fn_b, n: int = MEDIAN_N) -> tuple:
    """Issue-inclusive median ms of ``n`` single calls each of ``fn_a()``
    and ``fn_b()``, alternating (a then b, then b then a), each call
    between its own two CUDA events, with no sleep ahead of them: a call
    shorter than its host issue time is timed with that issue time. After
    one warm-up call of each."""
    fn_a()
    fn_b()
    runs = []
    torch.cuda.synchronize()
    for i in range(n):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            start, end = _event(), _event()
            start.record()
            (fn_a if side == 0 else fn_b)()
            end.record()
            runs.append((side, start, end))
    torch.cuda.synchronize()
    times = ([], [])
    for side, start, end in runs:
        times[side].append(start.elapsed_time(end))
    return float(np.median(times[0])), float(np.median(times[1]))


def _host_issue_ms(fn, n: int = MEDIAN_N) -> float:
    """Host ms to issue one call of ``fn()``: the host clock around ``n``
    calls without a synchronise, over ``n``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e3 / n


def _us(ms) -> str:
    return f"{ms * 1e3:.2f} us"


def timings(what, kernel, library, name, floor_ms) -> dict:
    """``kernel()`` against ``library()`` four ways (the module's
    docstring), printed and returned."""
    (k_ms, l_ms), batch = device_medians([kernel, library])
    k_issue, l_issue = _median_pair_ms(kernel, library)
    k_host, l_host = _host_issue_ms(kernel), _host_issue_ms(library)
    slower = "kernel" if k_ms > l_ms else name
    print(f"{what}: device-only median of {MEDIAN_N} single launches each, alternating: kernel "
          f"{_us(k_ms)}, {name} {_us(l_ms)}; the {slower} is slower "
          f"({max(k_ms, l_ms) / min(k_ms, l_ms):.3f}x); launch floor {_us(floor_ms)} "
          f"({batch['batches']} batches, host issue of a batch at most {batch['issue_ms']:.2f} ms "
          f"behind a sleep of at least {batch['sleep_ms']:.2f} ms)")
    print(f"{what}: issue-inclusive median (no sleep): kernel {_us(k_issue)}, {name} "
          f"{_us(l_issue)}; host issue per call: kernel {_us(k_host)}, {name} {_us(l_host)}")
    return {"ms": k_ms, "library_ms": l_ms, "issue_ms": k_issue, "library_issue_ms": l_issue,
            "host_issue_ms": k_host, "library_host_issue_ms": l_host, "floor_ms": floor_ms}


def _equal(name, a, b):
    if not torch.equal(a, b):
        raise RuntimeError(f"{name}: max |difference| {(a - b).abs().max().item():.3g}")


def against(what, other, this, args) -> list:
    """``other`` (another tree's wrapper) held to ``this``'s output on
    ``args``, then both timed device-only in turns (other, this, this,
    other, ...); returns [other ms, this ms]."""
    _equal(f"{what}: other vs this", other(*args), this(*args))
    (o_ms, t_ms), _ = device_medians([lambda: other(*args), lambda: this(*args)])
    print(f"A/B {what}, device-only median of {MEDIAN_N} each, in turns: other {_us(o_ms)}, "
          f"this {_us(t_ms)}; other / this {o_ms / t_ms:.3f}x")
    return [o_ms, t_ms]


def launch_floor(device) -> float:
    """The device-only median of the empty kernel."""
    (ms,), _ = device_medians([lambda: empty_cuda(device)])
    print(f"launch floor: empty kernel, device-only median of {MEDIAN_N} launches {_us(ms)}")
    return ms


def run_rows(device, seed: int = 0, floor_ms: float = 0.0, others=()) -> dict:
    """The row probe: the kernel against plain and library, then the three
    timed alone and in the dependent chain; each of ``others`` held to the
    kernel and timed beside it."""
    table, idx = row_inputs(seed, device)
    k = row_gather_cuda(table, idx)
    _equal("row gather kernel vs plain", k, row_gather_plain(table, idx))
    _equal("row gather kernel vs index_select", k, torch.index_select(table, 0, idx))
    c_k = chain(row_gather_cuda, table, idx)
    _equal("row chain kernel vs index_select", c_k,
           chain(lambda t, c: torch.index_select(t, 0, c), table, idx))
    library = lambda t, c: torch.index_select(t, 0, c)  # noqa: E731
    nbytes = N_INDICES * (2 * ROW_W * 4 + 4)
    res = {"rows": N_INDICES, "bytes": nbytes, "max_abs_err": 0.0}
    t = timings(f"row gather ({N_INDICES} rows)", lambda: row_gather_cuda(table, idx),
                lambda: library(table, idx), "index_select", floor_ms)
    (plain_ms,), _ = device_medians([lambda: row_gather_plain(table, idx)])
    (ck, cp, cl), _ = device_medians([lambda: chain(row_gather_cuda, table, idx),
                                      lambda: chain(row_gather_plain, table, idx),
                                      lambda: chain(library, table, idx)], CHAIN_N)
    res["kernel"] = {**t, "chain_ms": ck / CHAIN}
    res["plain"] = {"ms": plain_ms, "chain_ms": cp / CHAIN}
    res["library"] = {"ms": t["library_ms"], "chain_ms": cl / CHAIN}
    for name in ("kernel", "plain", "library"):
        ms, chain_ms = res[name]["ms"], res[name]["chain_ms"]
        print(f"row gather {name}: {_us(ms)} per {N_INDICES}-row gather (device-only median) "
              f"({N_INDICES / ms / 1e3:.1f}M rows/s, {nbytes / ms / 1e6:.1f} GB/s); in the chain "
              f"of {CHAIN} (device-only median of {CHAIN_N}): {_us(chain_ms)} per gather "
              f"({N_INDICES / chain_ms / 1e3:.1f}M rows/s)")
    res["others"] = {}
    for other in others:
        _equal(f"row chain {other.label} vs this", chain(other.row, table, idx), c_k)
        res["others"][other.label] = {
            "ms": against(f"row gather vs {other.label}", other.row, row_gather_cuda, (table, idx)),
            "chain_ms": [v / CHAIN for v in against(
                f"row chain of {CHAIN} vs {other.label}", lambda t, i: chain(other.row, t, i),
                lambda t, i: chain(row_gather_cuda, t, i), (table, idx))]}
    return res


def run_tiles(device, seed: int = 0, floor_ms: float = 0.0, others=()) -> dict:
    """The in-tile probe at each shape: kernel, plain and library equal at
    1 and 16 gathers; times and the marginal cost of a gather; each of
    ``others`` held to the kernel and timed beside it at 1 and 16."""
    cases = ([("sublane", (m, 128), 0) for m in SUBLANE_M] + [("lane", (8, m), 1) for m in LANE_M]
             + [("sublane wave", WAVE, 0)])
    res = {}
    for tag, shape, axis in cases:
        x, idx = tile_inputs(seed, shape, axis, device)
        for reps in (1, REPS):
            k = tile_gather_cuda(x, idx, axis, reps)
            _equal(f"{tag} {shape} x{reps} kernel vs plain", k, tile_gather_plain(x, idx, axis, reps))
            _equal(f"{tag} {shape} x{reps} kernel vs library", k, tile_gather_library(x, idx, axis, reps))
        label = f"{tag} {shape}"
        t = timings(f"{label} 1-gather", lambda: tile_gather_cuda(x, idx, axis, 1),
                    lambda: tile_gather_library(x, idx, axis, 1), "torch.gather", floor_ms)
        (k16, l16), _ = device_medians([lambda: tile_gather_cuda(x, idx, axis, REPS),
                                        lambda: tile_gather_library(x, idx, axis, REPS)])
        (plain_ms,), _ = device_medians([lambda: tile_gather_plain(x, idx, axis, 1)])
        lanes = shape[0] * shape[1]
        marg, lib_marg = (k16 - t["ms"]) / (REPS - 1), (l16 - t["library_ms"]) / (REPS - 1)
        res[label] = {"shape": shape, "axis": axis, "lanes": lanes, "bytes": 3 * lanes * 4,
                      **t, "plain_ms": plain_ms, "ms_16": k16, "library_ms_16": l16,
                      "marginal_ms": marg, "library_marginal_ms": lib_marg, "others": {}}
        print(f"{tag:13s} shape={str(shape):12s} M={shape[axis]:5d} (device-only medians): kernel "
              f"1-gather {_us(t['ms'])}, {REPS}-gather {_us(k16)}, marginal {marg * 1e3:.3f} us "
              f"({lanes / max(marg, 1e-9) / 1e6:.2f} Gelem/s); torch.gather 1-gather "
              f"{_us(t['library_ms'])}, marginal {lib_marg * 1e3:.3f} us "
              f"({lanes / max(lib_marg, 1e-9) / 1e6:.2f} Gelem/s); plain 1-gather {_us(plain_ms)}; "
              f"all equal")
        for other in others:
            res[label]["others"][other.label] = {reps: against(
                f"{label} {reps}-gather vs {other.label}", other.tile, tile_gather_cuda,
                (x, idx, axis, reps)) for reps in (1, REPS)}
    return res


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--parent", type=Path, nargs="*", default=[],
                   help="csrc directories of other trees: their probe kernels timed beside these")
    args = p.parse_args(argv)
    return run(args.seed, [load_other(d) for d in args.parent] if args.parent else ())


def run(seed: int = 0, others=()) -> dict:
    """Both probes on the card (raises without one), with ``others``
    (`other_probe`) beside them; prints a summary JSON line."""
    if not torch.cuda.is_available():
        raise RuntimeError("the gather probes measure the card: torch.cuda.is_available() is False")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(f"device: {torch.cuda.get_device_name(dev)}")
    floor_ms = launch_floor(dev)
    out = {"floor_ms": floor_ms, "rows": run_rows(dev, seed, floor_ms, others),
           "tiles": run_tiles(dev, seed, floor_ms, others)}
    r, w = out["rows"], out["tiles"][f"sublane wave {WAVE}"]
    print(json.dumps({
        "floor_us": floor_ms * 1e3,
        "row_gather_us": r["kernel"]["ms"] * 1e3, "index_select_us": r["library"]["ms"] * 1e3,
        "row_gather_issue_us": r["kernel"]["issue_ms"] * 1e3,
        "index_select_issue_us": r["kernel"]["library_issue_ms"] * 1e3,
        "row_gather_host_issue_us": r["kernel"]["host_issue_ms"] * 1e3,
        "index_select_host_issue_us": r["kernel"]["library_host_issue_ms"] * 1e3,
        "row_gather_chain_us": r["kernel"]["chain_ms"] * 1e3,
        "index_select_chain_us": r["library"]["chain_ms"] * 1e3,
        "wave_tile_gather_us": w["ms"] * 1e3, "wave_torch_gather_us": w["library_ms"] * 1e3,
        "wave_tile_gather_issue_us": w["issue_ms"] * 1e3,
        "wave_torch_gather_issue_us": w["library_issue_ms"] * 1e3}))
    return out


if __name__ == "__main__":
    main()
