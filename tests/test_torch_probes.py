"""The gather probes' plain versions (``path_tracer_tpu_torch/probes/gather.py``)
against NumPy's ``take`` / ``take_along_axis`` and against the JAX probes
themselves (``benches/pallas_gather_probe.py::pallas_gather`` and
``benches/pallas_lane_gather_probe.py::probe``, their Pallas kernels run in
TPU interpret mode on the CPU), and the wrappers' CPU path. The kernels
against these plain versions run on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from path_tracer_tpu_torch.probes import gather
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES

BENCHES = Path(__file__).resolve().parent.parent / "benches"


def _bench(name):
    """A probe of ``benches/`` imported by its path (``benches`` is no package)."""
    spec = importlib.util.spec_from_file_location(f"_bench_{name}", BENCHES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_row_gather_plain_equals_numpy_take():
    table, idx = gather.row_inputs(3, "cpu")
    assert table.shape == (gather.TABLE_ROWS, gather.ROW_W) and idx.shape == (gather.N_INDICES,)
    n0 = dict(LAUNCHES)
    out = gather.row_gather(table, idx)
    assert LAUNCHES == n0  # CPU tensors take the plain version
    np.testing.assert_array_equal(out.numpy(), np.take(table.numpy(), idx.numpy(), axis=0))


def test_row_chain_equals_numpy():
    """The dependent chain of 20 gathers (``c = (c + rows[:, 0] + 1) % m``)."""
    table, idx = gather.row_inputs(4, "cpu")
    tn, c = table.numpy(), idx.numpy()
    for _ in range(gather.CHAIN):
        rows = np.take(tn, c, axis=0)
        c = ((c + rows[:, 0].astype(np.int32) + 1) % gather.TABLE_ROWS).astype(np.int32)
    out = gather.chain(gather.row_gather, table, idx)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), c)


@pytest.mark.parametrize("shape,axis", [((8, 128), 0), ((512, 128), 0), ((1024, 128), 0),
                                        ((8, 128), 1), ((8, 2048), 1), ((8, 8192), 1)])
@pytest.mark.parametrize("reps", [1, 16])
def test_tile_gather_plain_equals_numpy(shape, axis, reps):
    """Modes 0 and 1 at the probe's shapes, 1 and 16 gathers (gather k reads entry
    (index + k) mod M), summed in the probe's order; the library's
    ``torch.gather`` gives the same bits."""
    x, idx = gather.tile_inputs(5, shape, axis, "cpu")
    xn, m = x.numpy(), shape[axis]
    ref = np.zeros(shape, np.float32)
    for k in range(reps):
        ref = ref + np.take_along_axis(xn, (idx.numpy() + k) % m, axis=axis)
    n0 = dict(LAUNCHES)
    out = gather.tile_gather(x, idx, axis, reps)
    assert LAUNCHES == n0
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(gather.tile_gather_library(x, idx, axis, reps).numpy(), ref)


def test_probe_wrappers_reject_cpu_tensors_for_kernels():
    table, idx = gather.row_inputs(0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        gather.row_gather_cuda(table, idx)
    x, i = gather.tile_inputs(0, (8, 128), 0, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        gather.tile_gather_cuda(x, i, 0)


class _FakeCard:
    """A host clock and a device clock for `gather.device_medians`: each
    call costs ``host_ms`` to issue and 5 us on the device; a sleep of c
    cycles lasts c / 2e6 ms (2 GHz); an event records the device clock."""

    def __init__(self, host_ms):
        self.host_ms, self.host, self.dev = host_ms, 0.0, 0.0

    def event(self):
        card = self

        class Event:
            def record(self):
                self.t = card.dev

            def elapsed_time(self, other):
                return other.t - self.t

        return Event()

    def sleep(self, cycles):
        self.dev += cycles / 2e6

    def call(self):
        self.host += self.host_ms
        self.dev += 0.005

    def patch(self, monkeypatch):
        monkeypatch.setattr(gather, "_event", self.event)
        monkeypatch.setattr(gather, "time", SimpleNamespace(perf_counter=lambda: self.host / 1e3))
        monkeypatch.setattr(torch.cuda, "_sleep", self.sleep)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


def test_device_medians_lengthens_the_sleep_for_a_slow_round(monkeypatch):
    # One round takes 41 ms to issue, over the 20 ms sleep: the sleep doubles
    # until it covers the round, and every kept pair brackets device work only.
    card = _FakeCard(41.0)
    card.patch(monkeypatch)
    (ms,), worst = gather.device_medians([card.call], 3)
    assert ms == pytest.approx(0.005)
    assert worst["batches"] == 3 and worst["issue_ms"] < worst["sleep_ms"] == pytest.approx(80.0)


def test_device_medians_raises_past_the_longest_sleep(monkeypatch):
    card = _FakeCard(1000.0)
    card.patch(monkeypatch)
    longest = gather.MAX_SLEEP_CYCLES / 2e6
    with pytest.raises(RuntimeError, match=f"over the {longest:.2f} ms sleep"):
        gather.device_medians([card.call], 3)


def test_row_gather_plain_equals_jax_probe():
    """``pallas_gather`` (its row-DMA pipeline in interpret mode) on a
    [1024, 128] table and 64 indices: the plain version's bits."""
    probe = _bench("pallas_gather_probe")
    rng = np.random.default_rng(6)
    table = rng.standard_normal((1024, gather.ROW_W)).astype(np.float32)
    idx = rng.integers(0, 1024, 64).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.pallas_gather(table, idx))
    out = gather.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("shape,axis", [((512, 128), 0), ((8, 2048), 1)])
@pytest.mark.parametrize("reps", [1, 16])
def test_tile_gather_plain_equals_jax_probe(shape, axis, reps):
    """``probe`` (the in-tile ``take_along_axis`` kernel, interpret mode)
    at the wave and a lane tile, 1 and 16 gathers: the plain version's
    bits. Only where M >= reps: the JAX probe subtracts M from an index
    once, the port takes it mod M, the same there."""
    assert shape[axis] >= reps
    probe = _bench("pallas_lane_gather_probe")
    x, idx = gather.tile_inputs(7, shape, axis, "cpu")
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(probe.probe(x.numpy(), idx.numpy(), axis=axis, reps=reps))
    np.testing.assert_array_equal(gather.tile_gather(x, idx, axis, reps).numpy(), ref)
