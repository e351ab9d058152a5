"""The gather probes' plain versions (``path_tracer_tpu_torch/probes/gather.py``)
against NumPy's ``take`` / ``take_along_axis``, the JAX probes' own check
(their Pallas kernels cannot run on the CPU), and the wrappers' CPU path.
The kernels against these plain versions run on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``)."""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.probes import gather
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES


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
