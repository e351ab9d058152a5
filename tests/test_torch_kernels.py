"""The CUDA kernels of ``path_tracer_tpu_torch/csrc/dense_hit.cu`` against
their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs on a machine that has only the port's
dependencies (``tests/conftest.py`` imports jax; skip it there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The kernels are built with ``-fmad=false`` and evaluate the plain versions'
expressions in the same order, so the comparisons are exact.
"""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.trace import dense_cuda as dc


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.fixture
def case(cuda):
    """A 700-triangle table and 512 rays with inf / 0 / finite limits and
    NaN origins and directions, on the card."""
    rng = np.random.default_rng(7)
    t = 700
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    pos = np.stack([v0, v0 + rng.uniform(-0.3, 0.3, (t, 3)), v0 + rng.uniform(-0.3, 0.3, (t, 3))], 1)
    pos = pos.astype(np.float32)
    aux = dc.pack_dense_aux(tri_mod.precompute(pos), rng.normal(size=(t, 9)), rng.integers(0, 5, t))
    n = 512
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tl = rng.uniform(0.0, 3.0, n).astype(np.float32)
    tl[:64] = 3.0e38
    tl[64:96] = 0.0
    o[96:104] = np.nan
    d[104:112] = np.nan
    return [torch.from_numpy(x).to(cuda) for x in (aux, o, d, tl)]


def test_closest_kernel_equals_plain(case):
    n0 = dc.LAUNCHES["closest"]
    k = dc.closest_cuda(*case)
    assert dc.LAUNCHES["closest"] == n0 + 1
    p = dc.closest_plain(*case)
    assert (k[:, 1] >= 0).sum() > 50
    finite = torch.isfinite(p).all(dim=1)  # a NaN ray's epilogue is NaN in both
    assert torch.equal(k[finite], p[finite])
    assert torch.equal(torch.isfinite(k).all(dim=1), finite)
    assert (k[96:112, 1] == -1).all()


def test_any_kernel_equals_plain(case):
    n0 = dc.LAUNCHES["any"]
    k = dc.any_cuda(*case)
    assert dc.LAUNCHES["any"] == n0 + 1
    assert torch.equal(k, dc.any_plain(*case))
    assert 10 < int(k.sum()) < k.shape[0]
    assert not k[64:112].any()


def test_wrappers_on_card_equal_wrappers_on_cpu(case):
    """The public queries launch the kernels on CUDA tensors and give the
    same bits as the plain versions on CPU tensors."""
    aux, o, d, tl = case
    eng_gpu, eng_cpu = {"aux": aux}, {"aux": aux.cpu()}
    tl = torch.where(tl > 1e30, torch.inf, tl)
    n0 = dict(dc.LAUNCHES)
    gpu = dc.dense_closest_hit_shade(eng_gpu, o, d, tl)
    cpu = dc.dense_closest_hit_shade(eng_cpu, o.cpu(), d.cpu(), tl.cpu())
    ok = torch.isfinite(o).all(1) & torch.isfinite(d).all(1)
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu()[ok.cpu()], b[ok.cpu()])
    assert torch.equal(dc.dense_any_hit(eng_gpu, o, d, tl).cpu(), dc.dense_any_hit(eng_cpu, o.cpu(), d.cpu(), tl.cpu()))
    assert dc.LAUNCHES["closest"] == n0["closest"] + 1 and dc.LAUNCHES["any"] == n0["any"] + 1


def test_kernel_rejects_bad_inputs(case):
    aux, o, d, tl = case
    with pytest.raises(ValueError):
        dc.closest_cuda(aux, o.double(), d, tl)
    with pytest.raises(ValueError):
        dc.any_cuda(aux, o, d.t().contiguous().t(), tl)
    with pytest.raises(ValueError):
        dc.closest_cuda(aux[:, :12].contiguous(), o, d, tl)
