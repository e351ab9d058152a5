"""The CUDA kernels of ``path_tracer_tpu_torch/csrc/dense_hit.cu``,
``walk_hit.cu``, ``iwalk_hit.cu``, ``dense_stream.cu`` and
``gather_probe.cu`` against their plain torch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
nothing of JAX, so it runs on a machine that has only the port's
dependencies (``tests/conftest.py`` imports jax; skip it there):

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The kernels are built with ``-fmad=false`` and evaluate the plain versions'
expressions in the same order, so the comparisons are exact.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch import scenes
from path_tracer_tpu_torch.probes import gather
from path_tracer_tpu_torch.scene import procedural
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.model import Model, rigid_transform, rotation_y
from path_tracer_tpu_torch.scene.bvh import build_bvh
from path_tracer_tpu_torch.trace import bvh_stack
from path_tracer_tpu_torch.trace import dense_cuda as dc
from path_tracer_tpu_torch.trace import dense_stream as ds
from path_tracer_tpu_torch.trace import iwalk
from path_tracer_tpu_torch.trace import walk


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.fixture
def case(cuda):
    """A 700-triangle table (6 chunks of 128) and 512 rays with inf / 0 /
    finite limits and NaN origins and directions, on the card: ``(table,
    origin, direction, t_limit)``."""
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
    eng = {"aux": torch.from_numpy(aux).to(cuda), "cab": torch.from_numpy(dc.pack_dense_cab(pos)).to(cuda)}
    return [eng] + [torch.from_numpy(x).to(cuda) for x in (o, d, tl)]


def test_closest_kernel_equals_plain(case):
    eng, o, d, tl = case
    n0 = dc.LAUNCHES["closest"]
    k = dc.closest_cuda(eng, o, d, tl)
    assert dc.LAUNCHES["closest"] == n0 + 1
    p = dc.closest_plain(eng["aux"], o, d, tl)
    assert (k[:, 1] >= 0).sum() > 50
    finite = torch.isfinite(p).all(dim=1)  # a NaN ray's epilogue is NaN in both
    assert torch.equal(k[finite], p[finite])
    assert torch.equal(torch.isfinite(k).all(dim=1), finite)
    assert (k[96:112, 1] == -1).all()


def test_any_kernel_equals_plain(case):
    eng, o, d, tl = case
    n0 = dc.LAUNCHES["any"]
    k = dc.any_cuda(eng, o, d, tl)
    assert dc.LAUNCHES["any"] == n0 + 1
    assert torch.equal(k, dc.any_plain(eng["aux"], o, d, tl))
    assert 10 < int(k.sum()) < k.shape[0]
    assert not k[64:112].any()


def test_wrappers_on_card_equal_wrappers_on_cpu(case):
    """The public queries launch the kernels on CUDA tensors and give the
    same bits as the plain versions on CPU tensors."""
    eng_gpu, o, d, tl = case
    eng_cpu = {k: v.cpu() for k, v in eng_gpu.items()}
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
    eng, o, d, tl = case
    with pytest.raises(ValueError):
        dc.closest_cuda(eng, o.double(), d, tl)
    with pytest.raises(ValueError):
        dc.any_cuda(eng, o, d.t().contiguous().t(), tl)
    with pytest.raises(ValueError):
        dc.closest_cuda({**eng, "aux": eng["aux"][:, :12].contiguous()}, o, d, tl)
    with pytest.raises(ValueError, match="cab"):
        dc.closest_cuda({"aux": eng["aux"]}, o, d, tl)
    with pytest.raises(ValueError):
        dc.any_cuda({**eng, "cab": eng["cab"][:-1].contiguous()}, o, d, tl)
    with pytest.raises(ValueError):
        dc.closest_cuda(eng, o, d, tl, stats=torch.zeros(dc.NSTATS - 1, dtype=torch.int64, device=o.device))


@pytest.fixture
def mesh_case(cuda):
    """``mesh_scene(subdivisions=3)``'s dense world table (1,292 rows in
    SAH order, 11 chunks) and 4,096 rays from inside the Cornell box."""
    sh, _ = scenes.mesh_scene(subdivisions=3)
    eng = sh.device(cuda)["tri"]["dense"]
    rng = np.random.default_rng(5)
    n = 4096
    o = rng.uniform((-278, 0, -278), (278, 555, 278), (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tl = np.full(n, 3.0e38, np.float32)
    return eng, *(torch.from_numpy(x).to(cuda) for x in (o, d, tl))


def test_dense_edge_cases_equal_plain(mesh_case):
    """The dense kernels' segment cull on its edge cases: both queries equal
    the ungated plain versions and the plain models of the cull."""
    eng, o, d, tl = mesh_case
    k = dc.closest_cuda(eng, o, d, tl)
    lo, hi = eng["cab"][:, 0:3], eng["cab"][:, 3:6]
    root = {"root_lo": lo.amin(0), "root_hi": hi.amax(0)}
    eo, ed, et = _edge_rays(root, lo, hi, k[:, 0], k[:, 1].long(), o, d, tl, 23)
    aux = eng["aux"]
    ka, pa = dc.any_cuda(eng, eo, ed, et), dc.any_plain(aux, eo, ed, et)
    assert 0.1 < pa.float().mean() < 0.95
    assert torch.equal(ka, pa) and torch.equal(dc.culled_any_plain(eng, eo, ed, et), pa)
    kc, pc = dc.closest_cuda(eng, eo, ed, et), dc.closest_plain(aux, eo, ed, et)
    assert torch.equal(kc, pc) and torch.equal(dc.culled_closest_plain(eng, eo, ed, et), pc)


def test_dense_closest_ties_equal_plain(cuda):
    """``dense_cuda.tie_soup``: every ray's closest hit is one triangle held
    in chunks 7 and 15 (twice in chunk 7); the kernel picks the lowest
    index, as the plain version does, and its t."""
    pos, o, d = dc.tie_soup()
    eng = {"aux": torch.from_numpy(dc.pack_dense_aux(tri_mod.precompute(pos))).to(cuda),
           "cab": torch.from_numpy(dc.pack_dense_cab(pos)).to(cuda)}
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    tl = torch.full((o.shape[0],), 3.0e38, device=cuda)
    k, p = dc.closest_cuda(eng, o, d, tl), dc.closest_plain(eng["aux"], o, d, tl)
    assert torch.equal(k, p) and bool((k[:, 1] == dc.TIE_ROWS[0]).all())


@pytest.fixture(params=["asset_scene", "full_table"])
def wide_case(cuda, request, monkeypatch):
    """Dense tables above 64 chunks, where the kernels' chunk mask uses its
    words 2 and 3: ``assets/asset_scene.json``'s world table (13,832 rows,
    109 chunks) and a full table of 16,384 random triangles sorted along x
    (128 chunks); 4,096 rays from inside the box with inf / 0 / finite
    limits and NaN origins and directions: ``(table, origin, direction,
    t_limit)``."""
    from path_tracer_tpu_torch.utils import config

    rng = np.random.default_rng(11)
    if request.param == "asset_scene":
        monkeypatch.chdir(Path(__file__).resolve().parent.parent)  # the scene's paths
        eng = config.load_scene_json("assets/asset_scene.json").device(cuda)["tri"]["dense"]
        lo, hi = (-278, 0, -278), (278, 555, 278)
    else:
        t = dc.DENSE_MAX_TRIS
        v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
        v0 = v0[np.argsort(v0[:, 0])]
        pos = np.stack([v0, v0 + rng.uniform(-0.05, 0.05, (t, 3)),
                        v0 + rng.uniform(-0.05, 0.05, (t, 3))], 1).astype(np.float32)
        aux = dc.pack_dense_aux(tri_mod.precompute(pos), rng.normal(size=(t, 9)),
                                rng.integers(0, 5, t))
        eng = {"aux": torch.from_numpy(aux).to(cuda),
               "cab": torch.from_numpy(dc.pack_dense_cab(pos)).to(cuda)}
        lo, hi = (-1.2, -1.2, -1.2), (1.2, 1.2, 1.2)
    assert eng["cab"].shape[0] > 64
    n = 4096
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tl = np.full(n, 3.0e38, np.float32)
    tl[:256] = 0.0
    tl[256:512] = rng.uniform(0.0, 2.0 * max(hi), 256)
    o[512:544] = np.nan
    d[544:576] = np.nan
    return eng, *(torch.from_numpy(x).to(cuda) for x in (o, d, tl))


def test_wide_table_kernels_equal_plain(wide_case):
    """Above 64 chunks, both kernels equal the plain versions on every ray
    (closest: every column of the rays with finite inputs) and on the cull's
    edge cases, which start rays on the faces of every chunk's box."""
    eng, o, d, tl = wide_case
    aux = eng["aux"]
    k, p = dc.closest_cuda(eng, o, d, tl), dc.closest_plain(aux, o, d, tl)
    finite = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    assert (p[:, 1] >= 0).sum() > 1000 and (p[finite, 1] >= 64 * dc.CH).sum() > 50
    assert torch.equal(k[finite], p[finite]) and (k[~finite, 1] == -1).all()
    ka = dc.any_cuda(eng, o, d, tl)
    assert torch.equal(ka, dc.any_plain(aux, o, d, tl)) and not ka[:256].any()
    lo, hi = eng["cab"][:, 0:3], eng["cab"][:, 3:6]
    root = {"root_lo": lo.amin(0), "root_hi": hi.amax(0)}
    ks = torch.where(finite & (tl > 0), k[:, 1], -1.0).long()
    eo, ed, et = _edge_rays(root, lo, hi, k[:, 0], ks, o, d, tl, 29)
    assert torch.equal(dc.any_cuda(eng, eo, ed, et), dc.any_plain(aux, eo, ed, et))
    assert torch.equal(dc.closest_cuda(eng, eo, ed, et), dc.closest_plain(aux, eo, ed, et))


def test_dense_stats_counts(mesh_case):
    """The counters: blocks and lanes, entered boxes, staged chunks, listed
    lanes and pairs, consistent with each other; the closest hit tests
    fewer pairs than every row; counting does not change the results."""
    eng, o, d, tl = mesh_case
    nt, k = eng["aux"].shape[0], eng["cab"].shape[0]
    for query in ("closest", "any"):
        st = dc.dense_stats(eng, o, d, tl if query == "closest" else tl.clamp(max=300.0), query)
        assert st["blocks"] == o.shape[0] // 128 and st["lanes"] == o.shape[0]
        assert 0 < st["staged"] <= st["blocks"] * k
        assert st["listed"] <= st["entered"] <= st["lanes"] * k
        assert 0 < st["pairs"] <= st["listed"] * dc.CH and st["pairs"] <= st["lanes"] * nt
        if query == "closest":
            assert st["pairs"] < 0.5 * st["lanes"] * nt
    stats = torch.zeros(dc.NSTATS, dtype=torch.int64, device=o.device)
    assert torch.equal(dc.closest_cuda(eng, o, d, tl, stats=stats), dc.closest_cuda(eng, o, d, tl))


@pytest.fixture
def walk_case(cuda):
    """The walk tables of a 9,248-triangle bumpy sphere and 1,024 rays (half
    aimed at it from outside, half from inside) with dead, finite-limit and
    NaN lanes, sorted and clamped as the public query hands them to the
    kernels."""
    rng = np.random.default_rng(11)
    pos, nrm = procedural.bumpy_sphere(nu=68, nv=68)
    model = rng.integers(0, 5, pos.shape[0])
    tables = walk.pack_walk(tri_mod.precompute(pos), nrm.reshape(-1, 9), model, pos)
    eng = {k: torch.from_numpy(v).to(cuda) for k, v in tables.items()}
    n = 1024
    o1 = rng.normal(size=(n // 2, 3))
    o1 = 3.0 * o1 / np.linalg.norm(o1, axis=1, keepdims=True)
    o = np.concatenate([o1, rng.uniform(-1, 1, (n // 2, 3))]).astype(np.float32)
    d = np.concatenate([-o1 + 0.15 * rng.normal(size=(n // 2, 3)), rng.normal(size=(n // 2, 3))])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.full(n, np.inf, np.float32)
    tl[:64] = 0.0
    tl[64:128] = rng.uniform(0.5, 3.0, 64)
    o[128:136] = np.nan
    d[136:144] = np.nan
    o, d, tl = (torch.from_numpy(x).to(cuda) for x in (o, d, tl))
    _, o_s, d_s, tl_s = walk._sorted_rays(eng, o, d, tl)
    return eng, (o, d, tl), (o_s, d_s, tl_s)


def test_walk_closest_kernel_equals_plain(walk_case):
    eng, _, rays = walk_case
    n0 = dc.LAUNCHES["walk_closest"]
    kt, ks = walk.closest_cuda(eng, *rays)
    assert dc.LAUNCHES["walk_closest"] == n0 + 1
    pt, ps = walk.closest_plain(eng, *rays)
    assert (ks >= 0).sum() > 300
    assert torch.equal(ks, ps) and torch.equal(kt, pt)
    dead = ~walk._valid(*rays)
    assert (ks[dead] == -1).all()


def test_walk_any_kernel_equals_plain(walk_case):
    eng, _, (o, d, tl) = walk_case
    kt, ks = walk.closest_cuda(eng, o, d, tl)
    for scale in (0.99, 1.01):
        lim = torch.where(ks >= 0, kt * scale, tl).contiguous()
        n0 = dc.LAUNCHES["walk_any"]
        k = walk.any_cuda(eng, o, d, lim)
        assert dc.LAUNCHES["walk_any"] == n0 + 1
        assert torch.equal(k, walk.any_plain(eng, o, d, lim))
        hit = ks >= 0
        assert bool(k[hit].all()) if scale > 1 else not bool(k[hit].any())
    assert not walk.any_cuda(eng, o, d, tl)[~walk._valid(o, d, tl)].any()


def test_walk_queries_on_card_equal_cpu(walk_case):
    """The public walk queries launch the kernels on CUDA tensors and give
    the same bits as the plain versions on CPU tensors."""
    eng, (o, d, tl), _ = walk_case
    eng_cpu = {k: v.cpu() for k, v in eng.items()}
    n0 = dict(dc.LAUNCHES)
    gpu = walk.walk_closest_hit_shade(eng, o, d, tl)
    cpu = walk.walk_closest_hit_shade(eng_cpu, o.cpu(), d.cpu(), tl.cpu())
    ok = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1)).cpu()
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu()[ok], b[ok])
    assert torch.equal(walk.walk_any_hit(eng, o, d, tl).cpu(),
                       walk.walk_any_hit(eng_cpu, o.cpu(), d.cpu(), tl.cpu()))
    assert dc.LAUNCHES["walk_closest"] == n0["walk_closest"] + 1
    assert dc.LAUNCHES["walk_any"] == n0["walk_any"] + 1


def test_walk_kernel_rejects_bad_inputs(walk_case):
    eng, _, (o, d, tl) = walk_case
    with pytest.raises(ValueError):
        walk.closest_cuda(eng, o.double(), d, tl)
    with pytest.raises(ValueError):
        walk.any_cuda(eng, o, d.t().contiguous().t(), tl)
    with pytest.raises(ValueError):
        walk.closest_cuda({**eng, "ord_oct": eng["ord_oct"].long()}, o, d, tl)
    with pytest.raises(ValueError):
        walk.any_cuda({**eng, "aux": eng["aux"][:-1].contiguous()}, o, d, tl)


def test_walk_stats_counts(walk_case):
    """The counters of both walk kernels: live blocks, visits, lanes testing
    a staged chunk (at most 128 per staging), staged and distinct chunks;
    both stage at most their visits (the lanes' segment cull) and test at
    least one pair per hit lane; the results of a counted launch equal an
    uncounted one's."""
    eng, (o, d, tl), (o_s, d_s, tl_s) = walk_case
    k = walk.num_chunks(eng)
    for query in ("closest", "any"):
        s = walk.walk_stats(eng, o, d, tl, query=query)
        assert 0 < s["blocks"] <= 8 and 0 < s["chunks"] <= k
        assert s["staged"] >= s["chunks"] and 0 < s["lane_visits"] <= 128 * s["staged"]
        if query == "closest":
            hits = int((walk.walk_closest_hit_shade(eng, o, d, tl)[0] >= 0).sum())
        else:
            hits = int(walk.walk_any_hit(eng, o, d, tl).sum())
        assert s["staged"] <= s["visits"] and hits <= s["pairs"] <= 128 * s["lane_visits"]
    stats = torch.zeros(walk.NSTATS + k, dtype=torch.int64, device=o.device)
    assert all(torch.equal(a, b) for a, b in zip(walk.closest_cuda(eng, o_s, d_s, tl_s, stats=stats),
                                                 walk.closest_cuda(eng, o_s, d_s, tl_s)))
    with pytest.raises(ValueError):
        walk.closest_cuda(eng, o_s, d_s, tl_s, stats=stats[:-1])


@pytest.fixture(params=["vwalk", "iwalk"])
def iwalk_case(request, cuda):
    """A two-level engine (vwalk or iwalk) over three instances of a
    3,200-triangle bumpy sphere and two of a box (tests/test_iwalk.py's
    models), and 1,024 rays toward them with dead, finite-limit and NaN
    lanes, sorted and clamped as the public query hands them to the
    kernels."""
    rng = np.random.default_rng(13)
    sp, sn = procedural.bumpy_sphere(nu=40, nv=40)
    bp, bn = procedural.box((0.0, 0.0, 0.0), (0.6, 0.6, 0.6))
    models = [
        Model(None, matrices=[rigid_transform(rotation_y(a), t) for a, t in (
            (0.5, (-2.0, 0.0, 0.0)), (1.7, (2.0, 0.3, 0.5)), (2.9, (0.0, -0.4, -2.0)))],
            positions=sp, normals=sn),
        Model(None, matrices=[rigid_transform(rotation_y(a), t) for a, t in (
            (0.9, (0.0, 1.8, 0.0)), (2.1, (0.0, 0.0, 2.2)))], positions=bp, normals=bn),
    ]
    pack = iwalk.pack_vwalk if request.param == "vwalk" else iwalk.pack_iwalk
    eng = iwalk.upload(pack(models), cuda)
    n = 1024
    o = rng.normal(size=(n, 3))
    o = (6.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = -o + 0.6 * rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.full(n, np.inf, np.float32)
    tl[:64] = 0.0
    tl[64:128] = rng.uniform(3.0, 6.0, 64)
    o[128:136] = np.nan
    d[136:144] = np.nan
    o, d, tl = (torch.from_numpy(x).to(cuda) for x in (o, d, tl))
    _, o_s, d_s, tl_s = walk._sorted_rays(eng, o, d, tl)
    return eng, (o, d, tl), (o_s, d_s, tl_s)


def test_two_level_closest_kernel_equals_plain(iwalk_case):
    eng, _, rays = iwalk_case
    key = f"{iwalk.engine_name(eng)}_closest"
    n0 = dc.LAUNCHES[key]
    k = iwalk.closest_cuda(eng, *rays)
    assert dc.LAUNCHES[key] == n0 + 1
    p = iwalk.closest_plain(eng, *rays)
    assert (k[1] >= 0).sum() > 300
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    dead = ~walk._valid(*rays)
    assert (k[1][dead] == -1).all() and (k[2][dead] == -1).all()


def test_two_level_any_kernel_equals_plain(iwalk_case):
    eng, _, (o, d, tl) = iwalk_case
    key = f"{iwalk.engine_name(eng)}_any"
    kt, ks, _ = iwalk.closest_cuda(eng, o, d, tl)
    for scale in (0.99, 1.01):
        lim = torch.where(ks >= 0, kt * scale, tl).contiguous()
        n0 = dc.LAUNCHES[key]
        k = iwalk.any_cuda(eng, o, d, lim)
        assert dc.LAUNCHES[key] == n0 + 1
        assert torch.equal(k, iwalk.any_plain(eng, o, d, lim))
        hit = ks >= 0
        assert bool(k[hit].all()) if scale > 1 else not bool(k[hit].any())
    assert not iwalk.any_cuda(eng, o, d, tl)[~walk._valid(o, d, tl)].any()


def test_two_level_queries_on_card_equal_cpu(iwalk_case):
    """The public two-level queries launch the kernels on CUDA tensors and
    give the same bits as the plain versions on CPU tensors."""
    eng, (o, d, tl), _ = iwalk_case
    eng_cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in eng.items()}
    name = iwalk.engine_name(eng)
    n0 = dict(dc.LAUNCHES)
    gpu = iwalk.iwalk_closest_hit_shade(eng, o, d, tl)
    cpu = iwalk.iwalk_closest_hit_shade(eng_cpu, o.cpu(), d.cpu(), tl.cpu())
    ok = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1)).cpu()
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu()[ok], b[ok])
    assert torch.equal(iwalk.iwalk_any_hit(eng, o, d, tl).cpu(),
                       iwalk.iwalk_any_hit(eng_cpu, o.cpu(), d.cpu(), tl.cpu()))
    assert dc.LAUNCHES[f"{name}_closest"] == n0[f"{name}_closest"] + 1
    assert dc.LAUNCHES[f"{name}_any"] == n0[f"{name}_any"] + 1


def test_two_level_kernel_rejects_bad_inputs(iwalk_case):
    eng, _, (o, d, tl) = iwalk_case
    with pytest.raises(ValueError):
        iwalk.closest_cuda(eng, o.double(), d, tl)
    with pytest.raises(ValueError):
        iwalk.any_cuda(eng, o, d.t().contiguous().t(), tl)
    with pytest.raises(ValueError):
        iwalk.closest_cuda({**eng, "inst_f": eng["inst_f"][:, :9].contiguous()}, o, d, tl)
    with pytest.raises(ValueError):
        iwalk.any_cuda({**eng, "gates": eng["ord_oct"].shape[1] + 1}, o, d, tl)
    with pytest.raises(ValueError):
        iwalk.any_cuda({k: v.cpu() if torch.is_tensor(v) else v for k, v in eng.items()}, o, d, tl)


def test_two_level_stats_counts(iwalk_case):
    """The counters of both two-level kernels: live blocks, gate entries
    admitted, staged chunks (at most one per admitted virtual chunk for
    vwalk, at most each admitted instance's chunks for iwalk, and at least
    the entries some lane entered), listed lanes per staging, pairs between
    the hits and 128 per listed lane; iwalk's (lane, instance), (lane,
    part) and (lane, chunk) box tests nest; a counted launch's results
    equal an uncounted one's."""
    eng, (o, d, tl), (o_s, d_s, tl_s) = iwalk_case
    vwalk = iwalk.engine_name(eng) == "vwalk"
    most = int((eng["inst_c"][:, 1] - eng["inst_c"][:, 0]).max()) if not vwalk else 1
    for query in ("closest", "any"):
        s = iwalk.iwalk_stats(eng, o, d, tl, query=query)
        assert 0 < s["blocks"] <= 8 and 0 < s["entries"] <= eng["gates"]
        assert 0 < s["lane_visits"] <= 128 * s["staged"]
        if query == "closest":
            hits = int((iwalk.iwalk_closest_hit_shade(eng, o, d, tl)[0] >= 0).sum())
        else:
            hits = int(iwalk.iwalk_any_hit(eng, o, d, tl).sum())
        assert s["entries"] <= s["staged"] <= most * s["visits"]
        assert hits <= s["pairs"] <= 128 * s["lane_visits"]
        if not vwalk:
            assert 0 < s["instances"] <= s["visits"] * 128 and s["lanes"] <= 1024
            assert s["chunks"] >= s["lane_visits"] and s["parts"] >= s["instances"] // 4
            assert s["chunks"] <= iwalk.PART_W * s["parts"]
    stats = torch.zeros(iwalk.num_stats(eng), dtype=torch.int64, device=o.device)
    assert all(torch.equal(a, b) for a, b in zip(iwalk.closest_cuda(eng, o_s, d_s, tl_s, stats=stats),
                                                 iwalk.closest_cuda(eng, o_s, d_s, tl_s)))
    with pytest.raises(ValueError):
        iwalk.closest_cuda(eng, o_s, d_s, tl_s, stats=stats[:-1])


def _edge_rays(eng, lo, hi, kt, ks, o, d, tl, seed):
    """The segment cull's edge cases on the rays of a case: axis-parallel
    rays, rays from and along chunk box faces, and limits one ulp either
    side of each hit ray's closest t (``kt``/``ks``: the closest hit of
    ``o, d``)."""
    g = torch.Generator(device=o.device).manual_seed(seed)
    n, dev = 512, o.device
    s_lo, s_hi = eng["root_lo"], eng["root_hi"]
    o_ax = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g, device=dev)
    d_ax = torch.zeros((n, 3), device=dev)
    d_ax[torch.arange(n, device=dev), torch.arange(n, device=dev) % 3] = 1.0 - 2.0 * (
        torch.arange(n, device=dev) % 2)
    c = torch.randint(0, lo.shape[0], (n,), generator=g, device=dev)
    a = torch.randint(0, 3, (n,), generator=g, device=dev)
    o_f = lo[c] + (hi[c] - lo[c]) * torch.rand((n, 3), generator=g, device=dev)
    o_f[torch.arange(n, device=dev), a] = torch.where(torch.arange(n, device=dev) % 2 == 0,
                                                      lo[c, a], hi[c, a])
    d_f = torch.randn((n, 3), generator=g, device=dev)
    along = torch.arange(n, device=dev) % 4 < 2
    d_f[along, a[along]] = 0.0
    d_f = d_f / d_f.norm(dim=1, keepdim=True)
    hit = (ks >= 0).nonzero()[:, 0]
    t = kt[hit]
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    down = torch.nextafter(t, torch.zeros_like(t))
    big = torch.full((n,), 3.0e38, device=dev)
    return (torch.cat([o_ax, o_f, o[hit], o[hit]]).contiguous(),
            torch.cat([d_ax, d_f, d[hit], d[hit]]).contiguous(),
            torch.cat([big, big, up, down]).contiguous())


def test_walk_any_edge_cases_equal_plain(walk_case):
    """The walk kernels' segment cull on its edge cases: both queries equal
    the ungated plain versions and the plain models of the cull."""
    eng, _, (o, d, tl) = walk_case
    kt, ks = walk.closest_cuda(eng, o, d, tl)
    eo, ed, et = _edge_rays(eng, *walk.chunk_boxes(eng), kt, ks, o, d, tl, 17)
    etc = walk._exit_clamp(eng, eo, ed, et).contiguous()
    k = walk.any_cuda(eng, eo, ed, etc)
    p = walk.any_plain(eng, eo, ed, etc)
    assert 0.1 < p.float().mean() < 0.9
    assert torch.equal(k, p) and torch.equal(walk.culled_any_plain(eng, eo, ed, etc), p)
    kc, pc = walk.closest_cuda(eng, eo, ed, etc), walk.closest_plain(eng, eo, ed, etc)
    assert all(torch.equal(a, b) for a, b in zip(kc, pc))
    assert all(torch.equal(a, b) for a, b in zip(walk.culled_closest_plain(eng, eo, ed, etc), pc))


def test_two_level_any_edge_cases_equal_plain(iwalk_case):
    """As for the walk, on the boxes the lanes test (vwalk: the virtual
    chunks' widened world boxes; iwalk: its object chunk boxes, the rays'
    origins and directions mapped to world through an instance of the
    chunk's model), both queries equal to the plain versions and to the
    plain models of the cull."""
    eng, _, (o, d, tl) = iwalk_case
    vwalk = iwalk.engine_name(eng) == "vwalk"
    boxes = iwalk.virtual_boxes(eng) if vwalk else (eng["ocb"][:, 0:3], eng["ocb"][:, 3:6])
    kt, ks, _ = iwalk.closest_cuda(eng, o, d, tl)
    eo, ed, et = _edge_rays(eng, *boxes, kt, ks, o, d, tl, 19)
    if not vwalk:  # the face rays (rows 512-1023) are object-space: to world
        c = torch.randint(0, eng["ocb"].shape[0], (1,), device=o.device)  # any chunk's model
        i = ((c >= eng["inst_c"][:, 0]) & (c < eng["inst_c"][:, 1])).int().argmax()
        f = slice(512, 1024)
        eo[f], ed[f] = iwalk.to_world(eng, i.expand(512), eo[f], ed[f])
    etc = walk._exit_clamp(eng, eo, ed, et).contiguous()
    k = iwalk.any_cuda(eng, eo, ed, etc)
    p = iwalk.any_plain(eng, eo, ed, etc)
    assert 0.1 < p.float().mean() < 0.9
    assert torch.equal(k, p)
    kc, pc = iwalk.closest_cuda(eng, eo, ed, etc), iwalk.closest_plain(eng, eo, ed, etc)
    assert all(torch.equal(a, b) for a, b in zip(kc, pc))
    assert torch.equal(iwalk.culled_any_plain(eng, eo, ed, etc), p)
    assert all(torch.equal(a, b) for a, b in zip(iwalk.culled_closest_plain(eng, eo, ed, etc), pc))


def test_walk_closest_ties_equal_plain(cuda):
    """``walk.tie_soup``: every ray's closest hit is one triangle held in
    two chunks of the walk tables (twice in one), and in two coincident
    instances of a model that holds it twice (vwalk). The kernels pick the
    plain versions' winner (the first chunk in the block's octant order,
    then the lowest lane, as tests/test_torch_walk_cull.py holds) and t."""
    pos, o, d = walk.tie_soup()
    tables, slots = walk.tie_tables(pos, pos.shape[0] - 1)
    eng = {k: torch.from_numpy(v).to(cuda) for k, v in tables.items()}
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    tl = torch.full((o.shape[0],), float("inf"), device=cuda)
    k, p = walk.closest_cuda(eng, o, d, tl), walk.closest_plain(eng, o, d, tl)
    assert all(torch.equal(a, b) for a, b in zip(k, p))
    assert set(k[1].tolist()) == set(slots[:2])
    m = rigid_transform(rotation_y(0.7), (0.5, 0.2, -0.1))
    veng = iwalk.upload(iwalk.pack_vwalk([Model(None, matrices=[m, m],
                                                positions=np.concatenate([pos, pos[-1:]]))]), cuda)
    rot, tr = torch.from_numpy(m[:, :3]).to(cuda), torch.from_numpy(m[:, 3]).to(cuda)
    ow, dw = (o @ rot.T + tr).contiguous(), (d @ rot.T).contiguous()
    k, p = iwalk.closest_cuda(veng, ow, dw, tl), iwalk.closest_plain(veng, ow, dw, tl)
    assert all(torch.equal(a, b) for a, b in zip(k, p)) and bool((k[1] >= 0).all())


def test_iwalk_ties_equal_plain(cuda):
    """``iwalk.tie_tables``: two coincident instances of ``walk.tie_soup``
    with its triangle T also held twice in a second object chunk, every
    ray's closest hit. The closest kernel picks the plain version's winner
    (the first instance in the block's octant order, then the lowest chunk,
    then the lowest lane), instance and t; the any kernel flags every ray
    with a limit past T and none with a limit short of it."""
    pos, o, d = walk.tie_soup()
    m = rigid_transform(rotation_y(0.7), (0.5, 0.2, -0.1))
    tables, slots = iwalk.tie_tables(pos, pos.shape[0] - 1, m)
    eng = iwalk.upload(tables, cuda)
    rot, tr = torch.from_numpy(m[:, :3]).to(cuda), torch.from_numpy(m[:, 3]).to(cuda)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    ow, dw = (o @ rot.T + tr).contiguous(), (d @ rot.T).contiguous()
    tl = torch.full((o.shape[0],), float("inf"), device=cuda)
    k, p = iwalk.closest_cuda(eng, ow, dw, tl), iwalk.closest_plain(eng, ow, dw, tl)
    assert all(torch.equal(a, b) for a, b in zip(k, p)) and bool((k[1] == min(slots)).all())
    for scale, want in ((1.001, True), (0.999, False)):
        lim = (k[0] * scale).contiguous()
        a = iwalk.any_cuda(eng, ow, dw, lim)
        assert torch.equal(a, iwalk.any_plain(eng, ow, dw, lim)) and bool((a == want).all())


def test_stack_bvh_on_card_equals_cpu(cuda):
    """The stack BVH's torch ops give the same bits on the card as on the
    CPU, for both queries."""
    rng = np.random.default_rng(23)
    pos, _ = procedural.bumpy_sphere(nu=40, nv=40)
    lo, hi = tri_mod.aabbs(pos)
    flat, perm, depth = build_bvh(lo, hi)
    tab = bvh_stack.pack(flat, depth, tri_mod.precompute(pos[perm]))
    n = 1024
    o = rng.normal(size=(n, 3))
    o = (3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    d = -o + 0.5 * rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.full(n, np.inf, np.float32)
    tl[:64] = 0.0
    cpu = {k: torch.from_numpy(v) for k, v in tab.items()}
    gpu = {k: v.to(cuda) for k, v in cpu.items()}
    rays = [torch.from_numpy(x) for x in (o, d, tl)]
    c = bvh_stack.closest_hit(cpu, *rays)
    g = bvh_stack.closest_hit(gpu, *(x.to(cuda) for x in rays))
    assert (c[0] >= 0).sum() > 300
    assert all(torch.equal(a, b.cpu()) for a, b in zip(c, g))
    lim = torch.where(c[0] >= 0, c[1] * 1.01, rays[2])
    ca = bvh_stack.any_hit(cpu, rays[0], rays[1], lim)
    assert torch.equal(ca, bvh_stack.any_hit(gpu, rays[0].to(cuda), rays[1].to(cuda), lim.to(cuda)).cpu())


@pytest.fixture
def stream_case(cuda):
    """The streamed engine's tables of a 36,992-triangle bumpy sphere (3
    parts) and 1,024 rays (half aimed at it from outside, half from inside)
    with inf, dead, finite-limit and NaN lanes, clamped as the public query
    hands them to the kernels."""
    rng = np.random.default_rng(17)
    pos, nrm = procedural.bumpy_sphere(nu=136, nv=136)
    model = rng.integers(0, 5, pos.shape[0])
    tables = ds.pack_dense_stream(tri_mod.precompute(pos), nrm.reshape(-1, 9), model, pos)
    assert tables["meta"]["nparts"] == 3
    eng = ds.upload(tables, cuda)
    n = 1024
    o1 = rng.normal(size=(n // 2, 3))
    o1 = 3.0 * o1 / np.linalg.norm(o1, axis=1, keepdims=True)
    o = np.concatenate([o1, rng.uniform(-1, 1, (n // 2, 3))]).astype(np.float32)
    d = np.concatenate([-o1 + 0.15 * rng.normal(size=(n // 2, 3)), rng.normal(size=(n // 2, 3))])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tl = np.full(n, np.inf, np.float32)
    tl[:64] = 0.0
    tl[64:128] = rng.uniform(0.5, 3.0, 64)
    o[128:136] = np.nan
    d[136:144] = np.nan
    o, d, tl = (torch.from_numpy(x).to(cuda) for x in (o, d, tl))
    return eng, (o, d, tl), dc._rays(o, d, tl)


def test_stream_closest_kernel_equals_plain(stream_case):
    eng, _, rays = stream_case
    n0 = dc.LAUNCHES["stream_closest"]
    kt, ki = ds.closest_cuda(eng, *rays)
    assert dc.LAUNCHES["stream_closest"] == n0 + 1
    pt, pi = ds.closest_plain(eng, *rays)
    assert (ki >= 0).sum() > 300
    assert torch.equal(ki, pi) and torch.equal(kt, pt)
    dead = ~ds._valid(*rays)
    assert (ki[dead] == -1).all()


def test_stream_any_kernel_equals_plain(stream_case):
    eng, _, (o, d, tl) = stream_case
    kt, ki = ds.closest_cuda(eng, o, d, tl)
    for scale in (0.99, 1.01):
        lim = torch.where(ki >= 0, kt * scale, tl).contiguous()
        n0 = dc.LAUNCHES["stream_any"]
        k = ds.any_cuda(eng, o, d, lim)
        assert dc.LAUNCHES["stream_any"] == n0 + 1
        assert torch.equal(k, ds.any_plain(eng, o, d, lim))
        hit = ki >= 0
        assert bool(k[hit].all()) if scale > 1 else not bool(k[hit].any())
    assert not ds.any_cuda(eng, o, d, tl)[~ds._valid(o, d, tl)].any()


def test_stream_queries_on_card_equal_cpu(stream_case):
    """The public stream queries launch the kernels on CUDA tensors and give
    the same bits as the plain versions on CPU tensors."""
    eng, (o, d, tl), _ = stream_case
    eng_cpu = {k: v.cpu() for k, v in eng.items()}
    n0 = dict(dc.LAUNCHES)
    gpu = ds.dense_stream_closest_hit_shade(eng, o, d, tl)
    cpu = ds.dense_stream_closest_hit_shade(eng_cpu, o.cpu(), d.cpu(), tl.cpu())
    ok = (torch.isfinite(o).all(1) & torch.isfinite(d).all(1)).cpu()
    for a, b in zip(gpu, cpu):
        assert torch.equal(a.cpu()[ok], b[ok])
    assert torch.equal(ds.dense_stream_any_hit(eng, o, d, tl).cpu(),
                       ds.dense_stream_any_hit(eng_cpu, o.cpu(), d.cpu(), tl.cpu()))
    assert dc.LAUNCHES["stream_closest"] == n0["stream_closest"] + 1
    assert dc.LAUNCHES["stream_any"] == n0["stream_any"] + 1


def test_stream_kernel_rejects_bad_inputs(stream_case):
    eng, _, (o, d, tl) = stream_case
    with pytest.raises(ValueError):
        ds.closest_cuda(eng, o.double(), d, tl)
    with pytest.raises(ValueError):
        ds.any_cuda(eng, o, d.t().contiguous().t(), tl)
    with pytest.raises(ValueError):
        ds.closest_cuda({**eng, "aux": eng["aux"][:-1].contiguous()}, o, d, tl)
    with pytest.raises(ValueError):
        ds.any_cuda({**eng, "pab": eng["pab"][:2].contiguous()}, o, d, tl)
    with pytest.raises(ValueError):
        ds.any_cuda({**eng, "qab": eng["qab"][:-1].contiguous()}, o, d, tl)
    with pytest.raises(ValueError, match="qab"):
        ds.closest_cuda({k: v for k, v in eng.items() if k != "qab"}, o, d, tl)
    with pytest.raises(ValueError):
        ds.any_cuda({k: v.cpu() for k, v in eng.items()}, o, d, tl)


def test_stream_stats_counts(stream_case):
    """The counters of both stream kernels: blocks and lanes, the boxes
    entered at each level (a lane enters a chunk's group only after its
    chunk, a chunk only after its part), staged groups (each with a listed
    lane), listed lanes and pairs, consistent with each other; the closest
    hit tests fewer pairs than every row; counting does not change the
    results."""
    eng, (o, d, tl), rays = stream_case
    valid = int(ds._valid(*rays).sum())
    groups = eng["qab"].shape[0]
    nt = ds.QH * int((eng["qab"][:, 0:3] <= eng["qab"][:, 3:6]).all(1).sum())  # rows of real groups
    for query in ("closest", "any"):
        s = ds.stream_stats(eng, o, d, tl, query=query)
        assert s["blocks"] == 8 and s["lanes"] == valid
        assert 0 < s["parts"] <= 3 * s["lanes"]
        assert s["chunks"] <= 32 * s["parts"] and s["groups"] <= 4 * s["chunks"]
        assert 0 < s["staged"] <= groups * s["blocks"] and s["staged"] <= s["listed"]
        assert s["listed"] <= s["groups"] and 0 < s["pairs"] <= s["listed"] * ds.QH
        assert s["pairs"] <= s["lanes"] * nt
        if query == "closest":
            assert s["pairs"] < 0.5 * s["lanes"] * nt
    stats = torch.zeros(ds.NSTATS, dtype=torch.int64, device=o.device)
    assert all(torch.equal(a, b) for a, b in zip(ds.closest_cuda(eng, *rays, stats=stats),
                                                 ds.closest_cuda(eng, *rays)))
    with pytest.raises(ValueError):
        ds.closest_cuda(eng, *rays, stats=stats[:-1])


def test_stream_edge_cases_equal_plain(stream_case):
    """The stream kernels' three-level cull on its edge cases (axis-parallel
    rays, rays from and along part, chunk and group box faces, limits one
    ulp either side of a closest t): both queries equal the ungated plain
    versions and the plain models of the cull."""
    eng, _, (o, d, tl) = stream_case
    kt, ki = ds.closest_cuda(eng, o, d, tl)
    boxes = torch.cat([b[(b[:, 0:3] <= b[:, 3:6]).all(dim=1)]
                       for b in (eng["pab"], eng["cab"], eng["qab"])])
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    root = {"root_lo": eng["pab"][:, 0:3].amin(0), "root_hi": eng["pab"][:, 3:6].amax(0)}
    eo, ed, et = _edge_rays(root, lo, hi, kt, ki.long(), o, d, tl, 29)
    ka, pa = ds.any_cuda(eng, eo, ed, et), ds.any_plain(eng, eo, ed, et)
    assert 0.1 < pa.float().mean() < 0.95
    assert torch.equal(ka, pa) and torch.equal(ds.culled_any_plain(eng, eo, ed, et), pa)
    kc, pc = ds.closest_cuda(eng, eo, ed, et), ds.closest_plain(eng, eo, ed, et)
    assert all(torch.equal(a, b) for a, b in zip(kc, pc))
    assert all(torch.equal(a, b) for a, b in zip(ds.culled_closest_plain(eng, eo, ed, et), pc))


def test_stream_closest_ties_equal_plain(cuda):
    """``dense_stream.tie_soup``: every ray's closest hit is one triangle
    held in parts 0 and 1 (twice within one group of part 0); the kernel
    picks the lowest soup index, as the plain version does, and its t."""
    pos, o, d = ds.tie_soup()
    eng = ds.upload(ds.pack_dense_stream(tri_mod.precompute(pos), None, None, pos), cuda)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    tl = torch.full((o.shape[0],), 3.0e38, device=cuda)
    (kt, ki), (pt, pi) = ds.closest_cuda(eng, o, d, tl), ds.closest_plain(eng, o, d, tl)
    assert torch.equal(ki, pi) and torch.equal(kt, pt) and bool((ki == ds.TIE_ROWS[0]).all())
    lim = (kt * 1.001).contiguous()
    assert torch.equal(ds.any_cuda(eng, o, d, lim), ds.any_plain(eng, o, d, lim))


def test_row_gather_kernel_equals_plain(cuda):
    table, idx = gather.row_inputs(1, cuda)
    n0 = dc.LAUNCHES["row_gather"]
    k = gather.row_gather_cuda(table, idx)
    assert dc.LAUNCHES["row_gather"] == n0 + 1
    assert torch.equal(k, gather.row_gather_plain(table, idx))
    assert torch.equal(k, torch.index_select(table, 0, idx))
    c = gather.chain(gather.row_gather, table, idx)
    assert torch.equal(c, gather.chain(gather.row_gather_plain, table, idx))
    assert torch.equal(c, gather.chain(lambda t, i: torch.index_select(t, 0, i), table, idx))


@pytest.mark.parametrize("n", [0, 1, 31, 33, 16 * 37 + 5])
def test_row_gather_kernel_counts_and_ends(cuda, n):
    """Row counts around the kernel's units of 16 rows per warp, with
    repeated indices and the table's first and last rows; no index, no
    launch."""
    rng = np.random.default_rng(n)
    m = 4096
    table = torch.from_numpy(rng.standard_normal((m, gather.ROW_W)).astype(np.float32)).to(cuda)
    idx = rng.integers(0, m, n).astype(np.int32)
    idx[0::3] = 0
    idx[1::5] = m - 1
    idx[2::7] = 1234
    idx = torch.from_numpy(idx).to(cuda)
    n0 = dc.LAUNCHES["row_gather"]
    k = gather.row_gather_cuda(table, idx)
    assert dc.LAUNCHES["row_gather"] == n0 + (n > 0)
    assert k.shape == (n, gather.ROW_W)
    assert torch.equal(k, gather.row_gather_plain(table, idx))
    assert torch.equal(k, torch.index_select(table, 0, idx))


@pytest.mark.parametrize("shape,axis", [((8, 128), 0), ((1024, 128), 0), ((8, 128), 1), ((8, 8192), 1)]
                         + [((m, 128), 0) for m in (64, 128, 256, 512)]
                         + [((8, m), 1) for m in (256, 512, 1024, 2048, 4096)])
def test_tile_gather_kernel_equals_plain(cuda, shape, axis):
    """Every probe shape (mode 1 up to the 32 KB tile of 8,192 entries),
    at 1 and 16 gathers."""
    x, idx = gather.tile_inputs(2, shape, axis, cuda)
    for reps in (1, 16):
        n0 = dc.LAUNCHES["tile_gather"]
        k = gather.tile_gather_cuda(x, idx, axis, reps)
        assert dc.LAUNCHES["tile_gather"] == n0 + 1
        assert torch.equal(k, gather.tile_gather_plain(x, idx, axis, reps))
        assert torch.equal(k, gather.tile_gather_library(x, idx, axis, reps))
