"""The per-lane segment cull of the walk and vwalk any-hit kernels
(``csrc/segment.cuh`` enters, used by ``csrc/walk_common.cuh`` any_walk),
through its plain torch model (``trace/walk.py`` lane_enters, the kernel's
float expressions in its order), on the walk tables of
``dragon_scene(nu=96, nv=64, env_h=64)`` (24,588 triangles) and on
``tests/test_torch_iwalk.py``'s small two-level tables.

The cull must be exact: every (ray, chunk) pair that holds a hit in
(EPSILON, t_limit) passes the lane's test, so the culled any hit equals the
ungated plain one on every ray. Held on random rays, shadow-shaped rays
toward a light, axis-parallel rays, rays along chunk box faces and from
origins on them, and limits one ulp either side of each ray's closest t.
"""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene.model import Model as TModel
from path_tracer_tpu_torch.scene.model import rigid_transform, rotation_y
from path_tracer_tpu_torch.trace import iwalk, walk

SETS = ("random", "shadow", "axis", "face", "ulp")


def _models():
    """``tests/test_torch_iwalk.py``'s models: three instances of a
    3,200-triangle bumpy sphere and two of a box."""
    sp, sn = tproc.bumpy_sphere(nu=40, nv=40)
    bp, bn = tproc.box((0.0, 0.0, 0.0), (0.6, 0.6, 0.6))
    mats_a = [
        rigid_transform(rotation_y(0.5), (-2.0, 0.0, 0.0)),
        rigid_transform(rotation_y(1.7), (2.0, 0.3, 0.5)),
        rigid_transform(rotation_y(2.9), (0.0, -0.4, -2.0)),
    ]
    mats_b = [
        rigid_transform(rotation_y(0.9), (0.0, 1.8, 0.0)),
        rigid_transform(rotation_y(2.1), (0.0, 0.0, 2.2)),
    ]
    return [TModel(None, matrices=mats_a, positions=sp, normals=sn),
            TModel(None, matrices=mats_b, positions=bp, normals=bn)]


@pytest.fixture(scope="module")
def engines():
    """{"walk": (engine, chunk boxes lo/hi, light point), "vwalk": ...}."""
    sh, _ = tscenes.dragon_scene(nu=96, nv=64, env_h=64)
    scene = sh.device("cpu")
    weng = scene["tri"]["walk"]
    light = scene["light"]["positions_flat"][:, 0:3].mean(dim=0)
    veng = iwalk.upload(iwalk.pack_vwalk(_models()), "cpu")
    return {"walk": (weng, *walk.chunk_boxes(weng), light),
            "vwalk": (veng, *iwalk.virtual_boxes(veng), torch.tensor([0.0, 5.0, 0.0]))}


def _unit(v):
    return v / v.norm(dim=1, keepdim=True)


def _closest_t(kind, eng, o, d, tl):
    """Each ray's closest hit t (the limit on a miss), plain version."""
    o, d, tl = o.contiguous(), d.contiguous(), tl.contiguous()
    if kind == "walk":
        t, slot = walk.closest_plain(eng, o, d, tl)
    else:
        t, slot, _ = iwalk.closest_plain(eng, o, d, tl)
    return torch.where(slot >= 0, t, tl), slot >= 0


def _rays(kind, eng, lo, hi, light, name, n=384):
    """One ray set: (origin, direction, t_limit) before the exit clamp."""
    g = torch.Generator().manual_seed(SETS.index(name) + (0 if kind == "walk" else 10))
    rng = np.random.default_rng(SETS.index(name) + (0 if kind == "walk" else 10))
    s_lo, s_hi = eng["root_lo"], eng["root_hi"]
    inf = torch.full((n,), 3.0e38)
    if name in ("random", "ulp"):
        o = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        d = _unit(torch.randn((n, 3), generator=g))
        if name == "random":
            return o, d, (s_hi - s_lo).norm() * torch.rand(n, generator=g)
        t, hit = _closest_t(kind, eng, o, d, inf)
        up = torch.nextafter(t, torch.full_like(t, np.inf))
        down = torch.nextafter(t, torch.zeros_like(t))
        keep = hit.nonzero()[:, 0]
        return (torch.cat([o[keep], o[keep]]), torch.cat([d[keep], d[keep]]),
                torch.cat([up[keep], down[keep]]))
    if name == "shadow":
        # from each camera-like ray's hit point toward the light
        o0 = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        d0 = _unit(torch.randn((n, 3), generator=g))
        t, hit = _closest_t(kind, eng, o0, d0, inf)
        p = (o0 + d0 * t[:, None])[hit]
        vec = light + torch.randn((p.shape[0], 3), generator=g) * 0.01 - p
        dist = vec.norm(dim=1)
        return p, vec / dist[:, None], dist * (1 - 5e-4)
    if name == "axis":
        o = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        axis = torch.as_tensor(rng.integers(0, 3, n))
        d = torch.zeros((n, 3))
        d[torch.arange(n), axis] = torch.as_tensor(rng.choice([-1.0, 1.0], n), dtype=torch.float32)
        return o, d, inf
    # "face": origins on chunk box faces; half move within the face plane
    c = torch.as_tensor(rng.integers(0, lo.shape[0], n))
    a = torch.as_tensor(rng.integers(0, 3, n))
    side = torch.as_tensor(rng.integers(0, 2, n)).bool()
    o = lo[c] + (hi[c] - lo[c]) * torch.rand((n, 3), generator=g)
    o[torch.arange(n), a] = torch.where(side, hi[c, a], lo[c, a])
    d = _unit(torch.randn((n, 3), generator=g))
    along = torch.arange(n) % 2 == 0
    d[along, a[along]] = 0.0
    return o, _unit(d), inf


def _hits_by_chunk(kind, eng, o, d, tl):
    """``[n, E]``: whether each lane has a hit in (EPSILON, t_limit) in each
    gate entry (the walk's layout chunk; vwalk's virtual chunk, on its
    object-space ray), and the lane values."""
    o, d, tl = walk._lanes(o, d, tl)
    if kind == "walk":
        hits = walk._shadow_hits(eng["aux"][:, :12], o, d, tl[:, None])
        return hits.view(o.shape[0], -1, walk.CH_W).any(dim=2), o, d, tl
    return iwalk.entry_hits(eng, o, d, tl), o, d, tl


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("kind", ["walk", "vwalk"])
def test_lane_cull_is_exact(engines, kind, name):
    eng, lo, hi, light = engines[kind]
    o, d, tl = _rays(kind, eng, lo, hi, light, name)
    tlc = walk._exit_clamp(eng, o, d, tl)
    hits, o_, d_, tl_ = _hits_by_chunk(kind, eng, o, d, tlc)
    enter = walk.lane_enters(lo, hi, o_, d_, tl_)
    lost = hits & ~enter
    assert int(lost.sum()) == 0, (kind, name, int(lost.sum()))
    plain = (walk if kind == "walk" else iwalk).any_plain(eng, o, d, tlc)
    culled = (walk if kind == "walk" else iwalk).culled_any_plain(eng, o, d, tlc)
    assert torch.equal(culled, plain)
    assert torch.equal(plain, hits.any(dim=1))
    # the cull does cut: most (ray, entry) pairs are not entered
    live = tl_ > 0
    assert 0.0 < plain.float().mean() < 1.0 or name == "ulp"
    assert enter[live].float().mean() < 0.5


def test_lane_enters_edge_cases():
    """Zero-direction axes, inverted and NaN boxes, a window that ends just
    short of the box, an origin on a face."""
    lo = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [float("nan"), 0.0, 0.0]])
    hi = torch.tensor([[1.0, 1.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
    o = torch.tensor([[0.5, 0.5, -1.0], [0.5, 1.5, -1.0], [0.0, 0.5, 0.5], [-2.0, 0.5, 0.5]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    tw = torch.tensor([10.0, 10.0, 0.0, 1.9])
    e = walk.lane_enters(lo, hi, o, d, tw)
    assert e[:, 1:].sum() == 0  # inverted and NaN boxes
    assert e[0, 0] and not e[1, 0]  # along z inside the slabs; outside y
    assert e[2, 0]  # origin on the face, zero window
    # window end tw*1.00002 + 1e-5 = 1.90004... < 2: the box starts at t = 2
    assert not e[3, 0] and walk.lane_enters(lo, hi, o[3:], d[3:], torch.tensor([2.0]))[0, 0]
