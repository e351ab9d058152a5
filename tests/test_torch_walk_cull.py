"""The per-lane segment cull of the walk, vwalk and iwalk kernels
(``csrc/segment.cuh`` enters, used by ``csrc/walk_common.cuh`` lane_walk
and inst_walk), through its plain torch model (``trace/walk.py``
lane_enters, the kernel's float expressions in its order; iwalk's three
levels in ``trace/iwalk.py`` entry_enters), on the walk tables of
``dragon_scene(nu=96, nv=64, env_h=64)`` (24,588 triangles) and on
``tests/test_torch_iwalk.py``'s small two-level tables.

The cull must be exact: every (ray, chunk) pair that holds a hit in
(EPSILON, t_limit) passes the lane's test, so the culled any hit equals the
ungated plain one on every ray; and the closest hit, culled at the least
window a kernel lane can reach (its closest t), equals the ungated plain
one bit for bit, ties included. Held on random rays, shadow-shaped rays
toward a light, axis-parallel rays, rays along chunk box faces and from
origins on them, and limits one ulp either side of each ray's closest t.
The tie rule (minimum t, then the first chunk in the block's octant order,
then the lowest lane) is held on a soup with one triangle in two chunks and
twice within one, and on two coincident instances of a model that holds a
triangle twice; iwalk's (the first instance in the block's octant order,
then the lowest chunk, then the lowest lane) on two coincident instances of
a model that holds a triangle in two chunks, twice within one. iwalk's
object boxes (``iwalk.pack_object_boxes``) are held to nest and to hold
their triangles.
"""

import numpy as np
import pytest
import torch

from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene.model import Model as TModel
from path_tracer_tpu_torch.scene.model import rigid_transform, rotation_y
from path_tracer_tpu_torch.trace import iwalk, walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

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


KINDS = ("walk", "vwalk", "iwalk")


@pytest.fixture(scope="module")
def engines():
    """{"walk": (engine, chunk boxes lo/hi, light point), "vwalk": ...,
    "iwalk": (engine, OBJECT chunk boxes lo/hi, light point)}."""
    sh, _ = tscenes.dragon_scene(nu=96, nv=64, env_h=64)
    scene = sh.device("cpu")
    weng = scene["tri"]["walk"]
    light = scene["light"]["positions_flat"][:, 0:3].mean(dim=0)
    veng = iwalk.upload(iwalk.pack_vwalk(_models()), "cpu")
    ieng = iwalk.upload(iwalk.pack_iwalk(_models()), "cpu")
    up = torch.tensor([0.0, 5.0, 0.0])
    return {"walk": (weng, *walk.chunk_boxes(weng), light),
            "vwalk": (veng, *iwalk.virtual_boxes(veng), up),
            "iwalk": (ieng, ieng["ocb"][:, 0:3], ieng["ocb"][:, 3:6], up)}


@pytest.fixture(scope="module")
def ray_sets(engines):
    """Each (kind, set)'s rays with their exit-clamped limits, made once for
    the module: the lane-cull and closest-cull cases of a (kind, set) share
    them (the ulp and shadow sets each take a closest-hit pass to make)."""
    made = {}

    def get(kind, name):
        if (kind, name) not in made:
            eng, lo, hi, light = engines[kind]
            o, d, tl = _rays(kind, eng, lo, hi, light, name)
            made[kind, name] = (o, d, walk._exit_clamp(eng, o, d, tl))
        return made[kind, name]

    return get


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
    g = torch.Generator().manual_seed(SETS.index(name) + 10 * KINDS.index(kind))
    rng = np.random.default_rng(SETS.index(name) + 10 * KINDS.index(kind))
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
    if kind == "iwalk":  # object chunk box faces, through an instance of the chunk
        return (*_to_world(eng, c, o, _unit(d)), inf)
    return o, _unit(d), inf


def _to_world(eng, chunk, o, d):
    """Object-space rays ``o, d`` of object chunks ``chunk`` through the
    forward transform of the first instance whose range holds each."""
    c0, c1 = eng["inst_c"][:, 0].long(), eng["inst_c"][:, 1].long()
    return iwalk.to_world(eng, ((chunk[:, None] >= c0) & (chunk[:, None] < c1)).int().argmax(dim=1),
                          o, d)


def _hits_by_chunk(kind, eng, o, d, tl):
    """``[n, E]``: whether each lane has a hit in (EPSILON, t_limit) in each
    cull entry (the walk's layout chunk; vwalk's virtual chunk, iwalk's
    (instance, object chunk), on the object-space ray), and the lane
    values."""
    o, d, tl = walk._lanes(o, d, tl)
    if kind == "walk":
        hits = walk._shadow_hits(eng["aux"][:, :12], o, d, tl[:, None])
        return hits.view(o.shape[0], -1, walk.CH_W).any(dim=2), o, d, tl
    return iwalk.entry_hits(eng, o, d, tl), o, d, tl


def _enters(kind, eng, lo, hi, o, d, tw):
    """``[n, E]``: whether each lane passes the kernel's cull of each entry
    of `_hits_by_chunk` within ``tw``."""
    if kind == "iwalk":
        return iwalk.entry_enters(eng, o, d, tw)
    return walk.lane_enters(lo, hi, o, d, tw)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_lane_cull_is_exact(engines, ray_sets, kind, name):
    eng, lo, hi, light = engines[kind]
    o, d, tlc = ray_sets(kind, name)
    hits, o_, d_, tl_ = _hits_by_chunk(kind, eng, o, d, tlc)
    enter = _enters(kind, eng, lo, hi, o_, d_, tl_)
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


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_closest_cull_is_exact(engines, ray_sets, kind, name):
    eng, lo, hi, light = engines[kind]
    mod = walk if kind == "walk" else iwalk
    o, d, tlc = ray_sets(kind, name)
    plain = mod.closest_plain(eng, o, d, tlc)
    culled = mod.culled_closest_plain(eng, o, d, tlc)
    assert all(torch.equal(a, b) for a, b in zip(culled, plain)), (kind, name)
    assert int((plain[1] >= 0).sum()) > 0
    # the cull does cut: most live (ray, entry) pairs are not entered
    o_, d_, tl_ = walk._lanes(o, d, tlc)
    live = tl_ > 0
    window = torch.minimum(plain[0], tl_)
    assert _enters(kind, eng, lo, hi, o_, d_, window)[live].float().mean() < 0.5


def test_closest_tie_rule():
    """Every ray's closest hit is the one triangle T, which lies in two
    chunks (and twice within one), or in two coincident instances' virtual
    chunks: the plain versions, and the culled ones, take the first chunk
    in the block's octant order, then the lowest lane, at T's t."""
    pos, o, d = walk.tie_soup()
    index = pos.shape[0] - 1
    tables, slots = walk.tie_tables(pos, index)
    eng = {k: torch.from_numpy(v) for k, v in tables.items()}
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    tl = torch.full((o.shape[0],), float("inf"))
    t, slot = walk.closest_plain(eng, o, d, tl)
    cand = torch.tensor(slots)
    k = walk.num_chunks(eng)
    at = torch.argsort(eng["ord_oct"][:, :k].long(), dim=1)  # position of each chunk
    rank = at[walk._block_octant(d)][:, cand // walk.CH_W] * walk.CH_W + cand % walk.CH_W
    want = cand[rank.argmin(dim=1)]
    assert torch.equal(slot, want.to(torch.int32))
    assert set(want.tolist()) == {slots[0], slots[1]}  # each chunk wins some octants
    assert torch.equal(t, walk._candidate_t(eng["aux"][slots[0]:slots[0] + 1, :12], o, d,
                                            tl[:, None])[:, 0])
    assert all(torch.equal(a, b) for a, b in zip(walk.culled_closest_plain(eng, o, d, tl), (t, slot)))

    # two coincident instances of the soup with T twice
    m = rigid_transform(rotation_y(0.7), (0.5, 0.2, -0.1))
    veng = iwalk.upload(iwalk.pack_vwalk([TModel(None, matrices=[m, m],
                                                 positions=np.concatenate([pos, pos[-1:]]))]), "cpu")
    rot, tr = torch.from_numpy(m[:, :3]), torch.from_numpy(m[:, 3])
    ow, dw = o @ rot.T + tr, d @ rot.T
    vt, vslot, vinst = iwalk.closest_plain(veng, ow, dw, tl)
    g = veng["gates"]
    vi, vg = veng["vinst"][:g].long(), veng["vglob"][:g].long()
    copies = ((veng["origmap"] >= index) & (veng["aux"][:, :12] != 0).any(1)).nonzero()[:, 0]
    v_of = [(v, s) for v in range(g) for s in copies.tolist() if vg[v] == s // walk.CH_W]
    cv = torch.tensor([v for v, _ in v_of])
    cs = torch.tensor([s for _, s in v_of])
    at = torch.argsort(veng["ord_oct"][:, :g].long(), dim=1)
    rank = at[walk._block_octant(dw)][:, cv] * walk.CH_W + cs % walk.CH_W
    first = rank.argmin(dim=1)
    assert torch.equal(vslot, cs[first].to(torch.int32)) and torch.equal(vinst, vi[cv[first]].to(torch.int32))
    assert (vslot == cs.min()).all()  # T's lower lane in its object chunk
    assert (vt > 0.09).all() and (vt < 0.11).all()
    assert all(torch.equal(a, b) for a, b in zip(iwalk.culled_closest_plain(veng, ow, dw, tl),
                                                 (vt, vslot, vinst)))

    # iwalk: two coincident instances of the soup, T also held twice in a
    # second object chunk: the first instance in the block's octant order,
    # then the lowest chunk, then the lowest lane
    ieng = iwalk.upload(iwalk.tie_tables(pos, index, m)[0], "cpu")
    it, islot, iinst = iwalk.closest_plain(ieng, ow, dw, tl)
    copies = ((ieng["origmap"] == index) & (ieng["aux"][:, :12] != 0).any(1)).nonzero()[:, 0]
    assert copies.numel() == 3 and torch.unique(copies // walk.CH_W).numel() == 2
    assert (islot == copies.min()).all()
    assert torch.equal(iinst, ieng["ord_oct"][walk._block_octant(dw), 0])
    assert torch.equal(it, vt)
    assert all(torch.equal(a, b) for a, b in zip(iwalk.culled_closest_plain(ieng, ow, dw, tl),
                                                 (it, islot, iinst)))


def test_object_boxes_nest_and_hold_triangles():
    """iwalk's object tables (``iwalk.pack_object_boxes``, added by
    ``upload``): the JAX-parity tables pass through unchanged; parts tile
    each model's chunks, at most ``PART_W`` each, never straddling two
    models, and each instance's part range covers its chunk range; a part's
    box holds its chunks' boxes, and a chunk's box holds every real
    triangle of the chunk, within its pad of the triangles' own box."""
    models = _models()
    tables = iwalk.pack_iwalk(models)
    assert set(tables) == set(iwalk.IWALK_TABLES)
    eng = iwalk.upload(tables, "cpu")
    assert all(torch.equal(eng[k], torch.from_numpy(tables[k])) for k in iwalk.IWALK_TABLES)
    inst_p, part_c, ocb, opb = (eng[k] for k in iwalk.IWALK_BOXES)
    kc = eng["aux"].shape[0] // walk.CH_W
    assert ocb.shape == (kc, 6) and ocb.dtype == opb.dtype == torch.float32
    assert part_c[0, 0] == 0 and part_c[-1, 1] == kc and torch.equal(part_c[1:, 0], part_c[:-1, 1])
    span = part_c[:, 1] - part_c[:, 0]
    assert (span >= 1).all() and (span <= iwalk.PART_W).all() and (span == iwalk.PART_W).any()
    model = eng["aux"][:: walk.CH_W, 21].long()
    assert all((model[a:b] == model[a]).all() for a, b in part_c.tolist())
    for (c0, c1), (p0, p1) in zip(eng["inst_c"].tolist(), inst_p.tolist()):
        assert part_c[p0, 0] == c0 and part_c[p1 - 1, 1] == c1
    for p, (a, b) in enumerate(part_c.tolist()):
        assert (opb[p, :3] <= ocb[a:b, :3]).all() and (opb[p, 3:] >= ocb[a:b, 3:]).all()
    pos = torch.from_numpy(np.concatenate([np.asarray(m.positions, np.float32) for m in models]))
    rows = (eng["aux"][:, :12] != 0).any(1).nonzero()[:, 0]
    v, c = pos[eng["origmap"][rows].long()], rows // walk.CH_W  # [R, 3, 3] object vertices
    assert (v >= ocb[c, None, :3]).all() and (v <= ocb[c, None, 3:]).all()
    shared = iwalk.model_tables(models)
    lo, hi = torch.from_numpy(shared["cbox_min"]), torch.from_numpy(shared["cbox_max"])
    pad = 1e-4 * torch.maximum(pos.abs().amax(), torch.tensor(1.0)) + 1e-6
    assert ((lo - ocb[:, :3]) <= 2 * pad).all() and ((ocb[:, 3:] - hi) <= 2 * pad).all()
