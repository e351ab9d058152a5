"""The dense kernels' chunk boxes and per-lane segment cull
(``csrc/dense_hit.cu``: ``segment.cuh`` enters against ``cab``), through
the plain model of the cull (``trace/dense_cuda.py`` culled_closest_plain,
culled_any_plain: ``walk.lane_enters``, the kernel's float expressions in
its order), on the 700-triangle setup of ``tests/test_torch_dense.py`` (6
chunks of 128), in its own order (chunk boxes spanning nearly the whole
soup) and in the SAH builder's leaf order (tight boxes).

The cull must be exact: every (ray, chunk) pair that holds a hit in
(EPSILON, t_limit) passes the lane's test, so the culled any hit equals the
ungated plain one on every ray; and the closest hit, culled at the least
window a kernel lane can reach (min(t*, t_limit), t* its closest t), equals
the ungated plain one bit for bit, winners, t and the epilogue's columns.
Held on random rays, shadow-shaped rays toward a light point,
axis-parallel rays, rays from chunk box faces (half moving within the
face's plane), and limits one ulp either side of each ray's closest t. The
tie rule (the lowest table index) is held on a soup with one triangle in
two chunks and twice within one. ``pack_dense_cab`` equals the JAX
``pack_dense_pl_cab`` bit for bit at the JAX chunk width.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.trace.dense_pallas import (
    dense_pl_closest_hit_shade,
    pack_dense_pl,
    pack_dense_pl_aux,
    pack_dense_pl_cab,
)
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.scene.bvh import build_sah_tree
from path_tracer_tpu_torch.trace import dense_cuda as dc
from path_tracer_tpu_torch.trace import walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SETS = ("random", "shadow", "axis", "face", "ulp")
N_RAYS = 384


def _soup():
    """``tests/test_torch_dense.py``'s 700 triangles, shading normals and
    model ids."""
    rng = np.random.default_rng(7)
    t = 700
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    pos = np.stack([v0, v1, v2], axis=1)
    return pos, rng.normal(size=(t, 9)).astype(np.float32), rng.integers(0, 5, t).astype(np.int32)


def _eng(pos, nf=None, model=None):
    aux = dc.pack_dense_aux(tri_mod.precompute(pos), nf, model)
    return {"aux": torch.from_numpy(aux), "cab": torch.from_numpy(dc.pack_dense_cab(pos))}


@pytest.fixture(scope="module")
def tables():
    """{"setup": the soup in its own order, "sah": in SAH leaf order}: each
    (engine, positions)."""
    pos, nf, model = _soup()
    perm = build_sah_tree(pos.min(axis=1), pos.max(axis=1), max_leaf=4)[1]
    return {"setup": (_eng(pos, nf, model), pos),
            "sah": (_eng(pos[perm], nf[perm], model[perm]), pos[perm])}


def _unit(v):
    return v / v.norm(dim=1, keepdim=True)


def _closest_t(eng, o, d, tl):
    """Each ray's plain closest t (its limit on a miss) and hit flag."""
    t, best = dc.closest_search_plain(eng["aux"], o, d, tl)
    return torch.where(best >= 0, t, tl), best >= 0


def _rays(eng, pos, name, seed):
    """One ray set: (origin, direction, t_limit), t_limit finite."""
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    n = N_RAYS
    s_lo = torch.from_numpy(pos.min(axis=(0, 1))) - 0.5
    s_hi = torch.from_numpy(pos.max(axis=(0, 1))) + 0.5
    inf = torch.full((n,), 3.0e38)
    if name in ("random", "ulp"):
        o = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        d = _unit(torch.randn((n, 3), generator=g))
        if name == "random":
            return o, d, (s_hi - s_lo).norm() * torch.rand(n, generator=g)
        t, hit = _closest_t(eng, o, d, inf)
        keep = hit.nonzero()[:, 0]
        up = torch.nextafter(t, torch.full_like(t, np.inf))
        down = torch.nextafter(t, torch.zeros_like(t))
        return (torch.cat([o[keep], o[keep]]), torch.cat([d[keep], d[keep]]),
                torch.cat([up[keep], down[keep]]))
    if name == "shadow":
        # from each random ray's hit point toward a light point above the soup
        o0 = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        d0 = _unit(torch.randn((n, 3), generator=g))
        t, hit = _closest_t(eng, o0, d0, inf)
        p = (o0 + d0 * t[:, None])[hit]
        light = torch.tensor([0.0, float(s_hi[1]) + 1.0, 0.0])
        vec = light + torch.randn((p.shape[0], 3), generator=g) * 0.3 - p
        dist = vec.norm(dim=1)
        return p, vec / dist[:, None], dist * (1 - 5e-4)
    if name == "axis":
        o = s_lo + (s_hi - s_lo) * torch.rand((n, 3), generator=g)
        axis = torch.as_tensor(rng.integers(0, 3, n))
        d = torch.zeros((n, 3))
        d[torch.arange(n), axis] = torch.as_tensor(rng.choice([-1.0, 1.0], n), dtype=torch.float32)
        return o, d, inf
    # "face": origins on chunk box faces; half move within the face plane
    lo, hi = eng["cab"][:, 0:3], eng["cab"][:, 3:6]
    c = torch.as_tensor(rng.integers(0, lo.shape[0], n))
    a = torch.as_tensor(rng.integers(0, 3, n))
    side = torch.as_tensor(rng.integers(0, 2, n)).bool()
    o = lo[c] + (hi[c] - lo[c]) * torch.rand((n, 3), generator=g)
    o[torch.arange(n), a] = torch.where(side, hi[c, a], lo[c, a])
    d = _unit(torch.randn((n, 3), generator=g))
    along = torch.arange(n) % 2 == 0
    d[along, a[along]] = 0.0
    return o, _unit(d), inf


def test_pack_dense_cab_matches_jax():
    """At the JAX chunk width (512 for 700 triangles) the port's packer
    gives the JAX chunk boxes bit for bit; at the port's width, 6 boxes of
    128 rows, each holding its rows' vertices."""
    pos, _, _ = _soup()
    np.testing.assert_array_equal(dc.pack_dense_cab(pos, 512), pack_dense_pl_cab(pos))
    cab = dc.pack_dense_cab(pos)
    assert cab.shape == (6, 6) and cab.dtype == np.float32
    for c in range(6):
        seg = pos[c * dc.CH : (c + 1) * dc.CH].reshape(-1, 3)
        assert (cab[c, 0:3] < seg.min(axis=0)).all() and (cab[c, 3:6] > seg.max(axis=0)).all()
    empty = dc.pack_dense_cab(np.zeros((0, 3, 3), np.float32))
    assert empty.shape == (0, 6)


def test_scene_dense_tables_carry_chunk_boxes():
    """``Scene.device`` packs the chunk boxes of the world table (from its
    positions) and of the lights (from ``positions_flat``)."""
    sh, _ = tscenes.cornell_specular()
    scene = sh.device("cpu")
    np.testing.assert_array_equal(scene["tri"]["dense"]["cab"].numpy(),
                                  dc.pack_dense_cab(sh.tri["positions"]))
    np.testing.assert_array_equal(scene["light"]["dense"]["cab"].numpy(),
                                  dc.pack_dense_cab(sh.light["positions"]))


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("order", ["setup", "sah"])
def test_lane_cull_is_exact(tables, order, name):
    eng, pos = tables[order]
    o, d, tl = _rays(eng, pos, name, SETS.index(name) + (0 if order == "setup" else 10))
    hits = dc._shadow_hits(eng["aux"], o, d, tl[:, None])
    lost = hits & ~dc._entered_rows(eng, o, d, tl)
    assert int(lost.sum()) == 0, (order, name, int(lost.sum()))
    plain = dc.any_plain(eng["aux"], o, d, tl)
    assert torch.equal(dc.culled_any_plain(eng, o, d, tl), plain)
    assert torch.equal(plain, hits.any(dim=1))
    cp = dc.closest_plain(eng["aux"], o, d, tl)
    assert torch.equal(dc.culled_closest_plain(eng, o, d, tl), cp)
    assert 0.0 < plain.float().mean() < 1.0 or name == "ulp"
    assert (cp[:, 1] >= 0).any()


@pytest.mark.parametrize("name", ["random", "axis", "face"])
def test_lane_cull_cuts(tables, name):
    """On the SAH-ordered table most (lane, chunk) pairs are not entered at
    the closest hit's least window."""
    eng, pos = tables["sah"]
    o, d, tl = _rays(eng, pos, name, 20 + SETS.index(name))
    t_star, _ = dc.closest_search_plain(eng["aux"], o, d, tl)
    enter = walk.lane_enters(eng["cab"][:, 0:3], eng["cab"][:, 3:6], o, d,
                             torch.minimum(t_star, tl))
    assert enter.float().mean() < 0.5


def tie_table():
    """`dense_cuda.tie_soup` (one triangle in chunks 7 and 15, twice in
    chunk 7): (engine, origin, direction); row 1001 must win every ray."""
    pos, o, d = dc.tie_soup()
    return _eng(pos), torch.from_numpy(o), torch.from_numpy(d)


def test_lowest_index_wins_ties_across_chunks():
    eng, o, d = tie_table()
    tl = torch.full((o.shape[0],), 3.0e38)
    p = dc.closest_plain(eng["aux"], o, d, tl)
    assert (p[:, 1] == dc.TIE_ROWS[0]).all()
    assert torch.equal(dc.culled_closest_plain(eng, o, d, tl), p)
    best, t, _, _ = dc.dense_closest_hit(eng, o, d, torch.full((o.shape[0],), np.inf))
    assert (best == dc.TIE_ROWS[0]).all() and torch.equal(t, p[:, 0])


def test_tie_table_matches_jax():
    """The tie table through the JAX dense engine (Pallas interpreter, with
    its chunk boxes) picks the same lowest index."""
    _, o, d = tie_table()
    pos, _, _ = dc.tie_soup()
    tri = dict(jtri.precompute(pos))
    jeng = {"w": jnp.asarray(pack_dense_pl(tri)), "aux": jnp.asarray(pack_dense_pl_aux(tri)),
            "cab": jnp.asarray(pack_dense_pl_cab(pos))}
    tl = np.full(o.shape[0], np.inf, np.float32)
    j = dense_pl_closest_hit_shade(jeng, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jnp.asarray(tl))
    assert (np.asarray(j[0]) == dc.TIE_ROWS[0]).all()


def test_table_without_cab_raises(tables):
    eng, _ = tables["setup"]
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    tl = torch.full((4,), np.inf)
    with pytest.raises(ValueError, match="cab"):
        dc.dense_closest_hit_shade({"aux": eng["aux"]}, o, d, tl)
    with pytest.raises(ValueError, match="cab"):
        dc.dense_any_hit({"aux": eng["aux"]}, o, d, tl)
