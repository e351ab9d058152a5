"""The streamed dense kernels' group boxes and three-level per-lane cull
(``csrc/dense_stream.cu``: ``segment.cuh`` enters against the part boxes
``pab``, the chunk boxes ``cab`` of each part entered and the group boxes
``qab`` of each chunk entered), through the plain model of the cull
(``trace/dense_stream.py`` culled_closest_plain, culled_any_plain:
``walk.lane_enters`` at each level, the kernel's float expressions in its
order), on a 16,928-triangle bumpy sphere in its grid order: two parts, the
second mostly pad (inverted chunk and group boxes, zero rows).

The cull must be exact: every (ray, group) pair that holds a hit in
(EPSILON, t_limit) passes the lane's tests at all three levels, so the
culled any hit equals the ungated plain one on every ray; and the closest
hit, culled at the least window a kernel lane can reach (min(t*, t_limit),
t* its closest t), equals the ungated plain one bit for bit, winners and t.
Held on random rays, shadow-shaped rays toward a light point,
axis-parallel rays, rays from part, chunk and group box faces (half moving
within the face's plane), and limits one ulp either side of each ray's
closest t. The tie rule (the lowest soup index) is held on a two-part soup
with one triangle in both parts and twice within one group, against the
JAX ``dense_stream`` in interpret mode too. ``qab`` equals
``dense_cuda.pack_dense_cab(positions, 128)`` bit for bit on the groups
that hold triangles and is inverted after them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.trace import dense_stream as jds
from path_tracer_tpu_torch.scene import procedural
from path_tracer_tpu_torch.scene import triangle as tri_mod
from path_tracer_tpu_torch.trace import dense_cuda as dc
from path_tracer_tpu_torch.trace import dense_stream as ds
from path_tracer_tpu_torch.trace import walk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SETS = ("random", "shadow", "axis", "face", "ulp")
N_RAYS = 256
N_JAX = 512  # the JAX query's one ray count (interpret mode compiles per count)


@pytest.fixture(scope="module")
def soup():
    """(engine dict, tables, positions) of a 16,928-triangle bumpy sphere:
    parts of 16,384 and 544 triangles."""
    pos, nrm = procedural.bumpy_sphere(nu=92, nv=92)
    tables = ds.pack_dense_stream(tri_mod.precompute(pos), nrm.reshape(-1, 9), None, pos)
    assert tables["meta"]["nparts"] == 2 and tables["meta"]["n_tris"] == 16928
    return ds.upload(tables, "cpu"), tables, pos


def _unit(v):
    return v / v.norm(dim=1, keepdim=True)


def _closest_t(eng, o, d, tl):
    """Each ray's plain closest t (its limit on a miss) and hit flag."""
    t, idx = ds.closest_plain(eng, o, d, tl)
    return torch.where(idx >= 0, t, tl), idx >= 0


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
        # from each random ray's hit point toward a light point beside the soup
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
    # "face": origins on the faces of real part, chunk and group boxes; half
    # of the rays move within the face's plane
    boxes = torch.cat([b[(b[:, 0:3] <= b[:, 3:6]).all(dim=1)]
                       for b in (eng["pab"], eng["cab"], eng["qab"])])
    lo, hi = boxes[:, 0:3], boxes[:, 3:6]
    c = torch.as_tensor(rng.integers(0, lo.shape[0], n))
    a = torch.as_tensor(rng.integers(0, 3, n))
    side = torch.as_tensor(rng.integers(0, 2, n)).bool()
    o = lo[c] + (hi[c] - lo[c]) * torch.rand((n, 3), generator=g)
    o[torch.arange(n), a] = torch.where(side, hi[c, a], lo[c, a])
    d = _unit(torch.randn((n, 3), generator=g))
    along = torch.arange(n) % 2 == 0
    d[along, a[along]] = 0.0
    return o, _unit(d), inf


@pytest.mark.parametrize("shape", ["two_parts", "one_part"])
def test_qab_matches_pack_dense_cab(soup, shape):
    """``qab`` is `dense_cuda.pack_dense_cab` at 128 rows per group on the
    groups that hold triangles (the soup's last group partly), bit for bit,
    and inverted on the pad groups after them; one row of boxes per 128
    ``aux`` rows."""
    _, tables, pos = soup
    if shape == "one_part":
        pos = pos[:1000]
        tables = ds.pack_dense_stream(tri_mod.precompute(pos), None, None, pos)
    qab, t = tables["qab"], pos.shape[0]
    assert qab.dtype == np.float32 and qab.shape == (tables["aux"].shape[0] // ds.QH, 6)
    real = -(-t // ds.QH)
    np.testing.assert_array_equal(qab[:real], dc.pack_dense_cab(pos, ds.QH))
    assert (qab[real:, 0:3] == 1e30).all() and (qab[real:, 3:6] == -1e30).all()
    assert (tables["aux"][t:] == 0).all()


def test_boxes_nest(soup):
    """Each real group box lies inside its chunk box, each real chunk box
    inside its part box; a pad chunk's groups are pad too."""
    _, tables, _ = soup
    pab, cab, qab = tables["pab"], tables["cab"], tables["qab"]
    qpc, cpp = ds.CH // ds.QH, cab.shape[0] // pab.shape[0]
    real_q = (qab[:, 0:3] <= qab[:, 3:6]).all(axis=1)
    real_c = (cab[:, 0:3] <= cab[:, 3:6]).all(axis=1)
    assert real_c.any() and not real_c.all() and real_q.sum() == -(-16928 // ds.QH)
    outer_c = cab[np.arange(qab.shape[0]) // qpc]
    assert (real_c[np.arange(qab.shape[0]) // qpc] | ~real_q).all()
    assert (qab[real_q, 0:3] >= outer_c[real_q, 0:3]).all()
    assert (qab[real_q, 3:6] <= outer_c[real_q, 3:6]).all()
    outer_p = pab[np.arange(cab.shape[0]) // cpp]
    assert (cab[real_c, 0:3] >= outer_p[real_c, 0:3]).all()
    assert (cab[real_c, 3:6] <= outer_p[real_c, 3:6]).all()


@pytest.mark.parametrize("name", SETS)
def test_lane_cull_is_exact(soup, name):
    eng, _, pos = soup
    o, d, tl = _rays(eng, pos, name, SETS.index(name))
    aux = eng["aux"]
    hits = dc._shadow_hits(aux, o, d, tl[:, None])
    lost = hits & ~ds._entered_rows(eng, o, d, tl)
    assert int(lost.sum()) == 0, (name, int(lost.sum()))
    plain = ds.any_plain(eng, o, d, tl)
    assert torch.equal(plain, hits.any(dim=1))
    assert torch.equal(ds.culled_any_plain(eng, o, d, tl), plain)
    pt, pi = ds.closest_plain(eng, o, d, tl)
    ct, ci = ds.culled_closest_plain(eng, o, d, tl)
    assert torch.equal(ci, pi) and torch.equal(ct, pt)
    assert 0.0 < plain.float().mean() < 1.0 or name == "ulp"
    assert (pi >= 0).any()


@pytest.mark.parametrize("name", ["random", "axis", "face"])
def test_lane_cull_cuts(soup, name):
    """Most (lane, group) pairs are not entered at the closest hit's least
    window, and each level cuts more than the one above it."""
    eng, _, pos = soup
    o, d, tl = _rays(eng, pos, name, 20 + SETS.index(name))
    t_star, _ = ds.closest_plain(eng, o, d, tl)
    tw = torch.minimum(t_star, tl)
    groups = ds.entered_groups(eng, o, d, tw)
    chunks = walk.lane_enters(eng["cab"][:, 0:3], eng["cab"][:, 3:6], o, d, tw)
    assert groups.float().mean() < 0.5
    assert groups.float().mean() < chunks.float().mean()


def _tie():
    pos, o, d = ds.tie_soup()
    tables = ds.pack_dense_stream(tri_mod.precompute(pos), None, None, pos)
    return tables, torch.from_numpy(o), torch.from_numpy(d)


def test_lowest_index_wins_ties_across_parts():
    """`dense_stream.tie_soup`: one triangle in parts 0 and 1, twice within
    one group of part 0; the plain version, the culled model and the public
    query pick row 1001 on every ray."""
    tables, o, d = _tie()
    assert tables["meta"]["nparts"] == 2 and o.shape[0] == N_JAX
    eng = ds.upload(tables, "cpu")
    g = np.array(ds.TIE_ROWS) // ds.QH
    assert g[0] == g[1] and ds.TIE_ROWS[-1] // ds.PART_TRIS == 1
    tl = torch.full((o.shape[0],), 3.0e38)
    pt, pi = ds.closest_plain(eng, o, d, tl)
    assert (pi == ds.TIE_ROWS[0]).all()
    ct, ci = ds.culled_closest_plain(eng, o, d, tl)
    assert torch.equal(ci, pi) and torch.equal(ct, pt)
    idx, t, _, _ = ds.dense_stream_closest_hit(eng, o, d, torch.full((o.shape[0],), np.inf))
    assert (idx == ds.TIE_ROWS[0]).all()


def test_tie_soup_matches_jax():
    """The tie soup through the JAX streamed engine (Pallas interpreter)
    picks the same lowest index."""
    tables, o, d = _tie()
    pos, _, _ = ds.tie_soup()
    j = jds.pack_dense_stream(jtri.precompute(pos), None, None, pos)
    jeng = {k: jnp.asarray(v) for k, v in j.items() if k != "meta"}
    tl = np.full(o.shape[0], np.inf, np.float32)
    res = jds.dense_stream_closest_hit_shade(jeng, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                             jnp.asarray(tl))
    assert (np.asarray(res[0]) == ds.TIE_ROWS[0]).all()
    for k in ds.JAX_TABLES:
        np.testing.assert_array_equal(tables[k], j[k], err_msg=k)


def test_table_without_qab_raises(soup):
    eng, _, _ = soup
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(4, 3).contiguous()
    tl = torch.full((4,), np.inf)
    bare = {k: eng[k] for k in ds.JAX_TABLES}
    with pytest.raises(ValueError, match="qab"):
        ds.dense_stream_closest_hit_shade(bare, o, d, tl)
    with pytest.raises(ValueError, match="qab"):
        ds.dense_stream_any_hit(bare, o, d, tl)
