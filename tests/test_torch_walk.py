"""The port's walk engine (``path_tracer_tpu_torch/trace/walk.py``) against
the JAX package's (``path_tracer_tpu/trace/walk.py``, its Pallas kernels
run in interpret mode) on one 9,248-triangle bumpy sphere: host tables bit
for bit, the coherence sort and the exit clamp, and the public queries (the
port's CPU path runs the plain versions of the kernels).

The JAX tables are built with its NumPy chunk partition (``native.available``
patched to False), the one the port carries over. Both sides compute the
candidate t in the same order with one rounding per op, so winners and
shading values agree exactly here; the tolerances below (rtol 2e-4, the
bound set for the dense engine against XLA's fused multiply-adds) allow for
an XLA build that fuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu import native
from path_tracer_tpu.scene import procedural as jproc
from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.trace import walk as jwalk
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene import triangle as ttri
from path_tracer_tpu_torch.trace import walk as twalk
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 2e-4


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine) over the same soup."""
    pos, nrm = jproc.bumpy_sphere(nu=68, nv=68)
    tpos, tnrm = tproc.bumpy_sphere(nu=68, nv=68)
    assert np.array_equal(pos, tpos) and np.array_equal(nrm, tnrm)
    model = (np.arange(pos.shape[0]) % 5).astype(np.int64)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        jnp_tables = jwalk.pack_walk(jtri.precompute(pos), nrm.reshape(-1, 9), model, pos)
    t_tables = twalk.pack_walk(ttri.precompute(tpos), tnrm.reshape(-1, 9), model.astype(np.float32), tpos)
    return jnp_tables, t_tables


def _rays(n, seed):
    """Half the rays aimed at the sphere from outside, half from inside in
    random directions (tests/test_walk.py's mix)."""
    rng = np.random.default_rng(seed)
    o1 = rng.standard_normal((n // 2, 3))
    o1 = o1 / np.linalg.norm(o1, axis=1, keepdims=True) * 3.0
    d1 = -o1 + rng.standard_normal((n // 2, 3)) * 0.15
    o2 = (rng.random((n - n // 2, 3)) - 0.5) * 2.0
    d2 = rng.standard_normal((n - n // 2, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _edge_lanes(o, d, tl, seed):
    """Dead (t_limit 0 or negative), finite-limit and NaN lanes."""
    rng = np.random.default_rng(seed)
    lanes = rng.permutation(o.shape[0])
    tl[lanes[:30]] = 0.0
    tl[lanes[30:40]] = -1.0
    tl[lanes[40:80]] = rng.uniform(0.5, 3.0, 40)
    o[lanes[80:90]] = np.nan
    d[lanes[90:100]] = np.nan
    return o, d, tl


def _both(engines):
    j, t = engines
    return {k: jnp.asarray(v) for k, v in j.items()}, {k: torch.from_numpy(v) for k, v in t.items()}


def _closest(engines, o, d, tl):
    je, te = _both(engines)
    j = [np.asarray(x) for x in jwalk.walk_closest_hit_shade(je, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl))]
    t = [x.numpy() for x in twalk.walk_closest_hit_shade(te, *map(torch.from_numpy, (o, d, tl)))]
    return j, t


def _on_edge(r):
    """Lanes whose hit lies on a triangle edge (a barycentric within 1e-6 of
    0): a ray through a shared edge is a knife edge, where a fused
    multiply-add on the JAX side and separate roundings on the port's can
    flip a sign test (seed 5 below has one: JAX misses through the crack,
    the port hits at v = 0, float64 hits the neighbour at the same t)."""
    return (r[0] >= 0) & (np.minimum(np.minimum(r[2], r[3]), 1.0 - r[2] - r[3]) < 1e-6)


def _assert_closest_agrees(j, t, edge_ok=False):
    assert t[0].dtype == np.int32 and t[5].dtype == np.int32
    same = t[0] == j[0]  # winners, in soup order
    if edge_ok:
        assert (same | _on_edge(j) | _on_edge(t)).all() and (~same).sum() <= 2
        j, t = [x[same] for x in j], [x[same] for x in t]
    else:
        assert same.all()
    np.testing.assert_array_equal(t[5], j[5])  # model ids
    hit = j[0] >= 0
    assert hit.sum() > 100
    for a, b in zip(t[1:5], j[1:5]):
        np.testing.assert_allclose(a[hit], b[hit], rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(t[1][~hit], j[1][~hit])  # t = t_limit on a miss


def test_pack_walk_bit_equal(engines):
    """(a) Every table the port keeps equals the JAX one bit for bit; the
    MXU plane table ``w`` and the mask-layout twins are dropped."""
    j, t = engines
    assert set(t) == set(j) - {"w", "cb_lay", "pos_valid"}
    for k in t:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert twalk.num_chunks(t) > 64


def test_coherence_order_and_exit_clamp(engines):
    """(b) The same sort permutation (dead and NaN lanes included) and the
    same exit-clamped limits."""
    je, te = _both(engines)
    o, d = _rays(512, seed=3)
    o, d, tl = _edge_lanes(o, d, np.full(512, np.inf, np.float32), seed=4)
    jo = jwalk._coherence_order(je, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl))
    to = twalk._coherence_order(te, *map(torch.from_numpy, (o, d, tl)))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jc = np.asarray(jwalk._exit_clamp(je, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl)))
    tc = twalk._exit_clamp(te, *map(torch.from_numpy, (o, d, tl))).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert (tc[np.isfinite(o).all(1) & np.isfinite(d).all(1) & (tl > 0)] < np.inf).all()


def test_closest_matches_jax(engines):
    """(c) 512 rays: winners and model ids equal, t/u/v/normal within RTOL."""
    o, d = _rays(512, seed=1)
    j, t = _closest(engines, o, d, np.full(512, np.inf, np.float32))
    _assert_closest_agrees(j, t)


@pytest.mark.parametrize("scale", [0.99, 1.01])
def test_any_hit_matches_jax(engines, scale):
    """(d) Shadow windows just short of and just past each ray's closest
    hit: flags equal to the JAX walk's, and to the closest hit's verdict."""
    je, te = _both(engines)
    o, d = _rays(512, seed=2)
    ti, tt = twalk.walk_closest_hit_shade(te, torch.from_numpy(o), torch.from_numpy(d),
                                          torch.full((512,), torch.inf))[:2]
    hit = (ti >= 0).numpy()
    lim = np.where(hit, tt.numpy() * scale, 1e-3).astype(np.float32)
    j = np.asarray(jwalk.walk_any_hit(je, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lim)))
    t = twalk.walk_any_hit(te, *map(torch.from_numpy, (o, d, lim))).numpy()
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, hit if scale > 1 else np.zeros_like(hit))


def test_ragged_dead_and_nan_lanes(engines):
    """(e) 333 lanes (not a multiple of the 128-ray block) with dead, NaN and
    finite-limit lanes: closest hit equal to the JAX walk's but on a ray
    through a shared edge (`_on_edge`), any hit equal; NaN and dead lanes
    never hit."""
    je, te = _both(engines)
    o, d = _rays(333, seed=5)
    o, d, tl = _edge_lanes(o, d, np.full(333, np.inf, np.float32), seed=6)
    j, t = _closest(engines, o, d, tl)
    _assert_closest_agrees(j, t, edge_ok=True)
    dead = ~(np.isfinite(o).all(1) & np.isfinite(d).all(1) & (tl > 0))
    assert (t[0][dead] == -1).all()
    ja = np.asarray(jwalk.walk_any_hit(je, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl)))
    ta = twalk.walk_any_hit(te, *map(torch.from_numpy, (o, d, tl))).numpy()
    assert ((ta == ja) | _on_edge(j) | _on_edge(t)).all() and (ta != ja).sum() <= 2
    assert not ta[dead].any() and ta.any()


def test_plain_closest_tie_goes_to_first_visited_chunk():
    """The plain closest hit's tie rule: among slots at the minimum t, the
    one first in the ray block's octant order wins (two chunks holding the
    same triangle; octant 0 visits chunk 1 first, octant 7 chunk 0)."""
    pos = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    pre = ttri.precompute(pos)
    row = np.concatenate([pre["n0"][0], pre["d0"][:1], pre["n1"][0], pre["d1"][:1],
                          pre["n2"][0], pre["d2"][:1]])
    aux = np.zeros((2 * twalk.CH_W, 24), np.float32)
    aux[5, :12] = row  # chunk 0, lane 5
    aux[twalk.CH_W + 7, :12] = row  # chunk 1, lane 7
    ord_oct = np.zeros((8, 128), np.int32)
    ord_oct[:, :2] = [1, 0]
    ord_oct[7, :2] = [0, 1]
    eng = {"aux": torch.from_numpy(aux), "ord_oct": torch.from_numpy(ord_oct)}
    n0 = dict(LAUNCHES)
    for sign, slot in ((1.0, twalk.CH_W + 7), (-1.0, 5)):
        o = torch.tensor([[0.1, 0.1, -2.0 * sign]]).repeat(3, 1)
        d = torch.tensor([[0.0, 0.0, sign]]).repeat(3, 1)
        if sign < 0:  # octant 7: every component negative
            d[:, :2] = -1e-3
        t, s = twalk.closest_plain(eng, o, d, torch.full((3,), 10.0))
        assert (s == slot).all() and torch.allclose(t, torch.full((3,), 2.0), rtol=1e-3)
    assert LAUNCHES == n0  # CPU tensors take the plain version: no launch
