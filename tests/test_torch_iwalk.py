"""The port's two-level engines (``path_tracer_tpu_torch/trace/iwalk.py``)
against the JAX package's (``path_tracer_tpu/trace/iwalk.py``, its Pallas
kernels run in interpret mode) on ``tests/test_iwalk.py``'s models: three
instances of a 3,200-triangle bumpy sphere and two of a box. Host tables bit
for bit, the public queries of both engines (the port's CPU path runs the
plain versions of the kernels), and the engine rule.

Both packages build with their NumPy chunk partitions (``native.available``
patched to False in both, ``tests/torch_builders.py``); at this size both JAX
packers give one part. Both sides transform the rays and compute the
candidate t in the same order with one rounding per op; the tolerances
(rtol 2e-4, and a ray through a shared edge may resolve differently) are
``tests/test_torch_walk.py``'s, for an XLA build that fuses multiply-adds.
The JAX side gets every ray set padded with dead lanes to 512 rays, so that
its interpret-mode kernels compile for one shape only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.scene import procedural as jproc
from path_tracer_tpu.scene.model import Model as JModel
from path_tracer_tpu.trace import iwalk as jiwalk
from path_tracer_tpu_torch.scene import procedural as tproc
from path_tracer_tpu_torch.scene import triangle as ttri
from path_tracer_tpu_torch.scene.model import Model as TModel
from path_tracer_tpu_torch.scene.model import rigid_transform, rotation_y
from path_tracer_tpu_torch.scene.twolevel_scene import TwoLevelGeometry
from path_tracer_tpu_torch.trace import iwalk as tiwalk
from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES
from torch_builders import numpy_builders  # noqa: F401  (autouse)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

RTOL = 2e-4
N_JAX = 512  # the one ray count the JAX side sees
ENGINES = ("vwalk", "iwalk")
# JAX keys the port does not keep: the MXU plane table, the part-local
# chunk ids (equal to vglob with one part) and the mask-layout twins
DROPPED = {"w", "vchunk", "cb_lay", "pos_valid"}


def _models(Model, procedural):
    """``tests/test_iwalk.py``'s models, in either package."""
    sp, sn = procedural.bumpy_sphere(nu=40, nv=40)
    bp, bn = procedural.box((0.0, 0.0, 0.0), (0.6, 0.6, 0.6))
    mats_a = [
        rigid_transform(rotation_y(0.5), (-2.0, 0.0, 0.0)),
        rigid_transform(rotation_y(1.7), (2.0, 0.3, 0.5)),
        rigid_transform(rotation_y(2.9), (0.0, -0.4, -2.0)),
    ]
    mats_b = [
        rigid_transform(rotation_y(0.9), (0.0, 1.8, 0.0)),
        rigid_transform(rotation_y(2.1), (0.0, 0.0, 2.2)),
    ]
    return [Model(None, matrices=mats_a, positions=sp, normals=sn),
            Model(None, matrices=mats_b, positions=bp, normals=bn)]


@pytest.fixture(scope="module")
def tables():
    """{engine: (JAX tables, port tables)} over the same models."""
    jm = _models(JModel, jproc)
    j = {"vwalk": jiwalk.pack_vwalk(jm), "iwalk": jiwalk.pack_iwalk(jm)}
    tm = _models(TModel, tproc)
    return {e: (j[e], getattr(tiwalk, f"pack_{e}")(tm)) for e in ENGINES}


def _rays(n, seed):
    """``tests/test_iwalk.py``'s rays: from a radius-6 sphere toward the
    centre, jittered."""
    rng = np.random.default_rng(seed)
    o = rng.standard_normal((n, 3))
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 6.0
    d = -o + rng.standard_normal((n, 3)) * 0.6
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jax(fn, eng, o, d, tl):
    """A JAX query on rays padded with dead lanes to ``N_JAX``."""
    n = o.shape[0]
    pad = lambda x: np.concatenate([x, np.zeros((N_JAX - n,) + x.shape[1:], x.dtype)])  # noqa: E731
    out = fn({k: jnp.asarray(v) for k, v in eng.items()},
             *(jnp.asarray(pad(x)) for x in (o, d, tl)))
    return [np.asarray(x)[:n] for x in out] if isinstance(out, tuple) else np.asarray(out)[:n]


def _port(fn, tables, o, d, tl):
    out = fn(tiwalk.upload(tables, "cpu"), *map(torch.from_numpy, (o, d, tl)))
    return [x.numpy() for x in out] if isinstance(out, tuple) else out.numpy()


def _on_edge(r):
    """Lanes whose hit lies on a triangle edge (a barycentric within 1e-6 of
    0): a knife edge, where a fused multiply-add on the JAX side and
    separate roundings on the port's can flip a sign test."""
    return (r[0] >= 0) & (np.minimum(np.minimum(r[2], r[3]), 1.0 - r[2] - r[3]) < 1e-6)


def _assert_closest_agrees(j, t, edge_ok=False):
    assert t[0].dtype == np.int32 and t[5].dtype == np.int32 and t[6].dtype == np.int32
    same = (t[0] == j[0]) & (t[6] == j[6])  # winner tri and instance
    if edge_ok:
        assert (same | _on_edge(j) | _on_edge(t)).all() and (~same).sum() <= 2
        j, t = [x[same] for x in j], [x[same] for x in t]
    else:
        assert same.all()
    hit = j[0] >= 0
    assert hit.sum() > 100
    np.testing.assert_array_equal(t[5][hit], j[5][hit])  # model ids
    for a, b in zip(t[1:5], j[1:5]):  # t, u, v, world normal
        np.testing.assert_allclose(a[hit], b[hit], rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(t[1][~hit], j[1][~hit])  # t = t_limit on a miss
    assert (t[6][~hit] == -1).all() and (t[6][hit] >= 0).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_pack_bit_equal(tables, engine):
    """(a) Every table the port keeps equals the JAX one bit for bit."""
    j, t = tables[engine]
    assert "parts" not in j
    assert set(t) == set(j) - DROPPED
    assert set(t) == set(tiwalk.VWALK_TABLES if engine == "vwalk" else tiwalk.IWALK_TABLES)
    for k in t:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    if engine == "vwalk":
        np.testing.assert_array_equal(j["vchunk"], j["vglob"])
    ranges = tables["iwalk"][0]["inst_c"]  # every instance's object chunk range
    pairs = int((ranges[:, 1] - ranges[:, 0]).sum())
    assert tiwalk.upload(t, "cpu")["gates"] == (pairs if engine == "vwalk" else 5)


@pytest.mark.parametrize("engine", ENGINES)
def test_closest_matches_jax(tables, engine):
    """(b) 512 rays: winner tri, instance and model equal; t/u/v and the
    world normal within RTOL."""
    o, d = _rays(512, seed=1)
    tl = np.full(512, np.inf, np.float32)
    j = _jax(jiwalk.iwalk_closest_hit_shade, tables[engine][0], o, d, tl)
    t = _port(tiwalk.iwalk_closest_hit_shade, tables[engine][1], o, d, tl)
    _assert_closest_agrees(j, t)


@pytest.mark.parametrize("engine", ENGINES)
def test_any_hit_matches_jax(tables, engine):
    """(c) Shadow windows just short of and just past each ray's closest
    hit: flags equal to the JAX engine's and to the closest hit's verdict."""
    o, d = _rays(512, seed=2)
    ti, tt = _port(tiwalk.iwalk_closest_hit_shade, tables[engine][1], o, d,
                   np.full(512, np.inf, np.float32))[:2]
    hit = ti >= 0
    for scale in (0.99, 1.01):
        lim = np.where(hit, tt * scale, 1e-3).astype(np.float32)
        j = _jax(jiwalk.iwalk_any_hit, tables[engine][0], o, d, lim)
        t = _port(tiwalk.iwalk_any_hit, tables[engine][1], o, d, lim)
        np.testing.assert_array_equal(t, j)
        np.testing.assert_array_equal(t, hit if scale > 1 else np.zeros_like(hit))


@pytest.mark.parametrize("engine", ENGINES)
def test_ragged_dead_and_nan_lanes(tables, engine):
    """(d) 333 lanes (not a multiple of the 128-ray block) with dead, NaN and
    finite-limit lanes: closest hit equal to the JAX engine's but on a ray
    through a shared edge, any hit equal; NaN and dead lanes never hit."""
    o, d = _rays(333, seed=5)
    rng = np.random.default_rng(6)
    tl = np.full(333, np.inf, np.float32)
    lanes = rng.permutation(333)
    tl[lanes[:30]] = 0.0
    tl[lanes[30:40]] = -1.0
    tl[lanes[40:80]] = rng.uniform(3.0, 6.0, 40)
    o[lanes[80:90]] = np.nan
    d[lanes[90:100]] = np.nan
    j = _jax(jiwalk.iwalk_closest_hit_shade, tables[engine][0], o, d, tl)
    t = _port(tiwalk.iwalk_closest_hit_shade, tables[engine][1], o, d, tl)
    _assert_closest_agrees(j, t, edge_ok=True)
    dead = ~(np.isfinite(o).all(1) & np.isfinite(d).all(1) & (tl > 0))
    assert (t[0][dead] == -1).all() and (t[6][dead] == -1).all()
    ja = _jax(jiwalk.iwalk_any_hit, tables[engine][0], o, d, tl)
    ta = _port(tiwalk.iwalk_any_hit, tables[engine][1], o, d, tl)
    assert ((ta == ja) | _on_edge(j) | _on_edge(t)).all() and (ta != ja).sum() <= 2
    assert not ta[dead].any() and ta.any()


def test_engines_agree_and_take_no_launch(tables):
    """vwalk and iwalk are one function: the same winners, instances and t
    (the JAX package's ``test_vwalk_matches_iwalk_and_multipart``), and CPU
    tensors run the plain versions (no kernel launch)."""
    o, d = _rays(384, seed=9)
    tl = np.full(384, np.inf, np.float32)
    n0 = dict(LAUNCHES)
    v = _port(tiwalk.iwalk_closest_hit_shade, tables["vwalk"][1], o, d, tl)
    i = _port(tiwalk.iwalk_closest_hit_shade, tables["iwalk"][1], o, d, tl)
    for a, b in zip(v, i):
        np.testing.assert_array_equal(a, b)
    far = np.where(v[0] >= 0, v[1] * 1.01, 1e-3).astype(np.float32)
    np.testing.assert_array_equal(_port(tiwalk.iwalk_any_hit, tables["vwalk"][1], o, d, far),
                                  _port(tiwalk.iwalk_any_hit, tables["iwalk"][1], o, d, far))
    assert LAUNCHES == n0


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_tie_goes_to_first_visited(engine):
    """The plain closest hit's tie rule: two instances of one triangle in
    the plane z = 0, 0.05 apart along x, tie on t where they overlap; the
    one whose gate entry (virtual chunk or instance) comes first in the ray
    block's octant order wins: the lower x for +x rays, the other for -x."""
    pos = np.array([[[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]], np.float32)
    mats = [rigid_transform(), rigid_transform(None, (0.05, 0.0, 0.0))]
    eng = tiwalk.upload(getattr(tiwalk, f"pack_{engine}")([TModel(None, mats, pos)]), "cpu")
    winners = []
    for sign, octant in ((1.0, 0), (-1.0, 7)):
        o = torch.tensor([[0.1, 0.1, -2.0 * sign]]).repeat(3, 1)
        d = torch.tensor([[1e-3 * sign, 1e-3 * sign, sign]]).repeat(3, 1)
        t, slot, inst = tiwalk.closest_plain(eng, o, d, torch.full((3,), 10.0))
        first = int(eng["ord_oct"][octant, 0])
        winners.append(int(eng["vinst"][first]) if engine == "vwalk" else first)
        assert (inst == winners[-1]).all() and (slot == 0).all()
        assert torch.allclose(t, torch.full((3,), 2.0), rtol=1e-3)
    assert winners == [0, 1]


def test_engine_rule(monkeypatch):
    """(e) vwalk by default; with vwalk's cap patched below the scene's
    virtual chunks, iwalk (asking for vwalk raises); with iwalk's cap
    patched down too, the gather engine (``tests/test_torch_twolevel.py``)."""
    models = _models(TModel, tproc)
    geo = TwoLevelGeometry(models)
    k_sphere = geo.num_chunks - 1  # the box is one chunk
    assert geo.engine == "vwalk" and geo.num_virtual_chunks == 3 * k_sphere + 2
    assert tiwalk.engine_name(geo.device("cpu")["iwalk"]) == "vwalk"
    assert tiwalk.engine_name(geo.device("cpu", engine="iwalk")["iwalk"]) == "iwalk"
    monkeypatch.setattr(tiwalk, "VWALK_MAX_VCH", geo.num_virtual_chunks - 1)
    geo = TwoLevelGeometry(models)
    assert geo.engine == "iwalk"
    with pytest.raises(ValueError):
        tiwalk.pack_vwalk(models)
    with pytest.raises(ValueError):
        geo.device("cpu", engine="vwalk")
    monkeypatch.setattr(tiwalk, "IWALK_MAX_TOTAL_CHUNKS", geo.num_chunks - 1)
    assert TwoLevelGeometry(models).engine == "gather"
    with pytest.raises(ValueError):
        tiwalk.pack_iwalk(models)


def test_precompute_matches_object_tables(tables):
    """The shared aux rows are the object-space plane rows of
    ``triangle.precompute``, one model after the other (pad rows zero)."""
    _, t = tables["iwalk"]
    sp = _models(TModel, tproc)[0].positions
    pre = ttri.precompute(sp)
    c0, c1 = t["inst_c"][0]  # the sphere's chunks
    rows = slice(c0 * 128, c1 * 128)
    real = (t["aux"][rows, :12] != 0).any(1)
    tri = t["origmap"][rows][real]
    assert real.sum() == sp.shape[0] and np.array_equal(np.sort(tri), np.arange(sp.shape[0]))
    np.testing.assert_array_equal(t["aux"][rows][real, 3], pre["d0"][tri])
