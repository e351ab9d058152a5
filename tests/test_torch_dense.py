"""The port's dense closest/any-hit against the JAX ``dense_pl_*`` engine
(Pallas interpreter on the CPU), on the 700-triangle multi-chunk setup of
``test_dense_pallas.py``.

Tolerances: winners and model ids exact; t/u/v at rtol 2e-4, atol 5e-6 (the
tolerance ``test_dense_pallas.py`` holds the Pallas kernel to against its
brute-force oracle: XLA may fuse the epilogue's products and sums, which
torch rounds one by one, and u/v near 0 keep that as relative error). The
interpolated normal inherits u/v's rounding, so it is held to the same
tolerance against JAX, and to rtol/atol 1e-6 against the barycentric
interpolation of the JAX aux rows at the port's own (u, v). Any-hit flags are compared where
t_limit > 0 (the JAX kernel may flag a 0 < t < EPSILON hit on a zero-extent
lane, which its callers ignore).

The kernels themselves are checked against these plain versions on the card
by ``tests/test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu.scene import triangle as tri_mod
from path_tracer_tpu.trace.dense_pallas import (
    dense_pl_any_hit,
    dense_pl_closest_hit_shade,
    pack_dense_pl,
    pack_dense_pl_aux,
    pack_dense_pl_cab,
)
from path_tracer_tpu.trace.traversal import brute_force_closest as jbrute
from path_tracer_tpu.trace.traversal import pack_tris
from path_tracer_tpu_torch import cli, profile_render
from path_tracer_tpu_torch.trace import dense_cuda as dc
from path_tracer_tpu_torch.trace.traversal import brute_force_closest

TUV = dict(rtol=2e-4, atol=5e-6)
NRM = dict(rtol=1e-6, atol=1e-6)


def _tables(pos, normals_flat, model):
    tri = dict(tri_mod.precompute(pos))
    jeng = {
        "w": jnp.asarray(pack_dense_pl(tri)),
        "aux": jnp.asarray(pack_dense_pl_aux(tri, normals_flat, model)),
        "cab": jnp.asarray(pack_dense_pl_cab(pos)),
    }
    teng = {"aux": torch.from_numpy(dc.pack_dense_aux(tri, normals_flat, model)),
            "cab": torch.from_numpy(dc.pack_dense_cab(pos))}
    return tri, jeng, teng


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    t = 700  # several 512-wide chunks on the JAX side
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-0.3, 0.3, (t, 3)).astype(np.float32)
    pos = np.stack([v0, v1, v2], axis=1)
    normals_flat = rng.normal(size=(t, 9)).astype(np.float32)
    model = rng.integers(0, 5, t).astype(np.int32)
    tri, jeng, teng = _tables(pos, normals_flat, model)
    n = 200
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tri, jeng, teng, o, d


def _both_closest(jeng, teng, o, d, tl):
    j = [np.asarray(x) for x in dense_pl_closest_hit_shade(jeng, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl))]
    t = [x.numpy() for x in dc.dense_closest_hit_shade(teng, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl))]
    return j, t


def _assert_closest_equal(j, t, jaux):
    np.testing.assert_array_equal(t[0], j[0])  # winner
    hit = j[0] >= 0
    assert hit.sum() > 20
    for k in (1, 2, 3, 4):  # t, u, v, normal
        np.testing.assert_allclose(t[k][hit], j[k][hit], **TUV)
    rows = np.asarray(jaux)[t[0][hit]]
    u, v = t[2][hit][:, None], t[3][hit][:, None]
    interp = (1.0 - u - v) * rows[:, 12:15] + u * rows[:, 15:18] + v * rows[:, 18:21]
    np.testing.assert_allclose(t[4][hit], interp, **NRM)
    np.testing.assert_array_equal(t[5][hit], j[5][hit])  # model
    np.testing.assert_array_equal(t[1][~hit], j[1][~hit])  # t = t_limit on a miss


def test_closest_matches_jax(setup):
    _, jeng, teng, o, d = setup
    tl = np.full(o.shape[0], 1e30, np.float32)
    _assert_closest_equal(*_both_closest(jeng, teng, o, d, tl), jeng["aux"])


def test_closest_finite_limits_match_jax(setup):
    _, jeng, teng, o, d = setup
    tl = np.random.default_rng(8).uniform(0.0, 2.0, o.shape[0]).astype(np.float32)
    _assert_closest_equal(*_both_closest(jeng, teng, o, d, tl), jeng["aux"])


def test_inf_limit_equals_1e30(setup):
    """The integrator passes t_limit = inf; the port clamps it like the JAX
    wrapper and finds the same hits as with 1e30."""
    _, jeng, teng, o, d = setup
    big = np.full(o.shape[0], 1e30, np.float32)
    inf = np.full(o.shape[0], np.inf, np.float32)
    j, t_inf = _both_closest(jeng, teng, o, d, inf)
    _, t_big = _both_closest(jeng, teng, o, d, big)
    _assert_closest_equal(j, t_inf, jeng["aux"])
    np.testing.assert_array_equal(t_inf[0], t_big[0])
    hit = t_inf[0] >= 0
    np.testing.assert_array_equal(t_inf[1][hit], t_big[1][hit])
    assert np.isinf(t_inf[1][~hit]).all()


def test_closest_matches_brute_force(setup):
    """The dense plain version against the sequential oracle of both
    packages."""
    tri, _, teng, o, d = setup
    tl = np.full(o.shape[0], 1e30, np.float32)
    jb = jbrute({"packed": jnp.asarray(pack_tris(tri))}, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl))
    tb = brute_force_closest(teng["aux"], torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl))
    pb = dc.dense_closest_hit(teng, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl))
    np.testing.assert_array_equal(tb[0].numpy(), np.asarray(jb[0]))
    np.testing.assert_array_equal(pb[0].numpy(), tb[0].numpy())
    hit = tb[0].numpy() >= 0
    for k in (1, 2, 3):
        np.testing.assert_allclose(tb[k].numpy()[hit], np.asarray(jb[k])[hit], **TUV)
        np.testing.assert_allclose(pb[k].numpy()[hit], tb[k].numpy()[hit], **TUV)


def test_any_matches_jax(setup):
    _, jeng, teng, o, d = setup
    r = np.random.default_rng(9)
    tl = r.uniform(0.0, 2.5, o.shape[0]).astype(np.float32)
    tl[:20] = 0.0
    tl[20:30] = -1.0
    tl[30:40] = np.inf
    j = np.asarray(dense_pl_any_hit(jeng, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tl)))
    t = dc.dense_any_hit(teng, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tl)).numpy()
    pos = tl > 0
    np.testing.assert_array_equal(t[pos], j[pos])
    assert not t[~pos].any()
    assert 10 < t[pos].sum() < pos.sum()


def test_any_hit_window(setup):
    """Limit just past the closest hit -> occluded; just before -> not."""
    _, _, teng, o, d = setup
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    best, t, _, _ = dc.dense_closest_hit(teng, to, td, torch.full((o.shape[0],), 1e30))
    hit = best >= 0
    assert bool(dc.dense_any_hit(teng, to[hit], td[hit], t[hit] * 1.001).all())
    assert not bool(dc.dense_any_hit(teng, to[hit], td[hit], t[hit] * 0.999).any())


def test_lowest_index_wins_ties():
    """A triangle duplicated at several table positions: both packages
    report the lowest index."""
    rng = np.random.default_rng(11)
    t = 300
    v0 = rng.uniform(-1, 1, (t, 3)).astype(np.float32) + np.float32([0, 0, 3])  # behind the wall
    pos = np.stack([v0, v0 + 0.2 * rng.random((t, 3), np.float32), v0 + 0.2 * rng.random((t, 3), np.float32)], 1)
    pos[[17, 150, 299]] = np.array([[-5, -5, 0], [5, -5, 0], [0, 5, 0]], np.float32)  # one wall, 3 times
    nf = rng.normal(size=(t, 9)).astype(np.float32)
    _, jeng, teng = _tables(pos, nf, np.arange(t, dtype=np.int32))
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, :2] = rng.uniform(-1, 1, (n, 2))
    o[:, 2] = -1.0
    d = np.tile(np.float32([0, 0, 1]), (n, 1))
    j, tr = _both_closest(jeng, teng, o, d, np.full(n, np.inf, np.float32))
    assert (tr[0] == 17).all()
    _assert_closest_equal(j, tr, jeng["aux"])


def test_nan_rays_report_no_hit(setup):
    _, _, teng, o, d = setup
    o, d = o.copy(), d.copy()
    o[:5] = np.nan
    d[5:10] = np.nan
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tl = torch.full((o.shape[0],), np.inf)
    best = dc.dense_closest_hit(teng, to, td, tl)[0]
    assert (best[:10] == -1).all()
    assert not dc.dense_any_hit(teng, to, td, tl)[:10].any()


def test_cpu_tensors_never_launch(setup):
    """On the CPU the wrappers run the plain versions and count no launch;
    the kernel entry points refuse tensors that are not on a card."""
    _, _, teng, o, d = setup
    before = dict(dc.LAUNCHES)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    tl = torch.full((o.shape[0],), np.inf)
    dc.dense_closest_hit_shade(teng, to, td, tl)
    dc.dense_any_hit(teng, to, td, tl)
    assert dc.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        dc.closest_cuda(teng, to, td, tl)
    with pytest.raises(ValueError, match="CUDA"):
        dc.any_cuda(teng, to, td, tl)


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--scene", "cornell_diffuse", "--width", "8", "--height", "8", "--spp", "1",
                  "--out", str(tmp_path / "x.png"), "--device", "cuda"])


def test_profile_render_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the profile runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_render.main(["--width", "8", "--height", "8", "--spp", "1",
                             "--out-dir", str(tmp_path)])
