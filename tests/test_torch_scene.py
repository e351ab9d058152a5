"""Scene build, device tables and film I/O of the torch port against the JAX
package: host tables bit for bit, ``from_jax_scene`` against the port's own
``Scene.device``, and checkpoints/PNGs across the two packages."""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from path_tracer_tpu import film as jfilm
from path_tracer_tpu import scenes as jscenes
from path_tracer_tpu.scene import bvh as jbvh
from path_tracer_tpu.scene import envmap as jenv
from path_tracer_tpu.scene import triangle as jtri
from path_tracer_tpu.trace.dense_pallas import pack_dense_pl_aux
from path_tracer_tpu_torch import film as tfilm
from path_tracer_tpu_torch import scenes as tscenes
from path_tracer_tpu_torch.scene import envmap as tenv
from path_tracer_tpu_torch.scene.scene import from_jax_scene
from path_tracer_tpu_torch.trace.dense_cuda import pack_dense_aux
from torch_builders import numpy_builders  # noqa: F401  (autouse)

SCENES = ["cornell_diffuse", "cornell_specular", "cornell_volume", "mesh_scene"]


@pytest.fixture(scope="module", params=SCENES)
def both(request):
    """(JAX host scene, port host scene), both built with their NumPy SAH
    builders (``tests/torch_builders.py``): the JAX package's native
    library orders 38 of cornell_specular's triangles differently (a
    near-tie in the SAH cost), a different, equally valid order."""
    kw = {"aspect": 16 / 9}
    jsh, _ = getattr(jscenes, request.param)(**kw)
    tsh, _ = getattr(tscenes, request.param)(**kw)
    return jsh, tsh


def _assert_same(a, b, where):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=where)


def test_host_tables_bit_equal(both):
    jsh, tsh = both
    assert tsh.num_world_tris == jsh.num_world_tris
    assert tsh.active_mtypes == jsh.active_mtypes and tsh.has_volumes == jsh.has_volumes
    for k in ("n0", "d0", "n1", "d1", "n2", "d2", "area", "normals", "positions", "mat", "model"):
        _assert_same(jsh.tri[k], tsh.tri[k], f"tri.{k}")
    for k in ("n0", "d0", "n1", "d1", "n2", "d2", "area", "normals", "positions", "mat",
              "emitted", "pdf", "cdf"):
        _assert_same(jsh.light[k], tsh.light[k], f"light.{k}")
    for k in jsh.mat:
        _assert_same(jsh.mat[k], tsh.mat[k], f"mat.{k}")
    _assert_same(jsh.env, tsh.env, "env")


def test_bvh_permutation_equal(both):
    """The port's SAH builder orders the world soup exactly as the JAX
    package's NumPy builder does."""
    jsh, tsh = both
    pos = tsh.tri["positions"]
    soup = np.empty_like(pos)
    soup[tsh.perm] = pos  # undo the permutation
    bmin, bmax = jtri.aabbs(soup)
    np.testing.assert_array_equal(jbvh.build_bvh(bmin, bmax)[1], tsh.perm)


def test_dense_tables_bit_equal(both):
    """The port's aux tables are the first T rows of the JAX dense_pl aux
    tables (the rest are JAX's zero pad rows up to its chunk width)."""
    jsh, tsh = both
    t = tsh.num_world_tris
    nf, model = tsh.tri["normals"].reshape(t, 9), tsh.tri["model"]
    jaux = pack_dense_pl_aux(jsh.tri, nf, model)
    _assert_same(jaux[:t], pack_dense_aux(tsh.tri, nf, model), "aux")
    assert not jaux[t:].any()
    lt = tsh.light["n0"].shape[0]
    jlaux = pack_dense_pl_aux(jsh.light)
    _assert_same(jlaux[:lt], pack_dense_aux(tsh.light), "light aux")
    assert not jlaux[lt:].any()


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_from_jax_scene_equals_port_device(both):
    """``from_jax_scene`` of the JAX device dict gives the same tensors, bit
    for bit, as the port's own ``Scene.device``."""
    jsh, tsh = both
    jd = jax.tree_util.tree_map(np.asarray, jsh.device())
    a, b = _flat(from_jax_scene(jd, "cpu")), _flat(tsh.device("cpu"))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert torch.equal(a[k], b[k]), k


def test_from_jax_scene_round_trip(both):
    """Every table the port reads from the JAX dict comes out unchanged, and
    its dense table is the JAX dense_pl aux table."""
    jsh, _ = both
    jd = jax.tree_util.tree_map(np.asarray, jsh.device())
    t = from_jax_scene(jd, "cpu")
    _assert_same(jd["tri"]["normals_flat"], t["tri"]["normals_flat"].numpy(), "normals_flat")
    _assert_same(jd["tri"]["model_rows"], t["tri"]["model_rows"].numpy(), "model_rows")
    _assert_same(jd["mat"]["rows"], t["mat"]["rows"].numpy(), "mat rows")
    _assert_same(jd["env"], t["env"].numpy(), "env")
    for k in ("cdf", "rows", "normals_flat", "positions_flat"):
        _assert_same(jd["light"][k], t["light"][k].numpy(), f"light.{k}")
    n = jsh.num_world_tris
    aux = pack_dense_pl_aux(jsh.tri, jsh.tri["normals"].reshape(n, 9), jsh.tri["model"])
    _assert_same(aux[:n], t["tri"]["dense"]["aux"].numpy(), "dense aux")
    lt = jd["light"]["cdf"].shape[0]
    _assert_same(pack_dense_pl_aux(jsh.light)[:lt], t["light"]["dense"]["aux"].numpy(), "light dense aux")


def _film(seed=0, h=6, w=10):
    r = np.random.default_rng(seed)
    f = r.exponential(1.0, (h, w, 4)).astype(np.float32)
    f[..., 3] = 7.0
    return f


def test_checkpoint_port_to_jax(tmp_path):
    f = _film(1)
    path = tmp_path / "port.npz"
    tfilm.save_checkpoint(path, torch.from_numpy(f), 7, meta={"scene": "mesh_scene"})
    film, nxt = jfilm.load_checkpoint(path)
    np.testing.assert_array_equal(np.asarray(film), f)
    assert nxt == 7 and str(np.load(path)["meta_scene"]) == "mesh_scene"


def test_checkpoint_jax_to_port(tmp_path):
    f = _film(2)
    path = tmp_path / "jax.npz"
    jfilm.save_checkpoint(path, f, 9)
    film, nxt = tfilm.load_checkpoint(path, "cpu")
    assert film.dtype == torch.float32
    np.testing.assert_array_equal(film.numpy(), f)
    assert nxt == 9


def test_png_matches_jax(tmp_path):
    """The port's stdlib PNG decodes to the JAX package's PIL image (one
    8-bit level of slack for tonemap ulps)."""
    f = _film(3, h=9, w=13)
    jfilm.save_png(tmp_path / "j.png", f)
    tfilm.save_png(tmp_path / "t.png", torch.from_numpy(f))
    a = np.asarray(Image.open(tmp_path / "j.png")).astype(int)
    b = np.asarray(Image.open(tmp_path / "t.png")).astype(int)
    assert a.shape == b.shape == (9, 13, 3)
    assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("shape", [(1, 1), (8, 16)])
def test_sample_environment_matches(shape):
    """The miss shader's equirect lookup (constant background and the plain
    bilinear path) against the JAX package's."""
    r = np.random.default_rng(21)
    env = r.uniform(0.0, 4.0, shape + (3,)).astype(np.float32)
    d = r.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    j = np.asarray(jenv.sample_environment(env, d))
    t = tenv.sample_environment(torch.from_numpy(env), torch.from_numpy(d)).numpy()
    # atan2/asin may differ by an ulp, which the uv -> texel scale magnifies
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)


def test_large_sky_plain_bilinear_matches_jax_quad():
    """A sky above the JAX package's quad-table threshold (65,536 texels;
    dragon_scene's is 2048x4096) goes through the port's plain bilinear
    path, which gives the JAX quad-table fetch's values: the same texels and
    the same blend (within XLA's fused multiply-adds), on the same uv."""
    env = tscenes.procedural_sky(256)
    np.testing.assert_array_equal(env, jscenes.procedural_sky(256))
    h, w = env.shape[:2]
    assert h * w >= 65536
    sh, _ = tscenes.cornell_diffuse()
    sh.env = env
    assert sh.device("cpu")["env"].shape == (h, w, 3)  # no quad table in the port
    r = np.random.default_rng(5)
    u = r.uniform(0.0, 1.0, 4096).astype(np.float32)
    v = r.uniform(0.0, 1.0, 4096).astype(np.float32)
    j = np.asarray(jenv.get_pixel_bilinear_quad(jenv.build_quad_table(env), h, w, u, v))
    np.testing.assert_array_equal(j, np.asarray(jenv.get_pixel_bilinear(env, u, v)))
    t = tenv.get_pixel_bilinear(torch.from_numpy(env), torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-6, atol=1e-6)
