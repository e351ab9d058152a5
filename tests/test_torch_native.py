"""The port's native host builder (``path_tracer_tpu_torch/csrc/pt_native.cpp``
through ``path_tracer_tpu_torch/native.py``) against the JAX package's
native library and against the port's NumPy builders: OBJ parsing, the SAH
build and the walk engine's chunk partition, bit for bit (an OBJ file's
normals to one ulp), as ``tests/test_native.py`` holds the JAX package's;
its build into
``_build/`` and the NumPy fallback without g++; and the call sites that
take it (`scene.scene._sah_tree`, `scene.bvh.chunk_partition`,
`scene.model.Model`). Skips only without g++.
"""

import os
import shutil
import time

import numpy as np
import pytest

from path_tracer_tpu import native as jnative
from path_tracer_tpu.scene import objio as jobjio
from path_tracer_tpu_torch import native
from path_tracer_tpu_torch.scene import bvh, objio, procedural, triangle
from path_tracer_tpu_torch.scene import scene as tscene
from path_tracer_tpu_torch.scene.materials import Lambertian
from path_tracer_tpu_torch.scene.model import Model

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KNOT = os.path.join(REPO, "assets", "knot.obj")
SIZES = [1, 2, 5, 64, 500, 2000]


def _boxes(n):
    rs = np.random.default_rng(n)
    centers = rs.uniform(-50, 50, (n, 3)).astype(np.float32)
    half = rs.uniform(0.01, 2.0, (n, 3)).astype(np.float32)
    return centers - half, centers + half


def _assert_flat_equal(a, b):
    np.testing.assert_array_equal(a[1], b[1])  # perm
    assert a[2] == b[2]  # depth
    assert a[0].keys() == b[0].keys()
    for key in a[0]:
        assert a[0][key].dtype == b[0][key].dtype, key
        np.testing.assert_array_equal(a[0][key], b[0][key], err_msg=key)


def _quad_obj(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("# quads, negative indices, vn refs\n"
                 "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvn 0 0 2\n"
                 "f -4//-1 -3//-1 -2//-1 -1//-1\n"
                 "v 0 0 1\nv 2 0 1\nv 2 2 1\nv 0 2 1\nv 1 3 1\nf 5 6 7 8 9\n")
    return p


def test_available_and_built_here():
    assert native.available()
    assert native.lib_path().parent == native.BUILD_DIR and native.lib_path().exists()


@pytest.mark.parametrize("n", SIZES)
def test_bvh_build_matches_jax_native(n):
    bmin, bmax = _boxes(n)
    _assert_flat_equal(native.build_bvh(bmin, bmax), jnative.build_bvh(bmin, bmax))


@pytest.mark.parametrize("n", SIZES)
def test_chunk_build_matches_jax_native(n):
    bmin, bmax = _boxes(n)
    for cap in (128, 7):
        for a, b in zip(native.chunk_partition(bmin, bmax, cap),
                        jnative.chunk_partition(bmin, bmax, cap)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", SIZES)
def test_bvh_build_matches_numpy(n):
    """The port's native SAH build against its NumPy builder (flattened,
    with the tree's depth), as tests/test_native.py holds the JAX one's."""
    bmin, bmax = _boxes(n)
    _assert_flat_equal(native.build_bvh(bmin, bmax), bvh.build_bvh(bmin, bmax))


def test_chunk_partition_matches_numpy():
    pos, _ = procedural.bumpy_sphere(nu=64, nv=64)  # 8,192 tris
    bmin, bmax = triangle.aabbs(pos)
    for cap in (128, 1024, 7):
        got = native.chunk_partition(bmin, bmax, cap)
        for a, b in zip(got, bvh.chunk_partition_py(bmin, bmax, cap)):
            np.testing.assert_array_equal(a, b)
        assert (got[2] <= cap).all() and got[2].sum() == pos.shape[0]


def test_cornell_specular_order_matches_numpy():
    """cornell_specular's world soup, where the JAX library (``-march=native``:
    fused multiply-adds in the surface areas) orders 38 triangles otherwise:
    the port's library orders it as the NumPy builder does."""
    from path_tracer_tpu_torch import scenes

    sh, _ = scenes.cornell_specular()
    soup = np.empty_like(sh.tri["positions"])
    soup[sh.perm] = sh.tri["positions"]
    bmin, bmax = triangle.aabbs(soup)
    _assert_flat_equal(native.build_bvh(bmin, bmax), bvh.build_bvh(bmin, bmax))


def test_parallel_build_bit_identical(monkeypatch):
    """The threaded top level makes the serial build's decisions."""
    pos, _ = procedural.bumpy_sphere(nu=64, nv=64)
    bmin, bmax = triangle.aabbs(pos)
    monkeypatch.setenv("PT_NATIVE_THREADS", "1")
    serial = native.build_bvh(bmin, bmax), native.chunk_partition(bmin, bmax, 1024)
    monkeypatch.setenv("PT_NATIVE_THREADS", "5")
    monkeypatch.setenv("PT_NATIVE_PAR_MIN", "512")
    threaded = native.build_bvh(bmin, bmax), native.chunk_partition(bmin, bmax, 1024)
    _assert_flat_equal(serial[0], threaded[0])
    for a, b in zip(serial[1], threaded[1]):
        np.testing.assert_array_equal(a, b)


def test_large_build_speed():
    pos, _ = procedural.icosphere(subdivisions=5)  # 20,480 tris
    bmin, bmax = triangle.aabbs(pos)
    t0 = time.perf_counter()
    _, perm, depth = native.build_bvh(bmin, bmax)
    assert time.perf_counter() - t0 < 2.0
    assert np.array_equal(np.sort(perm), np.arange(pos.shape[0])) and depth <= 48


@pytest.mark.parametrize("which", ["knot", "quads"])
def test_obj_load_matches_jax_and_numpy(tmp_path, which):
    """Positions bit for bit against the JAX package's native parser and
    both NumPy parsers. Normals within one ulp: a ``vn`` record is
    normalized by its length, which the JAX library (compiled with
    ``-march=native``) computes with fused multiply-adds, NumPy through
    ``np.linalg.norm``, and the port's library with one rounding per op."""
    path = KNOT if which == "knot" else _quad_obj(tmp_path)
    got = native.load_obj(path)
    for want in (jnative.load_obj(path), objio.load_obj(path), jobjio.load_obj(path)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_max_ulp(got[1], want[1], maxulp=1)


def test_obj_load_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_obj(tmp_path / "none.obj")


def test_build_into_a_fresh_directory(tmp_path, monkeypatch):
    """The build writes a temporary file and moves it into place: nothing
    else is left in the build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    lib = native.build()
    assert lib is not None and lib.exists() and lib.parent == tmp_path / "_build"
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    assert native.build() == lib  # built once


def test_without_gxx_the_numpy_builders_run(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.build() is None and not native.available()
    pos, nrm = objio.load_obj(KNOT)
    m = Model(Lambertian((0.5, 0.5, 0.5)), file_path=KNOT)
    np.testing.assert_array_equal(m.positions, pos)
    np.testing.assert_array_equal(m.normals, nrm)
    flat, perm, depth = tscene._sah_tree(pos)
    _assert_flat_equal((flat, perm, depth), bvh.build_bvh(*triangle.aabbs(pos)))


def test_call_sites_take_the_native_builder():
    """With g++ the scene's SAH build, the chunk partition and the OBJ
    model go through the native library."""
    m = Model(Lambertian((0.5, 0.5, 0.5)), file_path=KNOT)
    np.testing.assert_array_equal(m.positions, native.load_obj(KNOT)[0])
    bmin, bmax = triangle.aabbs(m.positions)
    _assert_flat_equal(tscene._sah_tree(m.positions), native.build_bvh(bmin, bmax))
    for a, b in zip(bvh.chunk_partition(bmin, bmax, 128), native.chunk_partition(bmin, bmax, 128)):
        np.testing.assert_array_equal(a, b)
