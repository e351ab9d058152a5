"""core/ and camera of the torch port against the JAX package, on identical
NumPy inputs: the integer stages bit for bit, the float stages at f32
tolerance (rtol 1e-6, atol 1e-6: one or two ulps of the transcendentals)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from path_tracer_tpu import camera as jcam
from path_tracer_tpu.core import onb as jonb
from path_tracer_tpu.core import rng as jrng
from path_tracer_tpu.core import sobol as jsobol
from path_tracer_tpu.core import tonemap as jtm
from path_tracer_tpu.core import vecmath as jvm
from path_tracer_tpu_torch import camera as tcam
from path_tracer_tpu_torch.core import onb as tonb
from path_tracer_tpu_torch.core import rng as trng
from path_tracer_tpu_torch.core import sobol as tsobol
from path_tracer_tpu_torch.core import tonemap as ttm
from path_tracer_tpu_torch.core import vecmath as tvm

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-6, atol=1e-6)


def _counters(n=4096, seed=0):
    """Four rows of u32 counters: random, the 64 values just below 2^32,
    and 0..63."""
    r = np.random.default_rng(seed)
    c = r.integers(0, 2**32, size=(4, n), dtype=np.uint64)
    c[:, :64] = (2**32 - 1) - np.arange(64)
    c[:, 64:128] = np.arange(64)
    return c.astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _u(x):
    return np.asarray(x).astype(np.int64)


def test_pcg4d_bit_exact():
    c = _counters()
    j = jrng.pcg4d(*[jnp.asarray(v) for v in c])
    t = trng.pcg4d(*[_t(v) for v in c])
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_u(a), b.numpy())


@pytest.mark.parametrize("stream", [0, 11])
def test_uniform4_bit_exact(stream):
    c = _counters(seed=1)
    j = jrng.uniform4(jnp.asarray(c[0]), jnp.asarray(c[1]), jnp.asarray(c[2]), stream)
    t = trng.uniform4(_t(c[0]), _t(c[1]), _t(c[2]), stream)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("name", ["reverse_bits", "sobol_y", "low_bias_hash"])
def test_sobol_unary_bit_exact(name):
    c = _counters(seed=2)[0]
    np.testing.assert_array_equal(
        _u(getattr(jsobol, name)(jnp.asarray(c))), getattr(tsobol, name)(_t(c)).numpy()
    )


def test_lk_hash_bit_exact():
    c = _counters(seed=3)
    np.testing.assert_array_equal(
        _u(jsobol.lk_hash(jnp.asarray(c[0]), jnp.asarray(c[1]))),
        tsobol.lk_hash(_t(c[0]), _t(c[1])).numpy(),
    )


def test_get_ss_sobol_bit_exact():
    c = _counters(seed=4)
    j = jsobol.get_ss_sobol(jnp.asarray(c[0]), jnp.asarray(c[1]))
    t = tsobol.get_ss_sobol(_t(c[0]), _t(c[1]))
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


def _vecs(n=512, seed=5, unit=True):
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)).astype(np.float32)
    if unit:
        v /= np.linalg.norm(v, axis=1, keepdims=True)
    return v


def test_vecmath_matches():
    a, b = _vecs(seed=6, unit=False), _vecs(seed=7)
    i, n = _vecs(seed=8), _vecs(seed=9)
    eta = np.random.default_rng(10).uniform(0.5, 1.6, a.shape[0]).astype(np.float32)
    t = np.random.default_rng(11).uniform(0, 100, a.shape[0]).astype(np.float32)
    ta, tb, ti, tn = (torch.from_numpy(x) for x in (a, b, i, n))
    np.testing.assert_allclose(tvm.dot(ta, tb).numpy(), np.asarray(jvm.dot(a, b)), **TOL)
    np.testing.assert_allclose(tvm.normalize(ta).numpy(), np.asarray(jvm.normalize(a)), **TOL)
    np.testing.assert_allclose(tvm.reflect(ti, tn).numpy(), np.asarray(jvm.reflect(i, n)), **TOL)
    jr, jtir = jvm.refract(i, n, eta)
    tr, ttir = tvm.refract(ti, tn, torch.from_numpy(eta))
    np.testing.assert_array_equal(ttir.numpy(), np.asarray(jtir))
    ok = ~np.asarray(jtir)
    assert ok.sum() > 100 and (~ok).sum() > 10
    np.testing.assert_allclose(tr.numpy()[ok], np.asarray(jr)[ok], **TOL)
    u = np.random.default_rng(12).uniform(0, 1, (2, a.shape[0])).astype(np.float32)
    np.testing.assert_allclose(
        tvm.random_cosine_vector(torch.from_numpy(u[0]), torch.from_numpy(u[1])).numpy(),
        np.asarray(jvm.random_cosine_vector(u[0], u[1])), **TOL,
    )
    np.testing.assert_allclose(
        tvm.ray_at(ta, tb, torch.from_numpy(t)).numpy(), np.asarray(jvm.ray_at(a, b, t)), rtol=1e-6, atol=1e-4
    )


@pytest.mark.parametrize("name", ["cross", "length_sq", "transform_point", "transform_vector",
                                  "StreamCounter"])
def test_helpers_match(name):
    """The helpers the JAX package's own code never calls (its tests and
    benches do), against the JAX functions on the same inputs."""
    if name == "StreamCounter":
        j, t = jrng.StreamCounter(3), trng.StreamCounter(3)
        assert [t.next() for _ in range(5)] == [j.next() for _ in range(5)] == [3, 4, 5, 6, 7]
        return
    a, b = _vecs(seed=13, unit=False), _vecs(seed=14, unit=False)
    mat = np.random.default_rng(15).normal(size=(3, 4)).astype(np.float32)
    args = {"cross": (a, b), "length_sq": (a,), "transform_point": (mat, a),
            "transform_vector": (mat, b)}[name]
    want = np.asarray(getattr(jvm, name)(*args))
    got = getattr(tvm, name)(*map(torch.from_numpy, args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_onb_matches():
    n = _vecs(seed=13)
    n[:8] = [[0, 0, 1]] * 4 + [[0, 0, -1]] * 4  # poles
    v = _vecs(seed=14)
    v[:4] = [0.0, 0.0, 1.0]  # the GGX basis's singular branch
    tn, tv = torch.from_numpy(n), torch.from_numpy(v)
    for jf, tf, x, tx in ((jonb.generate_onb, tonb.generate_onb, n, tn),
                          (jonb.generate_onb_ggx, tonb.generate_onb_ggx, v, tv)):
        jb, tb = np.asarray(jf(x)), tf(tx)
        np.testing.assert_allclose(tb.numpy(), jb, **TOL)
        np.testing.assert_allclose(
            tonb.onb_apply(tb, tv).numpy(), np.asarray(jonb.onb_apply(jb, v)), **TOL)
        np.testing.assert_allclose(
            tonb.onb_apply_transpose(tb, tv).numpy(),
            np.asarray(jonb.onb_apply_transpose(jb, v)), **TOL)


def test_tonemap_matches():
    x = np.concatenate([
        np.linspace(-1.0, 3.0, 2001, dtype=np.float32),
        np.random.default_rng(15).exponential(2.0, 1000).astype(np.float32),
    ])
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(ttm.gt_tonemap(tx).numpy(), np.asarray(jtm.gt_tonemap(x)), **TOL)
    np.testing.assert_allclose(
        ttm.tonemap_to_srgb(tx).numpy(), np.asarray(jtm.tonemap_to_srgb(x)), **TOL)


def test_ray_directions_match():
    jc = jcam.Camera((0.0, 277.5, 1300.0), (0.0, 277.5, 0.0), fov=40.0, aspect_ratio=16 / 9)
    tc = tcam.Camera((0.0, 277.5, 1300.0), (0.0, 277.5, 0.0), fov=40.0, aspect_ratio=16 / 9)
    np.testing.assert_array_equal(tc.view_proj_inverse(), jc.view_proj_inverse())
    s, t = np.random.default_rng(16).uniform(0, 1, (2, 1000)).astype(np.float32)
    m, o = jc.view_proj_inverse(), jc.origin
    j = jcam.ray_directions(jnp.asarray(m), jnp.asarray(o), jnp.asarray(s), jnp.asarray(t))
    d = tcam.ray_directions(torch.from_numpy(m), torch.from_numpy(o), torch.from_numpy(s), torch.from_numpy(t))
    np.testing.assert_allclose(d.numpy(), np.asarray(j), **TOL)


def test_port_imports_without_jax():
    """The port and its CLI import with jax blocked (``sys.modules['jax'] =
    None`` makes any ``import jax`` raise)."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import path_tracer_tpu_torch, path_tracer_tpu_torch.cli, path_tracer_tpu_torch.scenes\n"
        "import path_tracer_tpu_torch.integrator.wavefront, path_tracer_tpu_torch.film\n"
        "import path_tracer_tpu_torch.trace.traversal, path_tracer_tpu_torch.trace.dense_cuda\n"
        "import path_tracer_tpu_torch.profile_render\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'path_tracer_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
