"""Vectorized BSDF sampling/evaluation for all five material models.

Port of ``path_tracer_tpu/integrator/bsdf.py`` to torch, expression for
expression.

Formula-for-formula port of ``src/tlas/tlas_bvh/blas/primitive/material.rs``
as branchless lane math: every material model is evaluated for every lane and
the result selected by material type code — the wavefront replacement for the
reference's enum dispatch. Reference quirks are preserved deliberately so that
images match (equal-spp MSE metric), notably:

* GGX ``d()`` computes ``(1-cos^2).sqrt()/cos^2`` (sin/cos^2, *not* tan^2) —
  material.rs:197,
* the Dielectric Fresnel uses ``-dot(incoming, outgoing)`` as its cosine
  (material.rs:513; the reference marks this "TODO: fix fresnel"),
* GGX reflection pdf multiplies by the Fresnel choice probability with
  ``h.z`` unclamped (material.rs:438).

Conventions (from ``integrator.rs``): ``ray_dir`` is the tracing direction
(into the surface); ``wi_viewer = -ray_dir``; ``normal`` is the shading normal
already flipped to oppose the ray (primitive.rs:160-170); ``front_facing``
records which side was hit.
"""

from __future__ import annotations

import math

import torch

from path_tracer_tpu_torch.core.onb import generate_onb, generate_onb_ggx, onb_apply, onb_apply_transpose
from path_tracer_tpu_torch.core.vecmath import dot, normalize, random_cosine_vector, reflect, refract
from path_tracer_tpu_torch.scene.materials import (
    MTYPE_DIELECTRIC,
    MTYPE_EMISSIVE,
    MTYPE_GGX_REFLECTIVE,
    MTYPE_GGX_TRANSMISSIVE,
    MTYPE_LAMBERTIAN,
    MTYPE_SPECULAR,
)

PI = math.pi


def gather_mat(mat: dict, idx: torch.Tensor) -> dict:
    """Per-lane material parameters: one row gather from the packed material
    table (``scene.materials.pack_material_rows``)."""
    from path_tracer_tpu_torch.scene.materials import unpack_material_rows

    return unpack_material_rows(mat["rows"].index_select(0, idx.clamp(min=0)))


def _pow5(x):
    """``x ** 5`` as JAX's integer_pow computes it: ``x * (x*x)*(x*x)``."""
    x2 = x * x
    return x * (x2 * x2)


def _schlick(cos: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """Scalar Schlick approximation (material.rs:205)."""
    return _pow5(1.0 - cos) * (1.0 - f0) + f0


def _schlick_vec(cos: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
    """Vector Schlick for REFLECTIVE tinting (material.rs:207)."""
    return f0 + (1.0 - f0) * (_pow5(1.0 - cos))[..., None]


def _eta(front_facing: torch.Tensor, ior: torch.Tensor, entering_recip: bool) -> torch.Tensor:
    """Relative IOR. ``entering_recip=True`` gives 1/ior when front-facing
    (scatter convention, material.rs:328); the eval path uses the opposite
    pairing for transmission half-vectors (material.rs:368)."""
    if entering_recip:
        return torch.where(front_facing, 1.0 / ior, ior)
    return torch.where(front_facing, ior, 1.0 / ior)


def _ggx_half_vector(a, ray_dir, normal, u1, u2):
    """VNDF half-vector sampling, Heitz "A Simpler and Exact Sampling Routine
    for the GGX Distribution of Visible Normals" (material.rs:248-284)."""
    onb_a = generate_onb(normal)
    v_raw = onb_apply_transpose(onb_a, -ray_dir)
    stretch = torch.stack([a, a, torch.ones_like(a)], dim=-1)
    v = normalize(v_raw * stretch)
    onb_b = generate_onb_ggx(v)

    inv_1pz = 1.0 / (1.0 + v[..., 2])
    condition = u2 < inv_1pz
    r = torch.clamp(torch.sqrt(u1), max=0.9999)  # r==1 would give NaN (material.rs:266)
    phi = torch.where(
        condition,
        PI * u2 / inv_1pz,
        PI + (u2 - inv_1pz) / (1.0 - inv_1pz) * PI,
    )
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(condition, 1.0, v[..., 2])
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    h_t = onb_apply(onb_b, torch.stack([p1, p2, pz], dim=-1))
    return onb_apply(onb_a, normalize(h_t * stretch))


def _ggx_d(a, h, consistent: bool = False):
    """NDF. The reference's ``d()`` computes ``tan_sq`` as
    ``sqrt(1-cos^2)/cos^2`` — that is sin(theta)/cos^2(theta), NOT
    tan^2(theta) (material.rs:196 misses the square on the sine). The result
    is a non-normalized lobe much narrower than true GGX, while the Heitz
    VNDF sampling routine (which never calls d()) still draws from TRUE GGX —
    so the reference's bsdf-sampled and light-sampled estimators converge to
    different images. We reproduce the quirk by default for parity;
    ``consistent=True`` restores the standard ``tan^2`` (used with the VNDF
    pdf by benches/quality.py to demonstrate the gap closes)."""
    hz = h[..., 2]
    cos_sq = hz * hz
    sin_sq = torch.clamp(1.0 - cos_sq, min=0.0)
    if consistent:
        tan_sq = sin_sq / torch.clamp(cos_sq, min=1e-20)
    else:
        tan_sq = torch.sqrt(sin_sq) / torch.clamp(cos_sq, min=1e-20)
    x = a * a + tan_sq
    d = a * a / (PI * cos_sq * cos_sq * x * x)
    return torch.where(hz <= 0.0, 0.0, d)


def _ggx_g1(a, v, h):
    """Smith mono-directional shadowing (material.rs:210-221)."""
    vz = v[..., 2]
    tan_sq = 1.0 / torch.clamp(vz * vz, min=1e-20) - 1.0
    g = 2.0 / (1.0 + torch.sqrt(1.0 + a * a * tan_sq))
    bad = vz * dot(h, v) <= 0.0
    return torch.where(bad, 0.0, g)


def _ggx_g_uncorrelated(a, wi, wo):
    """Frostbite uncorrelated visibility (material.rs:227-244)."""
    wiz, woz = wi[..., 2], wo[..., 2]
    a_sq = a * a
    x = 2.0 * wiz * woz
    y = 1.0 - a_sq
    z = woz * torch.hypot(a, wiz * torch.sqrt(torch.clamp(y, min=0.0)))
    w = wiz * torch.hypot(a, woz * torch.sqrt(torch.clamp(y, min=0.0)))
    g = x / torch.clamp(z + w, min=1e-20)
    return torch.where((wiz <= 0.0) | (woz <= 0.0), 0.0, g)


ALL_MTYPES = (
    MTYPE_LAMBERTIAN, MTYPE_EMISSIVE, MTYPE_SPECULAR,
    MTYPE_GGX_REFLECTIVE, MTYPE_GGX_TRANSMISSIVE, MTYPE_DIELECTRIC,
)


def sample_bsdf(m: dict, ray_dir, normal, front_facing, u4, mtypes=ALL_MTYPES):
    """Sample a scatter direction for every lane (``scatter_direction``).

    ``m``: per-lane gathered material params; ``u4``: [N,4] uniforms. Draw
    usage — Lambertian: (u0,u1); GGX: (u0,u1) half-vector + u2 reflect choice;
    Dielectric: u0 choice. ``mtypes`` (static) limits which material models
    are compiled in — scene-adaptive specialization, e.g. an all-diffuse
    Cornell pays nothing for GGX trig. Returns unit directions [N,3]."""
    u0, u1, u2 = u4[..., 0], u4[..., 1], u4[..., 2]
    ggx = MTYPE_GGX_REFLECTIVE in mtypes or MTYPE_GGX_TRANSMISSIVE in mtypes
    mt = m["mtype"][..., None]
    out = torch.zeros_like(ray_dir)

    if MTYPE_LAMBERTIAN in mtypes:
        lamb = onb_apply(generate_onb(normal), random_cosine_vector(u0, u1))
        out = torch.where(mt == MTYPE_LAMBERTIAN, lamb, out)

    if MTYPE_SPECULAR in mtypes:
        out = torch.where(mt == MTYPE_SPECULAR, reflect(ray_dir, normal), out)

    if ggx or MTYPE_DIELECTRIC in mtypes:
        eta_t = _eta(front_facing, m["ior"], entering_recip=True)

    if ggx:
        # GGX: half-vector then reflect/refract (material.rs:317-347)
        h = _ggx_half_vector(m["ggx_a"], ray_dir, normal, u0, u1)
        ggx_refl = reflect(ray_dir, h)
        if MTYPE_GGX_REFLECTIVE in mtypes:
            out = torch.where(mt == MTYPE_GGX_REFLECTIVE, ggx_refl, out)
        if MTYPE_GGX_TRANSMISSIVE in mtypes:
            f0 = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
            f_h = _schlick(-dot(ray_dir, h), f0)
            refr_h, tir_h = refract(ray_dir, h, eta_t)
            ggx_reflects = tir_h | (u2 < f_h)
            ggx_trans = torch.where(ggx_reflects[..., None], ggx_refl, refr_h)
            out = torch.where(mt == MTYPE_GGX_TRANSMISSIVE, ggx_trans, out)

    if MTYPE_DIELECTRIC in mtypes:
        # Dielectric (material.rs:496-509)
        cos_d = -dot(ray_dir, normal)
        sin2_scaled = eta_t * eta_t * (1.0 - cos_d * cos_d)
        f0_d = ((eta_t - 1.0) / (eta_t + 1.0)) ** 2
        f_d = torch.where(sin2_scaled > 1.0, 1.0, _schlick(cos_d, f0_d))
        refr_n, _ = refract(ray_dir, normal, eta_t)
        diel = torch.where((u0 < f_d)[..., None], reflect(ray_dir, normal), refr_n)
        out = torch.where(mt == MTYPE_DIELECTRIC, diel, out)
    return out


def eval_bsdf_pdf(m: dict, wi_viewer, wo_scatter, normal, front_facing, mtypes=ALL_MTYPES,
                  consistent_ggx: bool = False):
    """``get_bsdf_pdf(incoming=wi_viewer, outgoing=wo_scatter)`` for every lane.

    Returns ``(bsdf [N,3], pdf [N])``. Invalid combinations yield pdf<=0 and
    are culled by the integrator's ``pdf < MIN_PDF`` check (integrator.rs:243).
    ``mtypes`` (static) limits which models are compiled in.

    ``consistent_ggx`` (static): the reference's GGX estimator is doubly
    inconsistent with its own sampler — ``d()`` computes a non-GGX lobe
    (sin instead of tan^2, material.rs:196; see ``_ggx_d``) and the pdf is
    the plain-NDF density ``D * h_z * jac`` rather than the VNDF density the
    Heitz routine actually samples (material.rs:248-284 vs :423,:438). The
    default reproduces both quirks for parity. ``consistent_ggx=True``
    restores standard GGX D and the exact VNDF pdf
    (``x G1(view)|view.h| / (|view_z| h_z)``) — a self-consistent unbiased
    estimator, used by benches/quality.py to demonstrate that the GGX
    scenes' estimator gap is the reference's own.
    """
    ggx = MTYPE_GGX_REFLECTIVE in mtypes or MTYPE_GGX_TRANSMISSIVE in mtypes

    # Lambertian (material.rs:109-115)
    cos_l = dot(wo_scatter, normal)
    lamb_bsdf = m["colour"] / PI
    lamb_pdf = cos_l / PI

    # Emissive / Specular deltas (material.rs:134, 155)
    emis_bsdf = m["emitted"]
    spec_bsdf = m["colour"]
    one = torch.ones_like(cos_l)

    if ggx:
        # --- GGX shared tangent-space setup (material.rs:349-398) ---
        onb = generate_onb(normal)
        wi = onb_apply_transpose(onb, wo_scatter)  # reference naming: wi = scatter
        wo = onb_apply_transpose(onb, wi_viewer)  # wo = viewer
        a = m["ggx_a"]
        transmitted = wi[..., 2] < 0.0

        # Half-vector: reflection branch
        h_refl = normalize(wi + wo, eps=1e-20)
        eta_e = _eta(front_facing, m["ior"], entering_recip=False)
        is_trans_model = m["mtype"] == MTYPE_GGX_TRANSMISSIVE
        if MTYPE_GGX_TRANSMISSIVE in mtypes:
            # Transmission branch: eta*wi + wo, sign-corrected
            h_t_raw = normalize(eta_e[..., None] * wi + wo, eps=1e-20)
            h_trans = h_t_raw * torch.where(h_t_raw[..., 2] >= 0.0, 1.0, -1.0)[..., None]
            h = torch.where((transmitted & is_trans_model)[..., None], h_trans, h_refl)
        else:
            h = h_refl

        i_dot_h = dot(wi, h)
        o_dot_h = dot(wo, h)
        d = _ggx_d(a, h, consistent_ggx)

        # F and G per sub-model (material.rs:384-398)
        f_refl_model = torch.ones_like(i_dot_h)
        g_refl_model = _ggx_g_uncorrelated(a, wi, wo)
        if MTYPE_GGX_TRANSMISSIVE in mtypes:
            f0 = ((eta_e - 1.0) / (eta_e + 1.0)) ** 2
            f_trans = _schlick(torch.abs(i_dot_h), f0)
            g_trans = _ggx_g1(a, wi, h) * _ggx_g1(a, wo, h)
            f = torch.where(is_trans_model, f_trans, f_refl_model)
            g = torch.where(is_trans_model, g_trans, g_refl_model)
        else:
            f, g = f_refl_model, g_refl_model

        # Reflection lobe, shared by both models (material.rs:430-448)
        brdf = f * g * d / torch.clamp(4.0 * torch.abs(wi[..., 2] * wo[..., 2]), min=1e-20)
        refl_pdf = d * h[..., 2] * f / torch.clamp(4.0 * torch.abs(o_dot_h), min=1e-20)
        tint = torch.where(
            is_trans_model[..., None],
            torch.ones_like(m["colour"]),
            _schlick_vec(torch.abs(i_dot_h), m["colour"]),
        )
        refl_bsdf = tint * brdf[..., None]

        if MTYPE_GGX_TRANSMISSIVE in mtypes:
            # Transmission lobe (material.rs:400-428)
            x = torch.abs(i_dot_h * o_dot_h)
            y = torch.abs(wi[..., 2] * wo[..., 2])
            z = (1.0 - f) * g * d
            w = eta_e * i_dot_h + o_dot_h
            btdf = (x * z) / torch.clamp(y * w * w, min=1e-20)
            trans_bsdf = m["colour"] * (btdf * eta_e * eta_e)[..., None]
            jac_t = torch.abs(o_dot_h) / torch.clamp(w * w, min=1e-20)
            trans_pdf = d * (1.0 - f) * torch.abs(h[..., 2]) * jac_t
            ggx_bsdf = torch.where(transmitted[..., None], trans_bsdf, refl_bsdf)
            ggx_pdf = torch.where(transmitted, trans_pdf, refl_pdf)
        else:
            ggx_bsdf, ggx_pdf = refl_bsdf, refl_pdf
        # REFLECTIVE model cannot transmit (material.rs:405)
        refl_model_invalid = transmitted & (m["mtype"] == MTYPE_GGX_REFLECTIVE)
        ggx_bsdf = torch.where(refl_model_invalid[..., None], 0.0, ggx_bsdf)
        ggx_pdf = torch.where(refl_model_invalid, 0.0, ggx_pdf)
        if consistent_ggx:
            # NDF pdf -> exact VNDF density: x G1(view)|view.h| / (|view_z| h_z)
            corr = (
                _ggx_g1(a, wo, h) * torch.abs(o_dot_h)
                / torch.clamp(torch.abs(wo[..., 2]) * torch.abs(h[..., 2]), min=1e-20)
            )
            ggx_pdf = ggx_pdf * corr

    if MTYPE_DIELECTRIC in mtypes:
        # Dielectric (material.rs:511-527), with the reference's cosine quirk
        eta_d = _eta(front_facing, m["ior"], entering_recip=True)
        cos_q = -dot(wi_viewer, wo_scatter)
        sin2 = eta_d * eta_d * (1.0 - cos_q * cos_q)
        f0_d = ((eta_d - 1.0) / (eta_d + 1.0)) ** 2
        f_d = torch.where(sin2 > 1.0, 1.0, _schlick(cos_q, f0_d))
        refl_side = dot(wo_scatter, normal) > 0.0
        diel_bsdf = torch.where(
            refl_side[..., None],
            f_d[..., None].expand(m["colour"].shape),
            m["colour"] * ((1.0 - f_d) / (eta_d * eta_d))[..., None],
        )
        diel_pdf = torch.where(refl_side, f_d, 1.0 - f_d)

    mt = m["mtype"]
    mte = mt[..., None]
    bsdf = torch.zeros_like(m["colour"])
    pdf = torch.zeros_like(cos_l)
    if MTYPE_LAMBERTIAN in mtypes:
        bsdf = torch.where(mte == MTYPE_LAMBERTIAN, lamb_bsdf, bsdf)
        pdf = torch.where(mt == MTYPE_LAMBERTIAN, lamb_pdf, pdf)
    if MTYPE_EMISSIVE in mtypes:
        bsdf = torch.where(mte == MTYPE_EMISSIVE, emis_bsdf, bsdf)
        pdf = torch.where(mt == MTYPE_EMISSIVE, one, pdf)
    if MTYPE_SPECULAR in mtypes:
        bsdf = torch.where(mte == MTYPE_SPECULAR, spec_bsdf, bsdf)
        pdf = torch.where(mt == MTYPE_SPECULAR, one, pdf)
    if ggx:
        is_ggx = (mte == MTYPE_GGX_REFLECTIVE) | (mte == MTYPE_GGX_TRANSMISSIVE)
        bsdf = torch.where(is_ggx, ggx_bsdf, bsdf)
        pdf = torch.where(is_ggx[..., 0], ggx_pdf, pdf)
    if MTYPE_DIELECTRIC in mtypes:
        bsdf = torch.where(mte == MTYPE_DIELECTRIC, diel_bsdf, bsdf)
        pdf = torch.where(mt == MTYPE_DIELECTRIC, diel_pdf, pdf)
    return bsdf, pdf


def get_weakening(m: dict, wo_scatter, normal):
    """Cosine term; 1.0 for delta materials (material.rs:67-77)."""
    cos = torch.abs(dot(wo_scatter, normal))
    return torch.where(m["is_delta"], 1.0, cos)


# --------- Participating media (volume.rs) ---------

def hg_scatter_direction(incoming, g, u0, u1):
    """Henyey-Greenstein direction sample (volume.rs:32-60)."""
    phi = 2.0 * PI * u0
    safe_g = torch.where(g == 0.0, 1.0, g)
    xterm = (1.0 - g * g) / (1.0 + safe_g * (1.0 - 2.0 * u1))
    z_hg = (1.0 + g * g - xterm * xterm) / (2.0 * safe_g)
    z = torch.where(g == 0.0, 1.0 - 2.0 * u1, z_hg)
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    return onb_apply(generate_onb(-incoming), local)


def hg_pdf(incoming, outgoing, g):
    """HG phase function pdf (volume.rs:63-74)."""
    cos = dot(outgoing, incoming)
    n = 1.0 - g * g
    d = 4.0 * PI * (1.0 + g * g - 2.0 * g * cos) ** 1.5
    return n / d


def free_flight(u, c):
    """Exponential free-flight distance, ``-ln(u)/c`` (volume.rs:85). A draw
    of exactly 0 gives inf (no scattering), as in the JAX package: its
    ``max(u, 1e-38)`` floor is a float32 subnormal, which XLA flushes to 0."""
    return -torch.log(u) / c


def transmission(vol_absorption, dist):
    """Beer-Lambert RGB transmission (volume.rs:113)."""
    return torch.exp(-vol_absorption * dist[..., None])
