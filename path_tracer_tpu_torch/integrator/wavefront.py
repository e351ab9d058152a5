"""Wavefront path integrator: NEE + MIS, Russian roulette, nested media.

Port of ``path_tracer_tpu/integrator/wavefront.py`` in its pinned-lane mode:
the whole film advances bounce by bounce, every reference branch
(``src/integrator.rs:143-281``) turned into masked lane arithmetic, with
path regeneration between a lane's samples. The bounce loop is a Python
``while`` that reads ``alive.any()`` once per bounce (one host sync).

RNG: every draw site has a fixed stream id (``_S_*``, as in the JAX
package); values depend only on (lane, sample, bounce, site), so both
packages draw the same numbers for the same path.
"""

from __future__ import annotations

import torch

from path_tracer_tpu_torch.camera import ray_directions
from path_tracer_tpu_torch.core import sobol
from path_tracer_tpu_torch.core.constants import (
    EPSILON,
    FIREFLY_CLAMP,
    HEURISTIC_POWER,
    INFINITY,
    MAX_BOUNCES,
    MIN_PDF,
    RR_MAX_SURVIVE,
    RR_START_BOUNCE,
    VOLUME_STACK_DEPTH,
)
from path_tracer_tpu_torch.core.rng import pcg4d, uniform4
from path_tracer_tpu_torch.core.vecmath import dot, normalize, ray_at
from path_tracer_tpu_torch.integrator import bsdf as bsdf_mod
from path_tracer_tpu_torch.scene.envmap import sample_environment
from path_tracer_tpu_torch.scene.materials import unpack_material_rows
from path_tracer_tpu_torch.trace.traversal import any_hit, closest_hit, closest_hit_shade

# RNG stream ids (per bounce). Volume slots use VOLUME + k.
_S_RR = 0
_S_VOLUME = 1  # .. 1+K-1
_S_NEE_LIGHT = 8
_S_NEE_BSDF = 9
_S_SCATTER = 10
_S_CAMERA = 11
_S_LENS = 12


def mis_heuristic(f: torch.Tensor, g: torch.Tensor, power: int = HEURISTIC_POWER) -> torch.Tensor:
    """Power heuristic (integrator.rs:22)."""
    fp = f**power
    return fp / (fp + g**power)


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``idx``, negative ids clamped to row 0."""
    return table.index_select(0, idx.clamp(min=0))


def _interp_normal(normals_flat, idx, u, v):
    """Barycentric shading normal, normalised (primitive.rs:57-63)."""
    rows = _rows(normals_flat, idx)
    w = 1.0 - u - v
    n = rows[:, 0:3] * w[:, None] + rows[:, 3:6] * u[:, None] + rows[:, 6:9] * v[:, None]
    return normalize(n, eps=1e-20)


def _interp_position(positions_flat, idx, u, v):
    rows = _rows(positions_flat, idx)
    w = 1.0 - u - v
    return rows[:, 0:3] * w[:, None] + rows[:, 3:6] * u[:, None] + rows[:, 6:9] * v[:, None]


def _world(scene):
    """The world's geometry table: the two-level engine's, or the baked
    triangle table's (empty in two-level mode)."""
    return scene.get("twolevel", scene["tri"])


def _world_closest(scene, o, d, lim):
    """World closest hit through the two-level kernels (scenes built with
    ``two_level=True``, as ``path_tracer_tpu/integrator/wavefront.py:93-101``),
    the walk kernel (world soups above 16,384 triangles, ``:107-111``) or the
    dense kernel; each epilogue already fetched the winner's shading normal
    (world space) and model id. Returns ``(tri_idx, t, u, v, shade)``."""
    ti, t, u, v, n_raw, model = closest_hit_shade(_world(scene), o, d, lim)
    return ti, t, u, v, {"n_raw": n_raw, "model": model}


def _world_any(scene, o, d, lim):
    return any_hit(_world(scene), o, d, lim)


def _hit_normal(scene, idx, u, v, direction, shade=None):
    """Shading normal flipped against the ray + front_facing flag
    (primitive.rs:160-170). With a ``shade`` dict the interpolation already
    happened in the kernel's epilogue (the only way on a two-level scene);
    without one it is gathered here from the baked table."""
    if shade is not None:
        n = normalize(shade["n_raw"], eps=1e-20)
    else:
        n = _interp_normal(scene["tri"]["normals_flat"], idx, u, v)
    front = dot(direction, n) < 0.0
    return torch.where(front[:, None], n, -n), front


def _hit_material_model(scene, tri_idx, shade=None):
    """(material id, model id) of each hit: one material per model, so the
    two ids are equal."""
    if shade is not None:
        model_id = shade["model"].clamp(min=0)
    else:
        model_id = _rows(scene["tri"]["model_rows"], tri_idx)[:, 0].to(torch.int32)
    return model_id, model_id


def _volume_gather(mat: dict, ids: torch.Tensor):
    """Volume params for a stack slot of material ids (-1 = empty)."""
    m = unpack_material_rows(_rows(mat["rows"], ids))
    empty = ids < 0
    return {
        "has_scatter": m["vol_has_scatter"] & ~empty,
        "has_absorption": m["vol_has_absorption"] & ~empty,
        "absorption": torch.where(empty[:, None], 0.0, m["vol_absorption"]),
        "c": m["vol_c"],
        "g": m["vol_g"],
    }


def _stack_contains(stack: torch.Tensor, mat_id: torch.Tensor) -> torch.Tensor:
    return (stack == mat_id[:, None]).any(dim=1)


def _stack_insert(stack: torch.Tensor, mat_id: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
    """Set-insert into the first empty (-1) slot; no-op if present/full."""
    present = _stack_contains(stack, mat_id)
    is_empty = stack == -1
    # argmax on an int cast: the first empty slot (torch's argmax takes no bool)
    first_empty = torch.argmax(is_empty.to(torch.int32), dim=1)
    do = enable & ~present & is_empty.any(dim=1)
    slot = torch.arange(stack.shape[1], device=stack.device)[None, :] == first_empty[:, None]
    return torch.where(do[:, None] & slot, mat_id[:, None], stack)


def _stack_remove(stack: torch.Tensor, mat_id: torch.Tensor, enable: torch.Tensor) -> torch.Tensor:
    match = (stack == mat_id[:, None]) & enable[:, None]
    return torch.where(match, -1, stack)


def _direct_explicit(scene, lane, sample_id, b, o_s, wi_viewer, normal, front, m_lane, mask, mtypes,
                     consistent_ggx=False):
    """Explicit light-sample half of NEE (integrator.rs:25-74). ``mask``
    zeroes the shadow-ray extent for lanes not doing NEE."""
    light = scene["light"]
    u = uniform4(lane, sample_id, b, _S_NEE_LIGHT)

    # Power-CDF light pick (light_sampler.rs:31-37)
    cdf = light["cdf"]
    li = torch.searchsorted(cdf, u[:, 0].contiguous(), side="left").clamp(max=cdf.shape[0] - 1)
    lrow = _rows(light["rows"], li)
    pick_pdf = lrow[:, 0]
    area = lrow[:, 1]
    emitted = lrow[:, 2:5]

    # Uniform point via diagonal flip (primitive.rs:77-91)
    pu, pv = u[:, 1], u[:, 2]
    flip = pu + pv > 1.0
    pu = torch.where(flip, 1.0 - pu, pu)
    pv = torch.where(flip, 1.0 - pv, pv)
    point = _interp_position(light["positions_flat"], li, pu, pv)
    light_n = _interp_normal(light["normals_flat"], li, pu, pv)

    d_vec = point - o_s
    dist_sq = dot(d_vec, d_vec)
    dist = torch.sqrt(dist_sq)
    wo = d_vec / torch.clamp(dist[:, None], min=1e-20)

    facing = dot(wo, normal) > 0.0
    shadow_limit = torch.where(mask & facing, (1.0 - EPSILON) * dist, 0.0)

    bsdf_v, bsdf_pdf = bsdf_mod.eval_bsdf_pdf(m_lane, wi_viewer, wo, normal, front, mtypes, consistent_ggx)
    sample_pdf = pick_pdf / torch.clamp(area, min=1e-20)
    cosine = torch.abs(dot(wo, light_n))
    light_pdf = sample_pdf * dist_sq / torch.clamp(cosine, min=1e-20)
    weight = mis_heuristic(light_pdf, bsdf_pdf)
    weakening = bsdf_mod.get_weakening(m_lane, wo, normal)
    contrib = emitted * (weight * weakening / torch.clamp(light_pdf, min=1e-20))[:, None] * bsdf_v
    contrib = torch.where(facing[:, None], contrib, 0.0)
    # the caller batches this shadow ray with the BSDF half's into one any-hit
    return wo, shadow_limit, contrib


def _direct_bsdf(scene, lane, sample_id, b, o_s, ray_dir, wi_viewer, normal, front, m_lane, mask, mtypes,
                 consistent_ggx=False):
    """BSDF-sample half of NEE with the lights-table pretest
    (integrator.rs:77-130)."""
    light = scene["light"]
    u = uniform4(lane, sample_id, b, _S_NEE_BSDF)
    wo = bsdf_mod.sample_bsdf(m_lane, ray_dir, normal, front, u, mtypes)

    facing = dot(wo, normal) > 0.0
    live = mask & facing
    # Cheap pretest against the lights only (integrator.rs:100)
    li, lt, lu, lv = closest_hit(light, o_s, wo, torch.where(live, INFINITY, 0.0))
    light_found = li >= 0
    # Full shadow test at (1-EPS) * light distance (integrator.rs:103)
    shadow_limit = torch.where(live & light_found, lt * (1.0 - EPSILON), 0.0)

    bsdf_v, bsdf_pdf = bsdf_mod.eval_bsdf_pdf(m_lane, wi_viewer, wo, normal, front, mtypes, consistent_ggx)
    valid_pdf = bsdf_pdf > MIN_PDF

    lrow = _rows(light["rows"], li)
    pick_pdf = lrow[:, 0]
    area = lrow[:, 1]
    emitted = lrow[:, 2:5]
    light_n = _interp_normal(light["normals_flat"], li, lu, lv)

    sample_pdf = pick_pdf / torch.clamp(area, min=1e-20)
    cosine = torch.abs(dot(wo, light_n))
    light_pdf = sample_pdf * (lt * lt) / torch.clamp(cosine, min=1e-20)
    weight = mis_heuristic(bsdf_pdf, light_pdf)
    weakening = bsdf_mod.get_weakening(m_lane, wo, normal)
    contrib = emitted * (weight * weakening / torch.clamp(bsdf_pdf, min=1e-20))[:, None] * bsdf_v

    ok = facing & light_found & valid_pdf
    return wo, shadow_limit, torch.where(ok[:, None], contrib, 0.0)


def _sample_guard(rad):
    """Per-sample guard (integrator.rs:272-280): non-finite -> black, then
    firefly clamp of ||L|| to 100."""
    finite = torch.isfinite(rad).all(dim=1)
    norm = torch.sqrt(dot(rad, rad))
    scale = torch.where(norm > FIREFLY_CLAMP, FIREFLY_CLAMP / torch.clamp(norm, min=1e-20), 1.0)
    return torch.where(finite[:, None], rad * scale[:, None], 0.0)


def trace_lanes(
    scene: dict,
    ndc_to_world: torch.Tensor,
    cam_origin: torch.Tensor,
    sample_id: int,
    lane: torch.Tensor,
    width: int,
    height: int,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    has_lights: bool = True,
    spp: int = 1,
    mtypes: tuple = bsdf_mod.ALL_MTYPES,
    any_volumes: bool = True,
    consistent_ggx: bool = False,
    aperture: float = 0.0,
    focus: float = 0.0,
    cam_basis: torch.Tensor | None = None,
):
    """Trace ``spp`` path samples per film lane (lane = y*width + x, y
    bottom-up, int64 ids) with path regeneration: when a lane's path ends
    it starts the same pixel's next sample.

    Returns ``(radiance [n,3], position [n,4], first_id [n] int64,
    rays_cast [n,2] float32)``: the radiance SUM over the lane's samples,
    each NaN-guarded and firefly-clamped; the first sample's camera-hit
    position and model id; and per lane the count of traversal queries
    issued (column 0: closest hits + both NEE shadow rays + the lights
    pretest; column 1: without the pretest).
    """
    n = lane.shape[0]
    dev = lane.device
    f32 = torch.float32
    base = int(sample_id)
    limit = base + int(spp)
    nee = enable_nee and has_lights
    mat = scene["mat"]

    def camera_rays(s_idx, ln):
        # Sub-pixel jitter: Owen-scrambled Sobol indexed by sample, seeded
        # per pixel
        pix_seed, _, _, _ = pcg4d(
            ln, torch.full_like(ln, 0x9E3779B9), torch.full_like(ln, 0x85EBCA6B),
            torch.full_like(ln, _S_CAMERA),
        )
        x = (ln % width).to(f32)
        y = (ln // width).to(f32)
        offset = sobol.get_ss_sobol(s_idx, pix_seed) - 0.5
        u = (x + offset[:, 0]) / width
        v = (y + offset[:, 1]) / height
        d = ray_directions(ndc_to_world, cam_origin, u, v)
        o = cam_origin.to(f32).expand(n, 3)
        if aperture > 0.0:
            # thin-lens defocus (camera.rs:17's aperture/focus, live)
            u4 = uniform4(ln, s_idx, 0, _S_LENS)
            r = (aperture * 0.5) * torch.sqrt(u4[:, 0])
            phi = 6.283185307179586 * u4[:, 1]
            lx = r * torch.cos(phi)
            ly = r * torch.sin(phi)
            o2 = o + lx[:, None] * cam_basis[:, 0] + ly[:, None] * cam_basis[:, 1]
            p = o + d * focus
            d2 = p - o2
            nrm = torch.sqrt(d2[:, 0] * d2[:, 0] + d2[:, 1] * d2[:, 1] + d2[:, 2] * d2[:, 2])
            return o2, d2 / nrm[:, None]
        return o, d

    s_idx = torch.full((n,), base, dtype=torch.int64, device=dev)
    o, d = camera_rays(s_idx, lane)
    throughput = torch.ones((n, 3), dtype=f32, device=dev)
    radiance = torch.zeros((n, 3), dtype=f32, device=dev)  # current sample
    accum = torch.zeros((n, 3), dtype=f32, device=dev)  # flushed samples
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    last_delta = torch.zeros(n, dtype=torch.bool, device=dev)
    vol_stack = torch.full((n, VOLUME_STACK_DEPTH), -1, dtype=torch.int32, device=dev)
    b = torch.zeros(n, dtype=torch.int64, device=dev)
    position = torch.cat([o + d * 1e5, torch.full((n, 1), 1e5, dtype=f32, device=dev)], dim=1)
    first_id = torch.full((n,), 0xFF, dtype=torch.int64, device=dev)
    rays = torch.zeros(n, dtype=f32, device=dev)
    rays_strict = torch.zeros(n, dtype=f32, device=dev)

    while bool(alive.any()):
        was_alive = alive

        # Bounce-limit expiry (reference loop bound, integrator.rs:163)
        alive = alive & (b <= max_bounces)

        # --- Russian roulette (integrator.rs:165-177) ---
        rr_on = alive & (b > RR_START_BOUNCE)
        survive = torch.clamp(throughput.max(dim=-1).values, max=RR_MAX_SURVIVE)
        u_rr = uniform4(lane, s_idx, b, _S_RR)[:, 0]
        alive = alive & ~(rr_on & (u_rr > survive))
        throughput = torch.where(rr_on[:, None], throughput / torch.clamp(survive, min=1e-20)[:, None], throughput)

        # --- closest hit on the world (dead lanes get a zero-extent ray) ---
        tri_idx, t_hit, hu, hv, shade = _world_closest(scene, o, d, torch.where(alive, INFINITY, 0.0))
        hit = (tri_idx >= 0) & alive

        # First-bounce position/id buffers for the first sample only
        at_b0 = alive & (b == 0) & (s_idx == base)
        pos_hit = torch.cat([ray_at(o, d, t_hit), t_hit[:, None]], dim=1)
        position = torch.where((at_b0 & hit)[:, None], pos_hit, position)

        # --- participating media (integrator.rs:189-205) ---
        if any_volumes:
            t_scat = torch.full_like(t_hit, INFINITY)
            scat_slot = torch.zeros_like(tri_idx)
            vol_u = [uniform4(lane, s_idx, b, _S_VOLUME + k) for k in range(VOLUME_STACK_DEPTH)]
            slot_vols = []
            for k in range(VOLUME_STACK_DEPTH):
                vp = _volume_gather(mat, vol_stack[:, k])
                slot_vols.append(vp)
                t_k = bsdf_mod.free_flight(vol_u[k][:, 0], torch.clamp(vp["c"], min=1e-20))
                t_k = torch.where(vp["has_scatter"], t_k, INFINITY)
                better = t_k < t_scat
                t_scat = torch.where(better, t_k, t_scat)
                scat_slot = torch.where(better, k, scat_slot)
            scattered = hit & (t_scat <= t_hit)

            # Beer-Lambert over the traveled distance, every absorbing slot
            travel = torch.where(scattered, t_scat, t_hit)
            for k in range(VOLUME_STACK_DEPTH):
                vp = slot_vols[k]
                absorb_on = hit & vp["has_absorption"]
                trans = bsdf_mod.transmission(vp["absorption"], travel)
                throughput = torch.where(absorb_on[:, None], throughput * trans, throughput)

            # HG scatter direction from the winning slot's draws
            g_win = torch.zeros_like(t_scat)
            u_phi = torch.zeros_like(t_scat)
            u_z = torch.zeros_like(t_scat)
            for k in range(VOLUME_STACK_DEPTH):
                sel = scat_slot == k
                g_win = torch.where(sel, slot_vols[k]["g"], g_win)
                u_phi = torch.where(sel, vol_u[k][:, 1], u_phi)
                u_z = torch.where(sel, vol_u[k][:, 2], u_z)
            hg_dir = bsdf_mod.hg_scatter_direction(d, g_win, u_phi, u_z)
        else:
            t_scat = t_hit
            scattered = torch.zeros_like(hit)
            hg_dir = d

        # --- surface interaction for unscattered hit lanes ---
        surf = hit & ~scattered
        normal, front = _hit_normal(scene, tri_idx, hu, hv, d, shade)
        mat_idx, model_id = _hit_material_model(scene, tri_idx, shade)
        first_id = torch.where(at_b0 & hit, model_id.to(torch.int64), first_id)
        m_lane = bsdf_mod.gather_mat(mat, mat_idx)
        wi_viewer = -d
        o_surf = ray_at(o, d, t_hit)

        # Emissive termination (integrator.rs:207-214)
        is_emissive = m_lane["is_emissive"] & surf
        gate = (last_delta | (b == 0)) if nee else torch.ones_like(surf)
        radiance = torch.where((is_emissive & gate)[:, None], radiance + m_lane["emitted"] * throughput, radiance)

        # Volume stack set-update on transmissive boundaries
        # (integrator.rs:217-227)
        if any_volumes:
            has_vol = m_lane["has_volume"] & surf & ~is_emissive
            vol_stack = _stack_insert(vol_stack, mat_idx, has_vol & front)
            vol_stack = _stack_remove(vol_stack, mat_idx, has_vol & ~front)

        # NEE (integrator.rs:231-234): both halves' shadow rays go through
        # one any-hit over 2N rays
        if nee:
            nee_on = surf & ~is_emissive & ~m_lane["is_delta"]
            wo_e, lim_e, contrib_e = _direct_explicit(
                scene, lane, s_idx, b, o_surf, wi_viewer, normal, front,
                m_lane, nee_on, mtypes, consistent_ggx,
            )
            wo_b, lim_b, contrib_b = _direct_bsdf(
                scene, lane, s_idx, b, o_surf, d, wi_viewer, normal, front,
                m_lane, nee_on, mtypes, consistent_ggx,
            )
            occluded = _world_any(
                scene,
                torch.cat([o_surf, o_surf], dim=0),
                torch.cat([wo_e, wo_b], dim=0),
                torch.cat([lim_e, lim_b], dim=0),
            )
            direct = (
                torch.where(occluded[:n, None], 0.0, contrib_e)
                + torch.where(occluded[n:, None], 0.0, contrib_b)
            )
            radiance = torch.where(nee_on[:, None], radiance + throughput * direct, radiance)

        rays = rays + alive.to(f32)
        rays_strict = rays_strict + alive.to(f32)
        if nee:
            rays = rays + 3.0 * nee_on.to(f32)
            rays_strict = rays_strict + 2.0 * nee_on.to(f32)

        # BSDF scatter + path weight (integrator.rs:236-251)
        u_sc = uniform4(lane, s_idx, b, _S_SCATTER)
        new_dir = bsdf_mod.sample_bsdf(m_lane, d, normal, front, u_sc, mtypes)
        bsdf_v, pdf = bsdf_mod.eval_bsdf_pdf(m_lane, wi_viewer, new_dir, normal, front, mtypes, consistent_ggx)
        weakening = bsdf_mod.get_weakening(m_lane, new_dir, normal)
        scatter_w = weakening[:, None] * bsdf_v / pdf[:, None]
        cont = surf & ~is_emissive & ~(pdf < MIN_PDF)

        # --- environment miss (integrator.rs:256-266) ---
        miss = alive & ~hit
        env_rad = sample_environment(scene["env"], d)
        radiance = torch.where(miss[:, None], radiance + env_rad * throughput, radiance)

        # --- advance lanes ---
        throughput = torch.where(cont[:, None], throughput * scatter_w, throughput)
        o = torch.where(scattered[:, None], ray_at(o, d, t_scat), torch.where(cont[:, None], o_surf, o))
        d = torch.where(scattered[:, None], hg_dir, torch.where(cont[:, None], new_dir, d))
        last_delta = scattered | torch.where(cont, m_lane["is_delta"], last_delta)
        alive = alive & (scattered | cont)
        b = torch.where(alive, b + 1, b)

        # --- flush finished samples + path regeneration ---
        died = was_alive & ~alive
        accum = accum + torch.where(died[:, None], _sample_guard(radiance), 0.0)
        next_s = s_idx + 1
        regen = died & (next_s < limit)
        s_idx = torch.where(died, next_s, s_idx)
        new_o, new_d = camera_rays(s_idx, lane)
        o = torch.where(regen[:, None], new_o, o)
        d = torch.where(regen[:, None], new_d, d)
        throughput = torch.where(regen[:, None], 1.0, throughput)
        radiance = torch.where(died[:, None], 0.0, radiance)
        last_delta = last_delta & ~regen
        vol_stack = torch.where(regen[:, None], -1, vol_stack)
        b = torch.where(regen, 0, b)
        alive = alive | regen

    return accum, position, first_id, torch.stack([rays, rays_strict], dim=1)


def render_sample(
    scene: dict,
    ndc_to_world: torch.Tensor,
    cam_origin: torch.Tensor,
    sample_id: int,
    width: int,
    height: int,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    has_lights: bool = True,
    spp: int = 1,
    mtypes: tuple = bsdf_mod.ALL_MTYPES,
    any_volumes: bool = True,
    aperture: float = 0.0,
    focus: float = 0.0,
    cam_basis=None,
):
    """Trace ``spp`` samples/pixel over the whole film as one wave of lanes
    on ``ndc_to_world``'s device. Returns ``(radiance_sum [N,3],
    position [N,4], first_id [N], rays [N,2])``, N = width*height."""
    lane = torch.arange(width * height, dtype=torch.int64, device=ndc_to_world.device)
    return trace_lanes(
        scene, ndc_to_world, cam_origin, sample_id, lane, width, height,
        max_bounces=max_bounces, enable_nee=enable_nee, has_lights=has_lights,
        spp=spp, mtypes=mtypes, any_volumes=any_volumes,
        aperture=aperture, focus=focus, cam_basis=cam_basis,
    )


def render(
    scene_host,
    camera,
    width: int,
    height: int,
    spp: int,
    device,
    max_bounces: int = MAX_BOUNCES,
    enable_nee: bool = True,
    start_sample: int = 0,
    film=None,
    engine: str | None = None,
):
    """Progressive multi-sample render on ``device``. Returns the HDR film
    ``[H, W, 4]`` (rgb sum + sample count in alpha, the layout of
    ``accumulate.wgsl``). Pass ``film`` to resume; samples go in batches of
    32, so a caller can checkpoint between them. ``engine`` picks a
    two-level scene's engine (`Scene.device`)."""
    scene = scene_host.device(device, engine)
    ndc_to_world = torch.as_tensor(camera.view_proj_inverse(), device=device)
    origin = torch.as_tensor(camera.origin, device=device)
    if film is None:
        film = torch.zeros((height, width, 4), dtype=torch.float32, device=device)
    s = start_sample
    while s < start_sample + spp:
        cur = min(32, start_sample + spp - s)
        rad, _, _, _ = render_sample(
            scene, ndc_to_world, origin, s, width, height,
            max_bounces=max_bounces, enable_nee=enable_nee, has_lights="light" in scene,
            spp=cur, mtypes=scene_host.active_mtypes, any_volumes=scene_host.has_volumes,
        )
        frame = torch.cat([rad, torch.full((rad.shape[0], 1), float(cur), device=device)], dim=1)
        film = film + frame.reshape(height, width, 4)
        s += cur
    return film
