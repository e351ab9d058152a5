"""End-to-end smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without the final
``ok`` line):

1. environment: torch, CUDA, the card's name and power limit;
2. build both kernel sources (``dense_hit.cu``, ``walk_hit.cu``) from
   ``path_tracer_tpu_torch/csrc``, one nvcc each, started together; print
   ptxas registers and spills;
3. dense kernels against their plain torch versions on ``mesh_scene``'s
   world table (65,536 camera + 65,536 random rays, with inf / 0 / NaN
   lanes), plus a float64 run of the plain closest hit as a precision
   oracle; then both compared again, and timed, at the render's shapes: the
   world query over 589,824 camera rays, the lights pretest over 589,824
   rays, the any-hit over 1,179,648 shadow rays;
4. the offline render of ``mesh_scene`` at 1024x576, 8 spp, 64 bounces
   through ``path_tracer_tpu_torch.cli``, with the kernels' launch counts;
5. ``cornell_specular`` at 64x64, 4 spp rendered on the CPU (plain
   versions) and on the card (kernels): image means within 1%;
6. walk kernels against their plain versions on the full ``dragon_scene``
   world table (884,748 tris; 32,768 camera + 32,768 random rays with inf /
   0 / NaN lanes), plus the float64 plain closest hit on 4,096 of them;
7. the walk kernels timed at the render's shapes (589,824 camera rays,
   589,824 bounce rays in random directions from the camera hits, 1,179,648
   shadow rays toward the light), compared with the plain versions on
   16,384 rays of each, with visited and skipped chunks per block;
8. the offline render of ``dragon_scene`` at 1024x576, 4 spp, 64 bounces
   through the CLI, with host build seconds, bounce steps and launch counts;
9. ``dragon_scene(nu=96, nv=64, env_h=64)`` (24,588 tris, the walk engine)
   at 32x32, 4 spp on the CPU and on the card: image means within 1%.

Each render's launch counts are set to 0 just before it and read just
after. ``bound_ms`` is the least time the card could take for the same work:
the larger of the bytes the query must move over 3.35 TB/s and its float32
operations over 67 TFLOP/s (H100 SXM data sheet), counting the ray x
triangle pairs these rays need: every row for a live lane of a dense closest
hit, rows up to the first hit for a dense shadow test. For a walk query the
need is set by each ray's own slab test against every chunk box, not by the
kernel's block gate: a live closest-hit ray tests the real (not pad)
triangles of every chunk it enters before its own closest hit (or its
limit on a miss); a live shadow ray with an occluder tests the real
triangles of the one chunk that holds its closest occluder, one without
tests those of every chunk its segment enters. The box tests are not
charged (a tree over the boxes needs a few per ray). No one PyTorch call
computes these queries, so ``library_ms`` is null.

The last lines are the card line, one JSON object describing each kernel,
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "path_tracer_tpu_torch" / "_build"  # gitignored
WIDTH, HEIGHT, SPP, MAX_BOUNCES = 1024, 576, 8, 64
DRAGON_SPP = 4
CAMERA_GRID = 256  # 256 x 256 = 65,536 camera rays
N_RANDOM = 65536
WINNER_AGREE = 0.9999  # kernel vs plain, same f32 expressions
ORACLE_AGREE = 0.999  # kernel vs the float64 plain version
REL_TOL = 1e-6  # t/u/v/normal: |a - b| <= REL_TOL * max(|b|, 1)
MEAN_TOL = 0.01  # cross-backend image means
PLAIN_RAYS = 16384  # walk plain versions at the render's shapes
PEAK_FLOPS = 67e12  # H100 SXM float32, outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# float32 operations per ray x triangle pair, counted from the sources
FLOPS = {"closest": 47, "any": 46, "walk_closest": 42, "walk_any": 41}
DEVICE = "cuda"
DENSE_SRC = "path_tracer_tpu_torch/csrc/dense_hit.cu"
WALK_SRC = "path_tracer_tpu_torch/csrc/walk_hit.cu"
REPLACES = {
    "closest": "path_tracer_tpu/trace/dense_pallas.py:391",
    "any": "path_tracer_tpu/trace/dense_pallas.py:503",
    "walk_closest": "path_tracer_tpu/trace/walk.py:821",
    "walk_any": "path_tracer_tpu/trace/walk.py:919",
}


def check(ok, what) -> None:
    """Fail the run (an explicit raise: ``assert`` vanishes under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int):
    """(mean device time of ``fn()`` over ``reps`` calls by CUDA events, the
    output of the one warm-up call before them)."""
    out = fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def close_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() <= REL_TOL * torch.clamp(b.abs(), min=1.0)


def camera_rays(cam, w, h, dev):
    """Pixel-centre camera rays of a w x h film."""
    from path_tracer_tpu_torch.camera import ray_directions

    ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
    org = torch.as_tensor(cam.origin, device=dev)
    ys, xs = torch.meshgrid(
        torch.arange(h, device=dev, dtype=torch.float32),
        torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
    )
    d = ray_directions(ndc, org, ((xs + 0.5) / w).reshape(-1), ((ys + 0.5) / h).reshape(-1))
    return org.expand(d.shape[0], 3).contiguous(), d.contiguous()


def unit_rows(rng, n, dev):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=dev)


def edge_lanes(rng, o, d, tl, dev):
    """Mark lanes of a ray set: 512 with t_limit 0, 512 with a finite limit,
    64 NaN origins, 64 NaN directions. Returns the permutation used."""
    lanes = rng.permutation(o.shape[0])
    pick = lambda a, b: torch.as_tensor(lanes[a:b], device=dev)  # noqa: E731
    tl[pick(0, 512)] = 0.0
    tl[pick(512, 1024)] = torch.as_tensor(rng.uniform(50.0, 800.0, 512).astype(np.float32), device=dev)
    o[pick(1024, 1088)] = math.nan
    d[pick(1088, 1152)] = math.nan
    return lanes


def light_targets(rng, scene, n, dev):
    """n random points on the scene's light triangles."""
    lp = scene["light"]["positions_flat"]
    uv = torch.as_tensor(rng.uniform(0.0, 0.5, (n, 2)).astype(np.float32), device=dev)
    rows = lp.index_select(0, torch.as_tensor(rng.integers(0, lp.shape[0], n), device=dev))
    return (rows[:, 0:3] * (1 - uv[:, :1] - uv[:, 1:]) + rows[:, 3:6] * uv[:, :1]
            + rows[:, 6:9] * uv[:, 1:])


# --- the dense kernels (mesh_scene) ---


def check_closest(label, k, p, o, d) -> float:
    """Kernel rows ``k`` against plain rows ``p`` (``[N, 8]``: t, idx, u, v,
    normal xyz, model) on the same rays; returns max |k - p| over the
    lanes whose winners agree."""
    same = k[:, 1] == p[:, 1]
    agree = same.float().mean().item()
    hit = same & (p[:, 1] >= 0)
    ok_vals = torch.stack([close_rel(k[:, c], p[:, c]) for c in (0, 2, 3, 4, 5, 6)], 1).all(1)
    ok_model = k[:, 7] == p[:, 7]
    nan_lane = ~(torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    cmp = same & ~nan_lane  # a NaN ray's epilogue values are NaN in both
    err = (k[cmp] - p[cmp]).abs().max().item()
    print(f"closest {label}: {k.shape[0]} rays, winners equal to plain {agree:.6f}, "
          f"t/u/v/normal within {REL_TOL:g} on {ok_vals[hit].float().mean().item():.6f} "
          f"of common hits, model equal {ok_model[same].float().mean().item():.6f}, "
          f"max |kernel - plain| {err:.3g}, hits {(p[:, 1] >= 0).float().mean().item():.3f}")
    check(agree >= WINNER_AGREE, (label, agree))
    check(bool(ok_vals[hit].all()) and bool(ok_model[same].all()),
          f"{label}: t/u/v/normal/model of common winners")
    check(bool((k[nan_lane, 1] == -1).all()), f"{label}: NaN lanes must report no hit")
    return err


def check_any(label, k, p, o, d, t_limit) -> float:
    """Kernel any-hit flags against plain ones on lanes with t_limit > 0;
    returns max |k - p| over those lanes."""
    pos = t_limit > 0
    equal = (k[pos] == p[pos]).float().mean().item()
    err = (k[pos].float() - p[pos].float()).abs().max().item()
    nan_lane = ~(torch.isfinite(o).all(1) & torch.isfinite(d).all(1))
    print(f"any {label}: {k.shape[0]} rays, flags equal to plain on t_limit > 0 lanes "
          f"{equal:.6f}, occluded {p[pos].float().mean().item():.3f}, NaN lanes flagged "
          f"{int(k[nan_lane].sum())}")
    check(equal == 1.0, (label, equal))
    check(not bool(k[nan_lane].any()), f"{label}: NaN lanes must report no hit")
    return err


def dense_pairs(dc, key, aux, o, d, t_limit) -> int:
    """Ray x row pairs the dense query needs on these rays: a live lane of
    the closest hit tests every row; a live lane of the shadow test tests
    rows up to its first hit in table order (all if none); dead lanes none."""
    live = ((t_limit > 0) & torch.isfinite(o).all(1) & torch.isfinite(d).all(1)).nonzero()[:, 0]
    nt = aux.shape[0]
    if key == "closest":
        return live.numel() * nt
    total, step = 0, max(1, (1 << 25) // nt)
    for s in range(0, live.numel(), step):
        r = live[s : s + step]
        det, td, ud, vd = dc._search_terms(aux, *dc._ray_cols(o[r], d[r]))
        hit = (dc._same(td - det * dc.EPSILON, det * t_limit[r, None] - td)
               & dc._same(ud, det - ud) & dc._same(vd, det - ud - vd) & (det != 0.0))
        total += int(torch.where(hit.any(1), hit.to(torch.uint8).argmax(1) + 1, nt).sum())
    return total


def phase_dense(dc, scene, cam, dev, card):
    """Phase 3: kernel vs plain vs float64 oracle on a mixed ray set, then
    kernel vs plain again, and both timed, at the render's shapes."""
    aux = scene["tri"]["dense"]["aux"]
    light_aux = scene["light"]["dense"]["aux"]
    rng = np.random.default_rng(1234)

    # 65,536 camera rays + 65,536 random rays inside the Cornell box
    o_cam, d_cam = camera_rays(cam, CAMERA_GRID, CAMERA_GRID, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (N_RANDOM, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, N_RANDOM, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    tlc = torch.clamp(tl, max=3.0e38)

    k = dc.closest_cuda(aux, o, d, tlc)
    p = dc.closest_plain(aux, o, d, tlc)
    errs = {"closest": check_closest("mixed", k, p, o, d)}
    oracle = dc.closest_plain(aux.double(), o.double(), d.double(), tlc.double())
    oracle_agree = (k[:, 1].double() == oracle[:, 1]).float().mean().item()
    print(f"closest mixed: winners equal to the float64 oracle {oracle_agree:.6f}")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)

    # any-hit: shadow-like limits around each ray's closest t, plus the edge lanes
    t_hit = torch.where(p[:, 1] >= 0, p[:, 0], 1000.0)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), t_hit * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = torch.clamp(tl_any, max=3.0e38)
    ka = dc.any_cuda(aux, o, d, tl_anyc)
    pa = dc.any_plain(aux, o, d, tl_anyc)
    errs["any"] = check_any("mixed", ka, pa, o, d, tl_any)

    # The render's shapes: the world query over the whole film's camera
    # rays, the lights pretest over as many rays from the surface (half
    # toward the light, half in random directions), and one any-hit over 2N
    # shadow rays toward the light. Kernel and plain are compared on each.
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), 3.0e38, device=dev)
    hit_f = dc.closest_plain(aux, o_f, d_f, tl_f)
    p_hit = o_f + d_f * torch.where(hit_f[:, 1] >= 0, hit_f[:, 0], 0.0)[:, None]
    o_s = torch.cat([p_hit, p_hit])
    vec = light_targets(rng, scene, 2 * nf, dev) - o_s
    dist = vec.norm(dim=1)
    d_s = (vec / dist[:, None]).contiguous()
    tl_s = torch.where(torch.cat([hit_f[:, 1], hit_f[:, 1]]) >= 0, dist * (1 - 5e-4), 0.0)
    d_l = torch.where((torch.arange(nf, device=dev) % 2 == 0)[:, None], d_s[:nf],
                      unit_rows(rng, nf, dev)).contiguous()
    queries = {
        "closest": (dc.closest_cuda, dc.closest_plain, aux, o_f, d_f, tl_f),
        "closest lights": (dc.closest_cuda, dc.closest_plain, light_aux, p_hit, d_l, tl_f),
        "any": (dc.any_cuda, dc.any_plain, aux, o_s, d_s, tl_s),
    }
    results = {}
    for name, (kern, plain, tab, qo, qd, qt) in queries.items():
        km, kout = time_ms(lambda: kern(tab, qo, qd, qt), 5)
        pm, pout = time_ms(lambda: plain(tab, qo, qd, qt), 1)
        if name == "any":
            err = check_any("render shape", kout, pout, qo, qd, qt)
        else:
            err = check_closest(f"render shape{name[7:]}", kout, pout, qo, qd)
        key = name.split()[0]
        errs[key] = max(errs[key], err)
        nq, nt = qo.shape[0], tab.shape[0]
        # bytes: rays in, the rows' planes and shading, results out
        out_bytes = 32 if key == "closest" else 1
        bms, by = bound_ms(dense_pairs(dc, key, tab, qo, qd, qt) * FLOPS[key],
                           nq * (28 + out_bytes) + nt * 96)
        results[name] = {"ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by, "rays": nq}
        print(f"time {name}: kernel {km:.3f} ms, plain {pm:.3f} ms, bound {bms:.3f} ms ({by}) "
              f"at {nq} rays x {nt} table rows ({card})")
    return errs, results


def render_cli(scene_name, spp, card, keys):
    """One offline render through the CLI, launch counts zeroed just before
    and read just after; checks the film and that ``keys`` launched."""
    from path_tracer_tpu_torch import cli
    from path_tracer_tpu_torch.trace.cuda_lib import LAUNCHES

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t0 = time.perf_counter()
    res = cli.main([
        "--scene", scene_name, "--width", str(WIDTH), "--height", str(HEIGHT),
        "--spp", str(spp), "--max-bounces", str(MAX_BOUNCES),
        "--out", str(OUT_DIR / f"smoke_{scene_name}.png"), "--device", DEVICE,
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    film = res["film"]
    check(film.shape == (HEIGHT, WIDTH, 4), tuple(film.shape))
    check(bool(torch.isfinite(film).all()), "film has non-finite values")
    mean = film[..., :3].mean().item() / spp
    check(mean > 0.0, mean)
    check(bool((film[..., 3] == spp).all()), "sample count in the film's alpha")
    ph = res["phases"]
    print(f"render {scene_name} {WIDTH}x{HEIGHT} {spp} spp: {seconds:.2f} s end to end, "
          f"host build {ph['scene build'] + ph['upload']:.2f} s (scene {ph['scene build']:.2f} s, "
          f"upload {ph['upload']:.2f} s), trace {res['trace_s']:.2f} s, "
          f"{res['mrays_per_s']:.4f} Mrays/s, {res['spp_per_s']:.4f} spp/s, "
          f"mean radiance {mean:.5f}, launches {launches} ({card})")
    check(all(launches[k] > 0 for k in keys), (keys, launches))
    return launches, res


def cross_backend(make, width, height, spp):
    """The same render on the CPU (plain versions) and on the card."""
    from path_tracer_tpu_torch.integrator.wavefront import render

    means = {}
    for dev in ("cpu", DEVICE):
        sh, cam = make()
        t0 = time.perf_counter()
        film = render(sh, cam, width, height, spp, dev, max_bounces=MAX_BOUNCES)
        means[dev] = film[..., :3].mean().item()
        print(f"  {width}x{height} {spp} spp on {dev}: mean {means[dev]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    rel = abs(means[DEVICE] - means["cpu"]) / means["cpu"]
    print(f"  cross-backend mean rel diff {rel:.5f} (limit {MEAN_TOL})")
    check(rel <= MEAN_TOL, rel)


# --- the walk kernels (dragon_scene) ---


def check_walk_closest(label, kt, ks, pt, ps, nan_lane) -> float:
    """Kernel (best_t, slot) against plain on the same sorted rays; returns
    max |t_kernel - t_plain| over the lanes whose winners agree."""
    same = ks == ps
    agree = same.float().mean().item()
    err = (kt[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    print(f"walk closest {label}: {ks.shape[0]} rays, winners equal to plain {agree:.6f}, "
          f"max |t kernel - t plain| {err:.3g}, hits {(ps >= 0).float().mean().item():.3f}")
    check(agree >= WINNER_AGREE, (label, agree))
    check(bool((ks[nan_lane] == -1).all()), f"{label}: NaN lanes must report no hit")
    return err


def whole_blocks(rng, live, count):
    """Rows of ``count`` random whole 128-ray blocks among those with a live
    lane, in order (a block's visit order depends on its first ray, so
    subsets keep whole blocks; the ray count is a multiple of 128 here)."""
    cand = torch.unique(live.nonzero()[:, 0] // 128).cpu().numpy()
    blk = np.sort(rng.choice(cand, size=min(count, cand.size), replace=False))
    return torch.as_tensor((blk[:, None] * 128 + np.arange(128)).reshape(-1), device=live.device)


def chunk_spans(walk, eng):
    """Real triangles per chunk in layout order (pad rows of ``aux`` are
    zero rows), int64 [chunks]."""
    k = walk.num_chunks(eng)
    return (eng["aux"][:, :12] != 0).any(1).view(k, walk.CH_W).sum(1)


def needed_walk_work(walk, eng, o, d, t_limit, t_stop, stop_chunk=None):
    """(ray x triangle pairs, distinct chunks, their real triangles) that a
    walk query on these rays needs, from each ray's own slab test against
    every chunk box: a live ray needs the real triangles of every chunk it
    enters at t <= ``t_stop``. With ``stop_chunk`` (a shadow query), a ray
    whose entry is >= 0 (the layout chunk of its closest occluder) needs
    only that chunk's triangles."""
    spans = chunk_spans(walk, eng)
    k, dev = spans.numel(), o.device
    cols = eng["ord_oct"][0, :k].long()  # octant 0's box columns, in layout chunks
    lo = eng["cb_oct"][0, 0:3, :k].T.contiguous()
    hi = eng["cb_oct"][0, 3:6, :k].T.contiguous()
    span_col = spans[cols]
    live = walk._valid(o, d, t_limit)
    used = torch.zeros(k, dtype=torch.bool, device=dev)
    pairs = 0
    if stop_chunk is not None:
        occ = live & (stop_chunk >= 0)
        pairs += int(spans[stop_chunk[occ].long()].sum())
        used[stop_chunk[occ].long()] = True
        live = live & ~occ
    rows = live.nonzero()[:, 0]
    step = max(1, (1 << 25) // k)
    for s in range(0, rows.numel(), step):
        r = rows[s : s + step]
        oo, dd, ts = o[r, None, :], d[r, None, :], t_stop[r, None]
        d0 = dd == 0.0
        inv = 1.0 / torch.where(d0, 1.0, dd)
        t1, t2 = (lo - oo) * inv, (hi - oo) * inv
        inside = (oo >= lo) & (oo <= hi)
        near = torch.where(d0, torch.where(inside, -1e30, 1e30), torch.minimum(t1, t2)).amax(2)
        far = torch.where(d0, torch.where(inside, 1e30, -1e30), torch.maximum(t1, t2)).amin(2)
        enter = (near <= far) & (far >= 0.0) & (near <= ts)
        pairs += int(torch.where(enter, span_col, 0).sum())
        used[cols[enter.any(0)]] = True
    return pairs, int(used.sum()), int(spans[used].sum())


def walk_bound(n, out_bytes, need, key):
    """Least time of one walk query on n rays from ``needed_walk_work``'s
    count: the needed pairs' float32 operations; the rays in and out, and
    the needed chunks' plane rows (48 B per real triangle) and boxes (24 B)
    read once."""
    pairs, chunks, tris = need
    return bound_ms(pairs * FLOPS[key], n * (28 + out_bytes) + tris * 48 + chunks * 24)


def phase_walk(walk, scene, cam, dev, card):
    """Phases 6-7: the walk kernels against their plain versions on the full
    dragon world table, on a mixed ray set and at the render's shapes."""
    eng = scene["tri"]["walk"]
    rng = np.random.default_rng(4321)
    k = walk.num_chunks(eng)
    print(f"walk table: {k} chunks, {eng['aux'].shape[0]} slots, "
          f"{eng['aux'].numel() * 4 / 2**20:.1f} MiB aux")

    # 6: 32,768 camera rays + 32,768 random rays inside the Cornell box
    o_cam, d_cam = camera_rays(cam, 256, 128, dev)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (32768, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(rng, 32768, dev)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = edge_lanes(rng, o, d, tl, dev)
    order, o_s, d_s, tl_s = walk._sorted_rays(eng, o, d, tl)
    nan_s = ~(torch.isfinite(o_s).all(1) & torch.isfinite(d_s).all(1))
    kt, ks = walk.closest_cuda(eng, o_s, d_s, tl_s)
    pt, ps = walk.closest_plain(eng, o_s, d_s, tl_s)
    errs = {"walk_closest": check_walk_closest("mixed", kt, ks, pt, ps, nan_s)}
    rows = whole_blocks(rng, walk._valid(o_s, d_s, tl_s), 32)  # 4,096 rays
    eng64 = {**eng, "aux": eng["aux"].double()}
    _, os64 = walk.closest_plain(eng64, o_s[rows].double(), d_s[rows].double(), tl_s[rows].double())
    oracle_agree = (ks[rows] == os64).float().mean().item()
    print(f"walk closest mixed: winners equal to the float64 plain version {oracle_agree:.6f} "
          f"on {rows.numel()} rays")
    check(oracle_agree >= ORACLE_AGREE, oracle_agree)
    # any hit: limits around each ray's closest t (unsorted rays), plus the edge lanes
    hit_t = torch.empty_like(kt)
    hit_t[order] = torch.where(ks >= 0, kt, 1000.0)
    scale = torch.as_tensor(rng.uniform(0.5, 1.5, n).astype(np.float32), device=dev)
    tl_any = torch.where(torch.isinf(tl), hit_t * scale, tl)
    tl_any[torch.as_tensor(lanes[1152:1664], device=dev)] = math.inf
    tl_anyc = walk._exit_clamp(eng, o, d, tl_any).contiguous()
    ka = walk.any_cuda(eng, o, d, tl_anyc)
    pa = walk.any_plain(eng, o, d, tl_anyc)
    errs["walk_any"] = check_any("walk mixed", ka, pa, o, d, tl_any)

    # 7: the render's shapes
    o_f, d_f = camera_rays(cam, WIDTH, HEIGHT, dev)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), math.inf, device=dev)
    order_f, o_fs, d_fs, tl_fs = walk._sorted_rays(eng, o_f, d_f, tl_f)
    ct, cs = walk.closest_cuda(eng, o_fs, d_fs, tl_fs)
    hit_s = cs >= 0
    p_hit = o_fs + d_fs * torch.where(hit_s, ct, 0.0)[:, None]  # camera hits, sorted order
    d_b = unit_rows(rng, nf, dev)
    tl_b = torch.where(hit_s, math.inf, 0.0)
    _, o_bs, d_bs, tl_bs = walk._sorted_rays(eng, p_hit, d_b, tl_b)
    hit_px = torch.empty_like(p_hit)
    hit_px[order_f] = p_hit  # back to pixel order, as the integrator holds them
    hit_pxm = torch.empty_like(hit_s)
    hit_pxm[order_f] = hit_s
    o_sh = torch.cat([hit_px, hit_px]).contiguous()
    vec = light_targets(rng, scene, 2 * nf, dev) - o_sh
    dist = vec.norm(dim=1)
    d_sh = (vec / dist[:, None]).contiguous()
    tl_sh = torch.where(torch.cat([hit_pxm, hit_pxm]), dist * (1 - 5e-4), 0.0)
    tl_shc = walk._exit_clamp(eng, o_sh, d_sh, tl_sh).contiguous()
    # each shadow ray's closest occluder, for the shadow query's needed work
    _, o_ss, d_ss, tl_ss = walk._sorted_rays(eng, o_sh, d_sh, tl_sh)
    _, occ_slot = walk.closest_cuda(eng, o_ss, d_ss, tl_ss)
    occ_chunk = torch.where(occ_slot >= 0, occ_slot // walk.CH_W, -1)
    # name: (kernel, its inputs, the public query's inputs for walk_stats, reps)
    shapes = {
        "camera": ("walk_closest", (o_fs, d_fs, tl_fs), (o_f, d_f, tl_f), 5),
        "bounce": ("walk_closest", (o_bs, d_bs, tl_bs), (p_hit, d_b, tl_b), 2),
        "shadow": ("walk_any", (o_sh, d_sh, tl_shc), (o_sh, d_sh, tl_sh), 2),
    }
    results = {}
    for name, (key, (qo, qd, qt), public, reps) in shapes.items():
        nq = qo.shape[0]
        if key == "walk_closest":
            km, (kt, ks) = time_ms(lambda: walk.closest_cuda(eng, qo, qd, qt), reps)
            rows = whole_blocks(rng, walk._valid(qo, qd, qt), PLAIN_RAYS // 128)
            pm, (pt, ps) = time_ms(lambda: walk.closest_plain(eng, qo[rows], qd[rows], qt[rows]), 1)
            nan_r = ~(torch.isfinite(qo[rows]).all(1) & torch.isfinite(qd[rows]).all(1))
            err = check_walk_closest(f"render shape {name}", kt[rows], ks[rows], pt, ps, nan_r)
            stats = walk.walk_stats(eng, *public)
            need = needed_walk_work(walk, eng, qo, qd, qt, torch.where(ks >= 0, kt, qt))
            out_bytes = 8
        else:
            km, ka = time_ms(lambda: walk.any_cuda(eng, qo, qd, qt), reps)
            live = walk._valid(qo, qd, qt).nonzero()[:, 0].cpu().numpy()
            rows = torch.as_tensor(np.sort(rng.choice(live, PLAIN_RAYS, replace=False)), device=dev)
            pm, pa = time_ms(lambda: walk.any_plain(eng, qo[rows], qd[rows], qt[rows]), 1)
            err = check_any(f"walk render shape {name}", ka[rows], pa, qo[rows], qd[rows], qt[rows])
            stats = walk.walk_stats(eng, *public, query="any")
            need = needed_walk_work(walk, eng, o_ss, d_ss, tl_ss, tl_ss, occ_chunk)
            out_bytes = 1
        errs[key] = max(errs[key], err)
        bms, by = walk_bound(nq, out_bytes, need, key)
        live = max(stats["blocks"], 1)
        results[name] = {"key": key, "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": by,
                         "rays": nq, "stats": stats, "needed_pairs": need[0]}
        print(f"time walk {name}: kernel {km:.3f} ms at {nq} rays, plain {pm:.3f} ms at "
              f"{rows.numel()} rays, bound {bms:.3f} ms ({by}) from {need[0]} needed pairs "
              f"in {need[1]} chunks; pairs the kernel tested {stats['lane_visits'] * 128} "
              f"(lane visits x {walk.CH_W} slots); blocks with a live lane "
              f"{stats['blocks']}, chunks visited per block {stats['visits'] / live:.1f}, "
              f"skipped by the window per block {stats['skipped'] / live:.1f}, testing lanes "
              f"per visit {stats['lane_visits'] / max(stats['visits'], 1):.1f}, distinct chunks "
              f"{stats['chunks']} of {k} ({card})")
    pub_ms, _ = time_ms(lambda: walk.walk_closest_hit_shade(eng, o_f, d_f, tl_f), 3)
    print(f"time walk camera public query (sort, kernel, unsort, epilogue): {pub_ms:.3f} ms")
    return errs, results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"card: {card}")
    t_start = time.perf_counter()

    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.trace import cuda_lib
    from path_tracer_tpu_torch.trace import dense_cuda as dc
    from path_tracer_tpu_torch.trace import walk

    t0 = time.perf_counter()
    libs = cuda_lib.build("dense_hit", "walk_hit")
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(p.name for p in libs)})")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {lib.name}:", line.strip())
    dev = torch.device(DEVICE)

    sh, cam = scenes.mesh_scene(aspect=WIDTH / HEIGHT)
    errs, dense_t = phase_dense(dc, sh.device(DEVICE), cam, dev, card)
    dense_launches, _ = render_cli("mesh_scene", SPP, card, ("closest", "any"))
    print("cornell_specular:")
    cross_backend(scenes.cornell_specular, 64, 64, 4)

    t0 = time.perf_counter()
    sh, cam = scenes.dragon_scene(aspect=WIDTH / HEIGHT)
    t1 = time.perf_counter()
    scene = sh.device(DEVICE)
    torch.cuda.synchronize()
    print(f"dragon_scene: {sh.num_world_tris} world tris, scene build {t1 - t0:.1f} s, "
          f"upload with walk packing {time.perf_counter() - t1:.1f} s")
    walk_errs, walk_t = phase_walk(walk, scene, cam, dev, card)
    errs.update(walk_errs)
    del scene
    walk_launches, res = render_cli("dragon_scene", DRAGON_SPP, card,
                                    ("walk_closest", "walk_any", "closest"))
    print(f"dragon_scene bounce steps: {walk_launches['walk_any']} (one any-hit per step)")
    print("dragon_scene(nu=96, nv=64, env_h=64):")
    cross_backend(lambda: scenes.dragon_scene(nu=96, nv=64, env_h=64), 32, 32, 4)

    rows = {
        "closest": dense_t["closest"], "any": dense_t["any"],
        "walk_closest": walk_t["bounce"], "walk_any": walk_t["shadow"],
    }
    launches = {**{k: dense_launches[k] for k in ("closest", "any")},
                **{k: walk_launches[k] for k in ("walk_closest", "walk_any")}}
    kernels = []
    for key, r in rows.items():
        walk_key = key.startswith("walk")
        kernels.append({
            "name": key if walk_key else f"dense_{key}", "route": "cuda",
            "source": WALK_SRC if walk_key else DENSE_SRC, "replaces": REPLACES[key],
            "launches": launches[key], "max_abs_err": errs[key], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "rays": r["rays"],
            "plain_rays": PLAIN_RAYS if walk_key else r["rays"],
        })
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
