"""End-to-end smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero without the final
``ok`` line):

1. environment: torch, CUDA, the card's name and power limit;
2. build the dense kernels from ``path_tracer_tpu_torch/csrc``;
3. each kernel against its plain torch version on ``mesh_scene``'s world
   table (65,536 camera + 65,536 random rays, with inf / 0 / NaN lanes),
   plus a float64 run of the plain closest hit as a precision oracle; then
   both versions compared again, and timed, at the shapes the render gives
   them: the world query over 589,824 camera rays, the lights pretest over
   589,824 rays on the light table, the any-hit over 1,179,648 shadow rays;
4. the offline render of ``mesh_scene`` at 1024x576, 8 spp, 64 bounces
   through ``path_tracer_tpu_torch.cli``, with the kernels' launch counts;
5. ``cornell_specular`` at 64x64, 4 spp rendered on the CPU (plain
   versions) and on the card (kernels): image means within 1%.

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
CAMERA_GRID = 256  # 256 x 256 = 65,536 camera rays
N_RANDOM = 65536
WINNER_AGREE = 0.9999  # kernel vs plain, same f32 expressions
ORACLE_AGREE = 0.999  # kernel vs the float64 plain version
REL_TOL = 1e-6  # t/u/v/normal: |a - b| <= REL_TOL * max(|b|, 1)
MEAN_TOL = 0.01  # cross-backend image means
DEVICE = "cuda"


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


def close_rel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs() <= REL_TOL * torch.clamp(b.abs(), min=1.0)


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


def phase_kernels(dc, scene, cam, dev, card):
    """Phase 3: kernel vs plain vs float64 oracle on a mixed ray set, then
    kernel vs plain again, and both timed, at the render's shapes."""
    from path_tracer_tpu_torch.camera import ray_directions

    aux = scene["tri"]["dense"]["aux"]
    light_aux = scene["light"]["dense"]["aux"]
    ndc = torch.as_tensor(cam.view_proj_inverse(), device=dev)
    org = torch.as_tensor(cam.origin, device=dev)
    rng = np.random.default_rng(1234)

    def camera_rays(w, h):
        ys, xs = torch.meshgrid(
            torch.arange(h, device=dev, dtype=torch.float32),
            torch.arange(w, device=dev, dtype=torch.float32), indexing="ij",
        )
        d = ray_directions(ndc, org, ((xs + 0.5) / w).reshape(-1), ((ys + 0.5) / h).reshape(-1))
        return org.expand(d.shape[0], 3).contiguous(), d.contiguous()

    def unit_rows(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return torch.as_tensor(v / np.linalg.norm(v, axis=1, keepdims=True), device=dev)

    # 65,536 camera rays + 65,536 random rays inside the Cornell box
    o_cam, d_cam = camera_rays(CAMERA_GRID, CAMERA_GRID)
    o_rnd = rng.uniform((-278, 0, -278), (278, 555, 278), (N_RANDOM, 3)).astype(np.float32)
    o = torch.cat([o_cam, torch.as_tensor(o_rnd, device=dev)])
    d = torch.cat([d_cam, unit_rows(N_RANDOM)])
    n = o.shape[0]
    tl = torch.full((n,), math.inf, device=dev)
    lanes = rng.permutation(n)
    tl[torch.as_tensor(lanes[:512], device=dev)] = 0.0
    tl[torch.as_tensor(lanes[512:1024], device=dev)] = torch.as_tensor(
        rng.uniform(50.0, 800.0, 512).astype(np.float32), device=dev)
    o[torch.as_tensor(lanes[1024:1088], device=dev)] = math.nan
    d[torch.as_tensor(lanes[1088:1152], device=dev)] = math.nan
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
    o_f, d_f = camera_rays(WIDTH, HEIGHT)
    nf = o_f.shape[0]
    tl_f = torch.full((nf,), 3.0e38, device=dev)
    hit_f = dc.closest_plain(aux, o_f, d_f, tl_f)
    p_hit = o_f + d_f * torch.where(hit_f[:, 1] >= 0, hit_f[:, 0], 0.0)[:, None]
    lp = scene["light"]["positions_flat"]
    uv = torch.as_tensor(rng.uniform(0.0, 0.5, (2 * nf, 2)).astype(np.float32), device=dev)
    li = torch.as_tensor(rng.integers(0, lp.shape[0], 2 * nf), device=dev)
    rows = lp.index_select(0, li)
    target = (rows[:, 0:3] * (1 - uv[:, :1] - uv[:, 1:]) + rows[:, 3:6] * uv[:, :1]
              + rows[:, 6:9] * uv[:, 1:])
    o_s = torch.cat([p_hit, p_hit])
    vec = target - o_s
    dist = vec.norm(dim=1)
    d_s = (vec / dist[:, None]).contiguous()
    tl_s = torch.where(torch.cat([hit_f[:, 1], hit_f[:, 1]]) >= 0, dist * (1 - 5e-4), 0.0)
    d_l = torch.where((torch.arange(nf, device=dev) % 2 == 0)[:, None], d_s[:nf],
                      unit_rows(nf)).contiguous()
    queries = {
        "closest": (dc.closest_cuda, dc.closest_plain, aux, o_f, d_f, tl_f),
        "closest lights": (dc.closest_cuda, dc.closest_plain, light_aux, p_hit, d_l, tl_f),
        "any": (dc.any_cuda, dc.any_plain, aux, o_s, d_s, tl_s),
    }
    times = {}
    for name, (kern, plain, tab, qo, qd, qt) in queries.items():
        km, kout = time_ms(lambda: kern(tab, qo, qd, qt), 5)
        pm, pout = time_ms(lambda: plain(tab, qo, qd, qt), 1)
        if name == "any":
            err = check_any("render shape", kout, pout, qo, qd, qt)
        else:
            err = check_closest(f"render shape{name[7:]}", kout, pout, qo, qd)
        key = name.split()[0]
        errs[key] = max(errs[key], err)
        times[name] = (km, pm)
        print(f"time {name}: kernel {km:.3f} ms, plain {pm:.3f} ms at {qo.shape[0]} rays x "
              f"{tab.shape[0]} table rows ({card})")
    return errs, times


def phase_render(dc, card):
    """Phase 4: the offline render through the CLI entry point."""
    from path_tracer_tpu_torch import cli

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for key in dc.LAUNCHES:
        dc.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    res = cli.main([
        "--scene", "mesh_scene", "--width", str(WIDTH), "--height", str(HEIGHT),
        "--spp", str(SPP), "--max-bounces", str(MAX_BOUNCES),
        "--out", str(OUT_DIR / "smoke_mesh_scene.png"), "--device", DEVICE,
    ])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(dc.LAUNCHES)
    film = res["film"]
    check(film.shape == (HEIGHT, WIDTH, 4), tuple(film.shape))
    check(bool(torch.isfinite(film).all()), "film has non-finite values")
    mean = film[..., :3].mean().item() / SPP
    check(mean > 0.0, mean)
    check(bool((film[..., 3] == SPP).all()), "sample count in the film's alpha")
    print(f"render mesh_scene {WIDTH}x{HEIGHT} {SPP} spp: {seconds:.2f} s end to end, "
          f"trace {res['trace_s']:.2f} s, {res['mrays_per_s']:.2f} Mrays/s, "
          f"{res['spp_per_s']:.3f} spp/s, mean radiance {mean:.5f}, launches {launches} ({card})")
    check(launches["closest"] > 0 and launches["any"] > 0, launches)
    return launches


def phase_cross_backend():
    """Phase 5: the same render on the CPU (plain versions) and the card."""
    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.integrator.wavefront import render

    means = {}
    for dev in ("cpu", DEVICE):
        sh, cam = scenes.cornell_specular()
        t0 = time.perf_counter()
        film = render(sh, cam, 64, 64, 4, dev, max_bounces=MAX_BOUNCES)
        means[dev] = film[..., :3].mean().item()
        print(f"cornell_specular 64x64 4 spp on {dev}: mean {means[dev]:.6f} "
              f"({time.perf_counter() - t0:.1f} s)")
    rel = abs(means[DEVICE] - means["cpu"]) / means["cpu"]
    print(f"cross-backend mean rel diff {rel:.5f} (limit {MEAN_TOL})")
    check(rel <= MEAN_TOL, rel)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"card: {card}")

    from path_tracer_tpu_torch import scenes
    from path_tracer_tpu_torch.trace import dense_cuda as dc

    t0 = time.perf_counter()
    lib = dc.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({lib.name})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    sh, cam = scenes.mesh_scene(aspect=WIDTH / HEIGHT)
    scene = sh.device(DEVICE)
    errs, times = phase_kernels(dc, scene, cam, torch.device(DEVICE), card)
    launches = phase_render(dc, card)
    phase_cross_backend()

    src = "path_tracer_tpu_torch/csrc/dense_hit.cu"
    replaces = {"closest": "path_tracer_tpu/trace/dense_pallas.py:391",
                "any": "path_tracer_tpu/trace/dense_pallas.py:503"}
    kernels = [
        {"name": f"dense_{k}", "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": launches[k], "max_abs_err": errs[k], "ms": times[k][0],
         "plain_ms": times[k][1]}
        for k in ("closest", "any")
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
