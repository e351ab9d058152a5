"""Progressive accumulation and TAA-style temporal reprojection as torch
ops on ``[H, W, C]`` tensors (port of ``path_tracer_tpu/interactive/taa.py``).

The reference's four WGSL pipelines (``src/shaders/``):

* `accumulate`: ``accumulate.wgsl``, output = accumulation + (rgb, 1); the
  sample count lives in alpha.
* `compute_velocity`: ``velocity.wgsl``, screen-space motion from the
  position buffer reprojected through the previous frame's world->clip.
* `temporal_reproject`: ``compute.wgsl``, 3x3 YCoCg neighbourhood
  statistics, velocity dilation, Catmull-Rom history fetch, variance clip
  (mu +- gamma*sigma), 0.15 blend, and a 16-bit model-id disocclusion test
  that falls back to a 2x2 box filter.
* `display_frame`: ``shader.wgsl``, rgb/alpha + Gran Turismo tonemap.

The JAX package leaves these to XLA (none is a Pallas kernel), so plain
torch ops are the port here. Reference quirk kept: the closest-depth
velocity dilation reads depth from the colour texture's alpha, which the
integrator always writes as 1.0 (``integrator.rs:274``), so it picks the
top-left in-bounds neighbour: the same iteration order, with strict ``<``.

Ids are ``int64`` holding the JAX package's ``uint32`` bits: each pack is
masked to 32 bits, so ``prev << 16`` drops the high bits as a ``uint32``
shift does (CUDA's ``uint32`` shifts are thinly supported in torch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from path_tracer_tpu_torch.core.tonemap import gt_tonemap

_ID_MASK = 0xFFFFFFFF


def accumulate(accumulation: torch.Tensor, colour: torch.Tensor) -> torch.Tensor:
    """``accumulate.wgsl``: add (rgb, 1) to the running accumulation [H,W,4]."""
    rgb = colour[..., :3]
    return accumulation + torch.cat([rgb, torch.ones_like(rgb[..., :1])], dim=-1)


def w_divide(v: torch.Tensor) -> torch.Tensor:
    """``v.xyz / max(v.w, 1.0)`` (velocity.wgsl / compute.wgsl helper)."""
    return v[..., :3] / torch.clamp(v[..., 3:4], min=1.0)


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` rounded once, as on the CPU: CUDA divides by a host scalar
    as a multiply by its reciprocal, an ulp off, and these quotients feed
    floors (pixel indices)."""
    return x / torch.tensor(float(s), dtype=x.dtype, device=x.device)


def _pixel_uv(h: int, w: int, device) -> torch.Tensor:
    """Pixel-centre uv ``[H, W, 2]`` (u along the row)."""
    ys = _div(torch.arange(h, dtype=torch.float32, device=device) + 0.5, h)
    xs = _div(torch.arange(w, dtype=torch.float32, device=device) + 0.5, w)
    return torch.stack(torch.meshgrid(xs, ys, indexing="xy"), dim=-1)


def compute_velocity(position: torch.Tensor, last_world_to_clip: torch.Tensor) -> torch.Tensor:
    """``velocity.wgsl``: uv-space motion = current_uv - previous_uv.

    ``position``: [H,W,4] world positions (w = depth); ``last_world_to_clip``:
    the previous frame's ``(camera * inv_projection)^-1`` (state.rs:318-325,
    main.rs:213-216). Returns [H,W,2]. The 4x4 transform is written as
    elementwise multiply-adds, not a matmul, so no TF32 enters it whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says."""
    h, w = position.shape[:2]
    m = last_world_to_clip.to(torch.float32)
    x, y, z = position[..., 0], position[..., 1], position[..., 2]

    def row(i):
        return m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]

    clip = torch.stack([row(0), row(1), row(2), row(3)], dim=-1)
    prev_uv = w_divide(clip)[..., :2] * 0.5 + 0.5
    return _pixel_uv(h, w, position.device) - prev_uv


def _rgb_to_ycocg(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return torch.stack(
        [0.25 * r + 0.5 * g + 0.25 * b, 0.5 * r - 0.5 * b, -0.25 * r + 0.5 * g - 0.25 * b], dim=-1)


def _ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], dim=-1)


def _clip_aabb(aabb_min, aabb_max, q):
    """Clip towards the box centre (compute.wgsl:82-101)."""
    p_clip = 0.5 * (aabb_max + aabb_min)
    e_clip = 0.5 * (aabb_max - aabb_min)
    v_clip = q - p_clip
    v_unit = v_clip / torch.where(e_clip == 0.0, 1e-20, e_clip)
    ma_unit = torch.abs(v_unit).amax(dim=-1, keepdim=True)
    clipped = p_clip + v_clip / ma_unit
    return torch.where(ma_unit > 1.0, clipped, q)


def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Clamp-to-edge bilinear sample of ``img [H,W,C]`` at uv in [0,1]
    (half-texel centres, the GPU sampler's convention)."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xf = (x - x0)[..., None]
    yf = (y - y0)[..., None]
    flat = img.reshape(-1, img.shape[-1])

    def at(xi, yi):
        xi = xi.to(torch.int64).clamp(0, w - 1)
        yi = yi.to(torch.int64).clamp(0, h - 1)
        idx = yi * w + xi
        return flat.index_select(0, idx.reshape(-1)).reshape(*idx.shape, flat.shape[-1])

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    return (c00 * (1 - xf) + c10 * xf) * (1 - yf) + (c01 * (1 - xf) + c11 * xf) * yf


def _sample_catmull_rom(tex: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """9-tap Catmull-Rom resample of the w-divided accumulation texture
    (compute.wgsl:16-62)."""
    h, w = tex.shape[:2]
    tex_size = torch.tensor([w, h], dtype=torch.float32, device=tex.device)
    sample_pos = uv * tex_size + 0.5
    tex_pos1 = torch.floor(sample_pos - 0.5) + 0.5
    f = sample_pos - tex_pos1

    w0 = f * (-0.5 + f * (1.0 - 0.5 * f))
    w1 = 1.0 + f * f * (-2.5 + 1.5 * f)
    w2 = f * (0.5 + f * (2.0 - 1.5 * f))
    w3 = f * f * (-0.5 + 0.5 * f)
    w12 = w1 + w2
    offset12 = w2 / torch.where(w12 == 0.0, 1e-20, w12)

    tex_pos0 = (tex_pos1 - 1.0) / tex_size
    tex_pos3 = (tex_pos1 + 2.0) / tex_size
    tex_pos12 = (tex_pos1 + offset12) / tex_size

    def tap(px, py, wx, wy):
        s = _bilinear(tex, torch.stack([px, py], dim=-1))
        return w_divide(s) * (wx * wy)[..., None]

    x0, x12, x3 = tex_pos0[..., 0], tex_pos12[..., 0], tex_pos3[..., 0]
    y0, y12, y3 = tex_pos0[..., 1], tex_pos12[..., 1], tex_pos3[..., 1]
    wx0, wx12, wx3 = w0[..., 0], w12[..., 0], w3[..., 0]
    wy0, wy12, wy3 = w0[..., 1], w12[..., 1], w3[..., 1]

    c = tap(x0, y0, wx0, wy0) + tap(x12, y0, wx12, wy0) + tap(x3, y0, wx3, wy0)
    c = c + (tap(x0, y12, wx0, wy12) + tap(x12, y12, wx12, wy12) + tap(x3, y12, wx3, wy12))
    c = c + (tap(x0, y3, wx0, wy3) + tap(x12, y3, wx12, wy3) + tap(x3, y3, wx3, wy3))
    return c


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """``x [H,W,C]`` padded by one texel on each side with its edge
    values (``jnp.pad(mode="edge")``)."""
    h, w = x.shape[:2]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    return x.index_select(0, rows).index_select(1, cols)


def temporal_reproject(
    colour: torch.Tensor,  # [H,W,4] current frame (rgb, depth-in-alpha quirk: 1.0)
    accumulation: torch.Tensor,  # [H,W,4] history (rgb sum, count)
    velocity: torch.Tensor,  # [H,W,2]
    ids: torch.Tensor,  # [H,W] int64, uint32 bits (prev << 16 | current)
    blend: float = 0.15,
    gamma: float = 1.0,
) -> torch.Tensor:
    """``compute.wgsl:103-213``. Returns the new output [H,W,4] (alpha=1)."""
    h, w = colour.shape[:2]
    dev = colour.device

    # 3x3 neighbourhood stats in YCoCg + top-left-biased velocity dilation
    ycc = _rgb_to_ycocg(colour[..., :3])
    pad_ycc = _pad_edge(ycc)
    pad_depth = F.pad(colour[..., 3], (1, 1, 1, 1), value=float("inf"))
    pad_vel = _pad_edge(velocity)

    m1 = torch.zeros_like(ycc)
    m2 = torch.zeros_like(ycc)
    count = torch.zeros((h, w, 1), dtype=torch.float32, device=dev)
    best_depth = torch.full((h, w), float("inf"), dtype=torch.float32, device=dev)
    best_vel = torch.zeros((h, w, 2), dtype=torch.float32, device=dev)
    # WGSL iterates x (outer), y (inner) with strict <; with the all-equal
    # depth quirk the first in-bounds neighbour wins
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            n_ycc = pad_ycc[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            n_depth = pad_depth[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            n_vel = pad_vel[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            in_bounds = torch.isfinite(n_depth)
            m1 = m1 + torch.where(in_bounds[..., None], n_ycc, 0.0)
            m2 = m2 + torch.where(in_bounds[..., None], n_ycc * n_ycc, 0.0)
            count = count + in_bounds[..., None]
            better = n_depth < best_depth
            best_depth = torch.where(better, n_depth, best_depth)
            best_vel = torch.where(better[..., None], n_vel, best_vel)

    size = torch.tensor([w, h], dtype=torch.float32, device=dev)
    prev_uv = _pixel_uv(h, w, dev) - best_vel
    prev_coords = torch.floor(prev_uv * size).to(torch.int64)

    px = prev_coords[..., 0].clamp(0, w - 1)
    py = prev_coords[..., 1].clamp(0, h - 1)
    prev_ids = ids.reshape(-1)[py * w + px]
    current_id = ids & 0xFFFF
    old_id = (prev_ids >> 16) & 0xFFFF
    out_of_bounds = ((prev_coords[..., 0] < 0) | (prev_coords[..., 1] < 0)
                     | (prev_coords[..., 0] >= w) | (prev_coords[..., 1] >= h))
    disoccluded = (current_id != old_id) | out_of_bounds

    # disocclusion fallback: 2x2 box of the input (compute.wgsl:170-181)
    c0 = torch.stack(torch.meshgrid(_div(torch.arange(w, dtype=torch.float32, device=dev), w),
                                    _div(torch.arange(h, dtype=torch.float32, device=dev), h),
                                    indexing="xy"), dim=-1)
    c1 = c0 + 1.0 / size
    box = (
        _bilinear(colour, c0)
        + _bilinear(colour, torch.stack([c0[..., 0], c1[..., 1]], -1))
        + _bilinear(colour, torch.stack([c1[..., 0], c0[..., 1]], -1))
        + _bilinear(colour, c1)
    ) / 4.0

    # history path: variance clip in YCoCg + Catmull-Rom fetch
    mu = m1 / count
    sigma = torch.sqrt(torch.clamp(m2 / count - mu * mu, min=0.0))
    mn = mu - gamma * sigma
    mx = mu + gamma * sigma
    history = _sample_catmull_rom(accumulation, prev_uv)
    clamped = _ycocg_to_rgb(_clip_aabb(mn, mx, _rgb_to_ycocg(history)))
    blended = clamped * (1.0 - blend) + colour[..., :3] * blend
    blended4 = torch.cat([blended, torch.ones((h, w, 1), dtype=torch.float32, device=dev)], dim=-1)
    return torch.where(disoccluded[..., None], box, blended4)


def display_frame(accumulation: torch.Tensor) -> torch.Tensor:
    """``shader.wgsl`` fragment: rgb/alpha then GT tonemap. Returns [H,W,3]
    in [0,1] (pre-gamma, the reference's sRGB surface handoff)."""
    resolved = accumulation[..., :3] / torch.clamp(accumulation[..., 3:4], min=1e-20)
    return torch.clamp(gt_tonemap(resolved), 0.0, 1.0)


def pack_ids(prev_packed: torch.Tensor, new_id: torch.Tensor) -> torch.Tensor:
    """Per-frame id packing ``(*id << 16) | new`` (main.rs:206), in uint32 bits."""
    return ((prev_packed << 16) | (new_id & 0xFFFF)) & _ID_MASK


def display_letterboxed(frame: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Fit a [H,W,3] frame into an (out_h, out_w) canvas, aspect kept, with
    black bars: the reference's viewport letterboxing on resize
    (state.rs:486-503). Nearest-neighbour scale."""
    h, w = frame.shape[:2]
    scale = min(out_w / w, out_h / h)
    new_w = max(1, int(w * scale))
    new_h = max(1, int(h * scale))
    rows = torch.arange(new_h, dtype=torch.float32, device=frame.device)
    cols = torch.arange(new_w, dtype=torch.float32, device=frame.device)
    ys = _div(rows, scale).to(torch.int32).clamp(0, h - 1)
    xs = _div(cols, scale).to(torch.int32).clamp(0, w - 1)
    scaled = frame[ys][:, xs]
    top = (out_h - new_h) // 2
    left = (out_w - new_w) // 2
    canvas = torch.zeros((out_h, out_w, 3), dtype=frame.dtype, device=frame.device)
    canvas[top:top + new_h, left:left + new_w] = scaled
    return canvas


def frame_update_static(prev_ids, accumulation, colour, new_id):
    """`pack_ids` + `accumulate`. Returns (ids, accumulation)."""
    return pack_ids(prev_ids, new_id), accumulate(accumulation, colour)


def frame_update_moving(prev_ids, accumulation, colour, new_id, position, last_world_to_clip):
    """`pack_ids` + `compute_velocity` + `temporal_reproject`. Returns
    (ids, new accumulation)."""
    ids = pack_ids(prev_ids, new_id)
    velocity = compute_velocity(position, last_world_to_clip)
    return ids, temporal_reproject(colour, accumulation, velocity, ids)


def display_frame_u8(accumulation: torch.Tensor) -> torch.Tensor:
    """`display_frame` rounded (half to even) to uint8 on the device: the
    handoff a swapchain takes, a quarter of the float image's bytes to copy
    to the host."""
    return torch.round(display_frame(accumulation) * 255.0).to(torch.uint8)
