"""The port's segment-schedule prediction (`wavefront.SegmentPredictor`),
case by case as ``tests/test_seg_predict.py``, and the schedule's host
logic (`_seg_caps`, `_seg_steps_for`, `_plan_from_counts`) against the JAX
package's functions.

A predicted frame runs its segment chain from the previous frame's plan
with one status read at its end; an accepted frame must be bit-equal to the
count-driven schedule's, and a plan that would drop live lanes (overflow)
or leave lanes alive (incomplete) is caught on the device and answered with
a count-driven render of the same sample.

One divergence from the reference, kept on purpose: the JAX
``_plan_from_counts`` docstring says the margin bumps a buffer when the
count is "within 25%" of a cap, but its shipped ``PT_SEG_MARGIN`` is 1.05;
the port documents and pins 5% (`test_plan_margin_is_five_percent`).
"""

import numpy as np
import pytest
import torch

from path_tracer_tpu.integrator import wavefront as jwf
from path_tracer_tpu_torch import scenes
from path_tracer_tpu_torch.integrator import wavefront
from path_tracer_tpu_torch.interactive.session import InteractiveRenderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H = 24, 16


def _force_small_schedule(monkeypatch):
    monkeypatch.setattr(wavefront, "_SEG_B0", 2)
    monkeypatch.setattr(wavefront, "_SEG_STEPS", 2)
    monkeypatch.setattr(wavefront, "_seg_caps", lambda n: [(3 * n) // 4, n // 2, n // 4])
    monkeypatch.setattr(wavefront, "_SEG_TAIL_AT", (24 * 16) // 4)
    monkeypatch.setattr(wavefront, "_SEG_TAIL_STEPS", 5)
    monkeypatch.setattr(wavefront, "_SEG_PREDICT", True)


def _setup(scene_name, max_bounces=12):
    sh, cam = getattr(scenes, scene_name)(aspect=W / H)
    scene = sh.device("cpu")
    kw = dict(max_bounces=max_bounces, has_lights="light" in scene, mtypes=sh.active_mtypes,
              any_volumes=sh.has_volumes)
    return scene, torch.from_numpy(cam.view_proj_inverse()), torch.from_numpy(cam.origin), kw


def _assert_equal(ref, got, what):
    for r_, g_, nm in zip(ref, got, ("rad", "pos", "id", "rays")):
        assert torch.equal(r_, g_), f"{what}: {nm} differs"


@pytest.mark.parametrize("scene_name", ["cornell_diffuse", "cornell_specular"])
def test_predicted_matches_exact(monkeypatch, scene_name):
    """Frame 1 seeds the plan (count-driven); later frames run predicted,
    with one host read each; every output equals the count-driven
    schedule's, across samples (other RNG, other alive decay)."""
    _force_small_schedule(monkeypatch)
    scene, ndc, org, kw = _setup(scene_name)
    pred = wavefront.SegmentPredictor()
    samples = (0, 1, 2, 5) if scene_name == "cornell_diffuse" else (0, 5)
    for sample_id in samples:
        ref = wavefront.render_sample_segmented(scene, ndc, org, sample_id, W, H, **kw)
        wavefront.STEPS.update(reads=0)
        got = wavefront.render_sample_segmented(scene, ndc, org, sample_id, W, H, predictor=pred,
                                                **kw)
        _assert_equal(ref, got, f"{scene_name} sample {sample_id}")
        if sample_id and not pred.overflows:
            # the predicted frame's only reads: the status, and the
            # alive.any() before each step of segment 0 and the tail segments
            steps = sum(s for _, s in pred.plan)
            assert wavefront.STEPS["reads"] <= 1 + wavefront._SEG_B0 + steps
    assert pred.plan, "the predictor never built a plan"


def test_only_tail_segments_read_alive(monkeypatch):
    """A resumed segment reads ``alive.any()`` before its steps only at
    buffer sizes <= PT_SEG_TAIL_AT; the larger ones run their planned steps
    with no host read, so a predicted frame reads the device in segment 0,
    in its tail segments and once for its status, and still gives the
    count-driven bits."""
    _force_small_schedule(monkeypatch)
    scene, ndc, org, kw = _setup("cornell_diffuse")
    pred = wavefront.SegmentPredictor()
    wavefront.render_sample_segmented(scene, ndc, org, 0, W, H, predictor=pred, **kw)
    ref = wavefront.render_sample(scene, ndc, org, 1, W, H, **kw)
    calls, inner = [], wavefront.trace_lanes

    def traced(*a, **k):
        r0 = wavefront.STEPS["reads"]
        out = inner(*a, **k)
        calls.append((a[4].shape[0], k.get("init_state") is not None, wavefront.STEPS["reads"] - r0))
        return out

    monkeypatch.setattr(wavefront, "trace_lanes", traced)
    wavefront.STEPS.update(reads=0)
    got = wavefront.render_sample_segmented(scene, ndc, org, 1, W, H, predictor=pred, **kw)
    assert pred.overflows == 0
    _assert_equal(ref, got, "predicted frame")
    resumed = [(n, reads) for n, res, reads in calls if res]
    assert any(n <= wavefront._SEG_TAIL_AT for n, _ in resumed)
    assert any(n > wavefront._SEG_TAIL_AT for n, _ in resumed)
    for n, reads in resumed:
        assert (reads > 0) == (n <= wavefront._SEG_TAIL_AT), (n, reads)
    assert wavefront.STEPS["reads"] == 1 + sum(reads for _, _, reads in calls)


def test_overflow_falls_back_exact(monkeypatch):
    """A plan whose caps lie far below the true alive counts is refused by
    the device's overflow check and answered with the exact schedule: the
    same bits, one overflow counted, and a sane plan rebuilt."""
    _force_small_schedule(monkeypatch)
    scene, ndc, org, kw = _setup("cornell_diffuse")
    pred = wavefront.SegmentPredictor()
    wavefront.render_sample_segmented(scene, ndc, org, 0, W, H, predictor=pred, **kw)
    assert pred.plan and pred.overflows == 0
    floor = min(wavefront._seg_caps(W * H))
    pred.plan = tuple((floor, steps) for _, steps in pred.plan)
    ref = wavefront.render_sample_segmented(scene, ndc, org, 1, W, H, **kw)
    got = wavefront.render_sample_segmented(scene, ndc, org, 1, W, H, predictor=pred, **kw)
    assert pred.overflows == 1, "overflow was not detected"
    _assert_equal(ref, got, "overflow fallback")
    wavefront.render_sample_segmented(scene, ndc, org, 2, W, H, predictor=pred, **kw)
    assert pred.overflows == 1


def test_incomplete_plan_falls_back(monkeypatch):
    """A plan that ends while lanes are still alive (the final-alive arm of
    the status check) is refused too."""
    _force_small_schedule(monkeypatch)
    scene, ndc, org, kw = _setup("cornell_specular")
    pred = wavefront.SegmentPredictor()
    wavefront.render_sample_segmented(scene, ndc, org, 0, W, H, predictor=pred, **kw)
    assert len(pred.plan) > 1
    pred.plan = pred.plan[:1]  # valid caps, but glass paths outlive one segment
    ref = wavefront.render_sample_segmented(scene, ndc, org, 1, W, H, **kw)
    got = wavefront.render_sample_segmented(scene, ndc, org, 1, W, H, predictor=pred, **kw)
    assert pred.overflows == 1, "incomplete frame was not detected"
    _assert_equal(ref, got, "incomplete fallback")


def test_plan_from_counts_margin_and_guard(monkeypatch):
    """Plan construction: the buffer is the smallest menu level holding
    count * margin, the steps those of the unmargined level; monotone; stops
    at the first zero; a guard segment appended."""
    monkeypatch.setattr(wavefront, "_SEG_MARGIN", 1.25)
    caps = [768, 512, 256, 128]
    n = 1024
    plan = wavefront._plan_from_counts([600, 300, 90, 0, 0], n, caps)
    assert tuple(c for c, _ in plan) == (768, 512, 128, 128)
    assert plan[0][1] == wavefront._seg_steps_for(768, n)
    assert plan[1][1] == wavefront._seg_steps_for(512, n)
    assert plan[2][1] == wavefront._seg_steps_for(128, n)
    assert wavefront._plan_from_counts([500], n, caps)[0] == (768, wavefront._seg_steps_for(512, n))
    assert wavefront._plan_from_counts([1000], n, caps)[0][0] == n
    assert wavefront._plan_from_counts([0], n, caps) == ()


def test_plan_margin_is_five_percent():
    """The shipped margin is 1.05 (PT_SEG_MARGIN): a count within 5% of a
    cap takes the next level's buffer, one 5-25% below keeps its own (the
    JAX docstring's "within 25%" is not what its code does)."""
    assert wavefront._SEG_MARGIN == jwf._SEG_MARGIN == 1.05
    caps = [768, 512, 256, 128]
    assert wavefront._plan_from_counts([490], 1024, caps)[0][0] == 768  # 490 * 1.05 > 512
    assert wavefront._plan_from_counts([480], 1024, caps)[0][0] == 512  # 480 * 1.05 <= 512
    assert wavefront._plan_from_counts([420], 1024, caps)[0][0] == 512  # 25% below: no bump


def test_session_uses_predictor(monkeypatch):
    """The session hands its predictor to the segmented entry: frame 1
    seeds the plan, frame 2 runs it without an overflow."""
    _force_small_schedule(monkeypatch)
    sh, cam = scenes.cornell_diffuse(aspect=W / H)
    r = InteractiveRenderer(sh, cam, W, H, max_bounces=8, device="cpu")
    r.frame()
    assert r._predictor.plan is not None, "frame 1 did not seed the plan"
    r.frame()
    assert r._predictor.overflows == 0
    assert np.isfinite(r.display()).all()


# --- the schedule's host logic against the JAX package ---

SIZES = [256, 2048, 4096, 24 * 16, 320 * 180, 1024 * 576, 1920 * 1080, 640 * 360 + 7]


@pytest.mark.parametrize("n", SIZES)
def test_seg_caps_and_steps_match_jax(n):
    caps = wavefront._seg_caps(n)
    assert caps == jwf._seg_caps(n)
    for size in [n, *caps, 2560, 2561, n // 4, n // 4 + 1]:
        assert wavefront._seg_steps_for(size, n) == jwf._seg_steps_for(size, n), (n, size)


def test_seg_caps_at_1024x576():
    assert wavefront._seg_caps(589824) == [221184, 147456, 36864, 9216, 2304, 2048]


COUNT_SEQS = [
    [183000, 140000, 30000, 8000, 2100, 900, 40, 0],
    [589824, 589824, 500000, 0],
    [221184, 221185, 147456, 36865, 9216, 2304, 2048, 1],
    [150000, 36000, 9000, 2200, 2000, 0, 0],
    [0],
    [],
    [5000, 4000],
]


@pytest.mark.parametrize("counts", COUNT_SEQS)
def test_plan_from_counts_matches_jax(counts):
    n = 1024 * 576
    caps = wavefront._seg_caps(n)
    assert wavefront._plan_from_counts(counts, n, caps) == jwf._plan_from_counts(counts, n, caps)
