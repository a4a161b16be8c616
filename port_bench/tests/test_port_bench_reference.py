"""The plain reference against itself at 32x16 on the CPU: any subset of
rays, in any chunking, traces as the whole frame does; the bfloat16
control departs from it; the fit's reference is deterministic and its
first step moves every albedo by lr where its gradient is
above rounding, and no placeholder row."""

import numpy as np
import pytest
import torch

from port_bench.loops import common
from port_bench.reference import fit, render, scenes

W, H, SPP, MB, SEED = 32, 16, 3, 6, 1234567
COLS, N_REAL = scenes.large_scene(128)


def whole(respawn=False, dtype=torch.float32):
    return render.render_pixels(COLS, scenes.CAMERA, np.arange(W * H), W, H,
                                SPP, SEED, MB, "cpu", dtype, respawn)


def test_scene_is_the_reference_scene():
    assert N_REAL == 484 and len(COLS["radius"]) == 512
    assert int((COLS["mat_type"][:N_REAL] == scenes.DIELECTRIC).sum()) == 25
    assert float(COLS["radius"][N_REAL:].max()) == 0.0


def test_subset_and_chunks_trace_as_the_whole_frame():
    img, cnt = whole()
    pixels = np.array([3, 100, 257, 511])
    sub, sub_cnt = render.render_pixels(COLS, scenes.CAMERA, pixels, W, H,
                                        SPP, SEED, MB, "cpu")
    assert torch.equal(sub, img[pixels])
    assert torch.equal(sub_cnt, cnt[pixels])
    tab = render.table(COLS, "cpu", torch.float32)
    cam = render.camera(scenes.CAMERA, W / H, "cpu", torch.float32)
    ids = torch.arange(W * H * SPP)
    a = render.trace_rays(tab, cam, ids, W, H, SPP, SEED, MB)
    b = render.trace_rays(tab, cam, ids, W, H, SPP, SEED, MB, chunk=97)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(cnt.sum()) == int(a[1].sum()) > W * H * SPP


def test_sample_order_sum_is_close_to_the_mean():
    a, _ = whole(respawn=True)
    b, _ = whole(respawn=False)
    assert float((a - b).abs().max()) < 1e-6


def test_seeds_change_the_image_not_the_size():
    img, cnt = whole()
    other, other_cnt = render.render_pixels(COLS, scenes.CAMERA,
                                            np.arange(W * H), W, H, SPP,
                                            SEED + 1, MB, "cpu")
    assert not torch.equal(img, other)
    assert abs(int(cnt.sum()) - int(other_cnt.sum())) < 0.2 * int(cnt.sum())


def test_bfloat16_control_departs():
    img, cnt = whole()
    low, _ = whole(dtype=torch.bfloat16)
    assert float((low - img).abs().max()) > 0.1


def test_record_gives_back_the_radiance():
    tab = render.table(COLS, "cpu", torch.float32)
    cam = render.camera(scenes.CAMERA, W / H, "cpu", torch.float32)
    ids = torch.arange(W * H * SPP)
    rad, _, rows, sky = render.trace_rays(tab, cam, ids, W, H, SPP, SEED, MB,
                                          record=True)
    alb = torch.stack([tab["ar"], tab["ag"], tab["ab"]])
    ext = torch.cat([alb, torch.ones(3, 1)], dim=1)
    att = torch.ones(3, ids.shape[0])
    for b in range(MB + 1):
        att = att * ext[:, rows[b]]
    assert torch.equal(att.t() * sky, rad)


def test_fit_reference_is_deterministic_and_moves_by_lr():
    rng = np.random.default_rng(3)
    true = np.stack([COLS[k] for k in fit.LEAVES])
    fac = (0.6 + 0.9 * rng.random(true.shape)).astype(np.float32)
    fac[:, N_REAL:] = 1
    start = np.clip(true * fac, 0, 1).astype(np.float32)
    args = (COLS, true, start, scenes.CAMERA, W, H, 2, SEED, 4, 1e-2, 1)
    a, b = fit.fit_reference(*args), fit.fit_reference(*args)
    assert a["losses"] == b["losses"] and a["losses"][0] > 0
    for k in fit.LEAVES:
        step = (a["params"][k] - a["start"][k]).abs()
        moved = a["grad1"][k].abs() > 1e-4
        assert torch.allclose(step[moved], torch.full_like(step[moved], 1e-2),
                              rtol=1e-3)
        zero = a["grad1"][k] == 0
        assert zero[N_REAL:].all() and float(step[zero].max()) == 0.0


def test_check_pixels_one_per_tile():
    rng = np.random.default_rng(9)
    px = common.check_pixels(32, 16, (8, 4), rng)
    assert len(px) == 16 and len(set(px.tolist())) == 16
    x, y = px % 32, px // 32
    assert sorted(set(zip((x // 8).tolist(), (y // 4).tolist()))) == sorted(
        (i, j) for i in range(4) for j in range(4))
    with pytest.raises(ValueError):
        common.check_pixels(30, 16, (8, 4), rng)


def test_sampled_paths_cover_every_pixel_and_estimate_the_count():
    rng = np.random.default_rng(5)
    ids = common.count_paths(W, H, 4, 2, rng)
    pixel, sample = ids // 4, ids % 4
    assert np.array_equal(pixel, np.repeat(np.arange(W * H), 2))
    assert np.all(sample[0::2] < 2) and np.all(sample[1::2] >= 2)
    r = {"width": W, "height": H, "spp": 4, "max_bounces": MB}
    _, cnt = render.render_pixels(COLS, scenes.CAMERA, np.arange(W * H), W,
                                  H, 4, SEED, MB, "cpu")
    whole_count = int(cnt.sum())
    est = common.estimate_rays(COLS, scenes.CAMERA, ids, r, SEED, "cpu")
    assert abs(est - whole_count) / whole_count < 0.05
    every = common.count_paths(W, H, 4, 4, rng)
    assert np.array_equal(np.sort(every), np.arange(W * H * 4))
    assert common.estimate_rays(COLS, scenes.CAMERA, every, r, SEED,
                                "cpu") == whole_count
    with pytest.raises(ValueError):
        common.count_paths(W, H, 4, 3, rng)
