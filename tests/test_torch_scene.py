"""Parity of rays1bench_tpu_torch.scene with rays1bench_tpu.scene on the CPU:
the same scenes column for column, the same derived view, the same TGA
bytes, and the numpy bridge (scene/convert.py) that carries the JAX
package's state across."""

import dataclasses

import numpy as np
import pytest
import torch

from rays1bench_tpu.scene import builders as jbuilders
from rays1bench_tpu.scene import crt_colors as jcrt
from rays1bench_tpu.scene import spheres as jspheres
from rays1bench_tpu.scene import tga as jtga
from rays1bench_tpu_torch.scene import builders as tbuilders
from rays1bench_tpu_torch.scene import convert
from rays1bench_tpu_torch.scene import crt_colors as tcrt
from rays1bench_tpu_torch.scene import spheres as tspheres
from rays1bench_tpu_torch.scene import tga as ttga
from rays1bench_tpu_torch.scene.soa_spheres import COLUMNS

torch.set_num_threads(1)

SCENES = ["small", "medium", "large", "giant"]
ASPECT = 1280 / 720


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def jax_leaves(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


def test_crt_color_table_is_a_copy():
    assert tcrt.CRT_COLOR_BYTES == jcrt.CRT_COLOR_BYTES


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("pad_multiple", [128, 8])
def test_builder_columns_bit_exact(name, pad_multiple):
    j = jbuilders.SCENES[name](ASPECT, pad_multiple=pad_multiple)
    t = tbuilders.SCENES[name](ASPECT, pad_multiple=pad_multiple,
                               device="cpu")
    assert t.name == j.name and t.n_real == j.n_real
    assert dataclasses.astuple(t.camera) == dataclasses.astuple(j.camera)
    for c in COLUMNS:
        assert same_bits(getattr(t.spheres, c).numpy(),
                         getattr(j.spheres, c)), c


@pytest.mark.parametrize("name", SCENES)
def test_prepare_bit_exact(name):
    j = jspheres.prepare(jbuilders.SCENES[name](ASPECT).spheres)
    t = tspheres.prepare(tbuilders.SCENES[name](ASPECT, device="cpu").spheres)
    for f in dataclasses.fields(j):
        assert same_bits(getattr(t, f.name).numpy(), getattr(j, f.name)), f.name


def test_hollow_glass_keeps_signed_inv_radius():
    t = tspheres.prepare(
        tbuilders.create_small_scene(ASPECT, device="cpu").spheres)
    assert t.inv_radius[4] < 0 and t.radius_sq[4] > 0
    assert (t.valid[5:] == 0).all() and (t.inv_radius[5:] == 0).all()


@pytest.mark.parametrize("name", SCENES)
def test_camera_build_bit_exact(name):
    spec = jbuilders.SCENES[name](ASPECT).camera
    j = spec.build()
    t = tbuilders.SCENES[name](ASPECT, device="cpu").camera.build("cpu")
    for f in dataclasses.fields(j):
        assert same_bits(getattr(t, f.name).numpy(), getattr(j, f.name)), f.name


def test_tga_bytes_match(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    jtga.write_rgb24(str(tmp_path / "j.tga"), img)
    ttga.write_rgb24(str(tmp_path / "t.tga"), img)
    assert (tmp_path / "j.tga").read_bytes() == (tmp_path / "t.tga").read_bytes()
    assert np.array_equal(ttga.read_rgb24(str(tmp_path / "t.tga")), img)
    with pytest.raises(ValueError):
        ttga.write_rgb24(str(tmp_path / "bad.tga"), img.astype(np.int32))


def test_tga_reads_golden_like_jax(golden_dir):
    path = str(golden_dir / "latest_quick_large.tga")
    assert np.array_equal(ttga.read_rgb24(path), jtga.read_rgb24(path))


@pytest.mark.parametrize("name", ["small", "large"])
def test_convert_round_trips(name):
    j = jbuilders.SCENES[name](ASPECT)
    t = tbuilders.SCENES[name](ASPECT, device="cpu")
    soa = convert.soa_from_numpy(jax_leaves(j.spheres, COLUMNS), "cpu")
    for c in COLUMNS:
        assert same_bits(getattr(soa, c).numpy(), getattr(t.spheres, c).numpy())
    jcam = j.camera.build()
    cam = convert.camera_from_numpy(jax_leaves(jcam, convert.CAMERA_FIELDS),
                                    "cpu")
    tcam = t.camera.build("cpu")
    for f in convert.CAMERA_FIELDS:
        assert same_bits(getattr(cam, f).numpy(), getattr(tcam, f).numpy())
        assert same_bits(getattr(cam, f).numpy(), getattr(jcam, f))
    # and back: numpy -> torch -> numpy keeps the bits
    back = {c: getattr(soa, c).numpy() for c in COLUMNS}
    assert all(same_bits(back[c], getattr(j.spheres, c)) for c in COLUMNS)


def test_convert_rejects_wrong_dtype():
    cols = {c: np.zeros(8, np.float32) for c in COLUMNS}
    cols["mat_type"] = np.zeros(8, np.int32)
    convert.soa_from_numpy(cols, "cpu")
    cols["radius"] = np.zeros(8, np.float64)
    with pytest.raises(ValueError):
        convert.soa_from_numpy(cols, "cpu")
