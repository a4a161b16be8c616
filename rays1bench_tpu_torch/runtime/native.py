"""ctypes bindings for the native host runtime (native/imageio.cpp;
rays1bench_tpu/runtime/native.py).

The device computes linear radiance; these are the host-side finishing
ops, in C++: tonemap and quantize (rayweek1.cpp:765-775), the mean of
per-shard buffers (:809-813), TGA encode and decode (common.h:80-122).

Each op has a plain twin in numpy (or scene/tga.py) that gives the same
bytes, and the tests hold the library against it. Where the library
cannot be built or loaded (no g++), every op runs its twin instead, as the
JAX package's loader does, but not quietly: available() is False,
status() says why, and the benchmark CLI prints status() beside the card.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List

import numpy as np

from rays1bench_tpu_torch.runtime.build import build
from rays1bench_tpu_torch.scene import tga

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


@functools.cache
def _library():
    """(the loaded library, None), or (None, why it is not available)."""
    try:
        path = build()
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:
        return None, f"{type(e).__name__}: {e}"
    lib.rt_tonemap_u8.argtypes = [_f32p, _u8p, ctypes.c_int64]
    lib.rt_tonemap_u8.restype = None
    lib.rt_accumulate_mean.argtypes = [ctypes.POINTER(_f32p), ctypes.c_int,
                                       _f32p, ctypes.c_int64]
    lib.rt_accumulate_mean.restype = None
    lib.rt_tga_write_rgb24.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                       ctypes.c_int, _u8p]
    lib.rt_tga_write_rgb24.restype = ctypes.c_int
    lib.rt_tga_probe.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.rt_tga_probe.restype = ctypes.c_int
    lib.rt_tga_read_rgb24.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int,
                                      ctypes.c_int]
    lib.rt_tga_read_rgb24.restype = ctypes.c_int
    return lib, str(path)


def available() -> bool:
    """Whether the C++ library was built and loaded."""
    return _library()[0] is not None


def status() -> str:
    """One line: the library's path, or why the numpy twins run instead."""
    lib, what = _library()
    return f"built, {what}" if lib is not None else \
        f"unavailable, numpy twins run instead ({what})"


def tonemap_u8_reference(linear: np.ndarray) -> np.ndarray:
    """The plain twin of tonemap_u8, equal byte for byte: clamp to [0, 1],
    float32 sqrt (correctly rounded in both), times float32 255.99,
    truncated."""
    g = np.sqrt(np.clip(np.asarray(linear, dtype=np.float32), 0.0, 1.0))
    return (g * np.float32(255.99)).astype(np.uint8)


def tonemap_u8(linear: np.ndarray) -> np.ndarray:
    """clamp -> sqrt gamma -> *255.99 quantize, elementwise (reference
    rayweek1.cpp:765-775)."""
    lib = _library()[0]
    if lib is None:
        return tonemap_u8_reference(linear)
    linear = np.ascontiguousarray(linear, dtype=np.float32)
    out = np.empty(linear.shape, np.uint8)
    lib.rt_tonemap_u8(linear.ctypes.data_as(_f32p),
                      out.ctypes.data_as(_u8p), linear.size)
    return out


def _same_shape(shards):
    shards = [np.ascontiguousarray(s, dtype=np.float32) for s in shards]
    if not shards or any(s.shape != shards[0].shape for s in shards):
        raise ValueError(f"accumulate_mean takes one or more buffers of one "
                         f"shape, got {[s.shape for s in shards]}")
    return shards


def accumulate_mean_reference(shards: List[np.ndarray]) -> np.ndarray:
    """The plain twin of accumulate_mean, equal bit for bit: float32 sums
    in shard order, times the float32 1 / count. (The JAX package's
    fallback, np.mean, divides instead, and differs in the last bit.)"""
    shards = _same_shape(shards)
    acc = shards[0].copy()
    for s in shards[1:]:
        acc += s
    return acc * (np.float32(1.0) / np.float32(len(shards)))


def accumulate_mean(shards: List[np.ndarray]) -> np.ndarray:
    """Mean of per-shard radiance buffers (host-side shard assembly)."""
    lib = _library()[0]
    if lib is None:
        return accumulate_mean_reference(shards)
    shards = _same_shape(shards)
    out = np.empty(shards[0].shape, np.float32)
    ptrs = (_f32p * len(shards))(*[s.ctypes.data_as(_f32p) for s in shards])
    lib.rt_accumulate_mean(ptrs, len(shards), out.ctypes.data_as(_f32p),
                           out.size)
    return out


def tga_write_rgb24(path: str, image_u8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB (row 0 = bottom) as uncompressed 24-bit
    TGA, byte for byte scene/tga.write_rgb24's file (common.h:86-122)."""
    image_u8 = np.ascontiguousarray(image_u8)
    if (image_u8.dtype != np.uint8 or image_u8.ndim != 3
            or image_u8.shape[2] != 3 or max(image_u8.shape[:2]) > 0xFFFF):
        raise ValueError(f"expected (H, W, 3) uint8 under 65,536 pixels a "
                         f"side, got {image_u8.dtype} {image_u8.shape}")
    lib = _library()[0]
    if lib is None:
        return tga.write_rgb24(path, image_u8)
    h, w, _ = image_u8.shape
    rc = lib.rt_tga_write_rgb24(str(path).encode(), w, h,
                                image_u8.ctypes.data_as(_u8p))
    if rc != 0:
        raise IOError(f"rt_tga_write_rgb24 failed ({rc}) for {path}")


def tga_read_rgb24(path: str) -> np.ndarray:
    """Read an uncompressed 24-bit TGA into (H, W, 3) uint8 RGB, row 0 =
    bottom, as scene/tga.read_rgb24 does."""
    lib = _library()[0]
    if lib is None:
        return tga.read_rgb24(path)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.rt_tga_probe(str(path).encode(), ctypes.byref(w),
                          ctypes.byref(h))
    if rc != 0:
        raise IOError(f"rt_tga_probe failed ({rc}) for {path}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.rt_tga_read_rgb24(str(path).encode(), out.ctypes.data_as(_u8p),
                               w.value, h.value)
    if rc != 0:
        raise IOError(f"rt_tga_read_rgb24 failed ({rc}) for {path}")
    return out
