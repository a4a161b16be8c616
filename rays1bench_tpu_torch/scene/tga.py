"""Uncompressed 24-bit true-color TGA I/O, byte-compatible with the
reference's writer (reference: src/common/common.h:80-122) and with
rays1bench_tpu/scene/tga.py. Rows are stored bottom-up, which is the
renderer's own row-0-at-bottom layout, so arrays pass through unflipped."""

from __future__ import annotations

import struct

import numpy as np

_HEADER_FMT = "<BBBHHBHHHHBB"


def write_rgb24(path: str, image_u8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB array (row 0 = bottom) as 24-bit TGA."""
    image_u8 = np.asarray(image_u8)
    if image_u8.dtype != np.uint8 or image_u8.ndim != 3 or image_u8.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {image_u8.dtype} "
                         f"{image_u8.shape}")
    h, w, _ = image_u8.shape
    header = struct.pack(_HEADER_FMT, 0, 0, 2, 0, 0, 0, 0, 0, w, h, 24, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(image_u8[:, :, ::-1]).tobytes())  # BGR


def read_rgb24(path: str) -> np.ndarray:
    """Read an uncompressed 24-bit TGA into (H, W, 3) uint8 RGB, row 0 = bottom."""
    with open(path, "rb") as f:
        raw = f.read()
    (id_len, cmap_type, img_type, _cm_first, _cm_len, _cm_bits,
     _xo, _yo, w, h, bpp, desc) = struct.unpack(_HEADER_FMT, raw[:18])
    if img_type != 2 or bpp != 24 or cmap_type != 0:
        raise ValueError(f"unsupported TGA: type={img_type} bpp={bpp}")
    off = 18 + id_len
    rgb = np.frombuffer(raw[off:off + w * h * 3], dtype=np.uint8).reshape(
        h, w, 3)[:, :, ::-1]
    if desc & 0x20:  # y-origin top: flip to the bottom-up convention
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)
