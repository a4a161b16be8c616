"""Build the native runtime library (rays1bench_tpu/runtime/build.py).

    python -m rays1bench_tpu_torch.runtime.build [--force]

Compiles native/imageio.cpp with g++ into <checkout>/build/
rays1bench_tpu_torch/runtime/ (git-ignored), never into the source tree,
named by a hash of the source and the flags, so an edit rebuilds and an
unchanged tree loads at once. runtime.native calls build() at first use.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile

SRC = pathlib.Path(__file__).resolve().parent / "native" / "imageio.cpp"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "rays1bench_tpu_torch" / "runtime")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> pathlib.Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libraysrt-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> pathlib.Path:
    """Compile the library unless the current one exists; returns its path.
    Raises RuntimeError if g++ is missing or fails."""
    out = library_path()
    if out.exists() and not force:
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native runtime is "
                           "built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


if __name__ == "__main__":
    print(f"built {build(force='--force' in sys.argv)}")
