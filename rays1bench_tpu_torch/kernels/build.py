"""Build the port's CUDA kernels with nvcc at first use and load them with
ctypes.

Each library is compiled from sources under kernels/csrc/ into
<checkout>/build/rays1bench_tpu_torch/ (git-ignored) with a plain C
interface, and cached under a hash of every csrc file and the flags, so an
edit or a flag change rebuilds and an unchanged tree loads at once. Nothing
here includes PyTorch's headers: such a build takes seconds, not minutes.

Flags: sm_90a (Hopper), and --fmad=false so no multiply-add is contracted:
the kernels then compute exactly what the plain torch ops compute. No
--use_fast_math: the sweep's miss test relies on sqrtf(negative) = NaN and on
every NaN comparison being false, and IEEE division and square root keep the
kernel equal to its plain version.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "rays1bench_tpu_torch"

# (library name, source under csrc/) of every kernel of the port.
KERNELS = (("respawn", "respawn.cu"), ("oneshot", "oneshot.cu"),
           ("mega_backward", "mega_backward.cu"))

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels are built at first use")
    return nvcc


def library_path(name: str, source: str) -> pathlib.Path:
    """Where the library built from csrc/<source> lives, keyed by content."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(source.encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, source: str) -> pathlib.Path:
    """Compile csrc/<source> into a shared library unless the cached one is
    current. Writes the compiler's output (ptxas register and spill report)
    beside it as <library>.log. Raises if nvcc fails."""
    out = library_path(name, source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                               str(CSRC / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} (exit "
                               f"{proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(kernels=KERNELS) -> list:
    """Build the given (name, source) libraries at once, one nvcc each, all
    started together; returns their paths in order."""
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        return list(pool.map(lambda k: build(*k), kernels))


@functools.cache
def load(name: str, source: str) -> ctypes.CDLL:
    """Build if needed, then load the library (once per process)."""
    return ctypes.CDLL(str(build(name, source)))
