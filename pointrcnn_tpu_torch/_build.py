"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` into ``_build/<name>-<hash>.so``; the hash covers the source, every
header of ``csrc/`` (``*.cuh``, which the sources include by relative path)
and the flags, so an edited source or header is rebuilt and a stale library
never loads.
No PyTorch headers are included, which keeps a build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

_PKG = pathlib.Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
# geometry kernels must not contract dx*dx + dy*dy into FMAs: that changes
# squared distances in the last bit and breaks decision-exactness
NO_FMAD = ("--fmad=false",)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.environ.get("CUDA_HOME"):
        cand = pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME; the CUDA kernels "
            "of pointrcnn_tpu_torch cannot be built")
    return nvcc


def sources(name: str) -> list[pathlib.Path]:
    """``csrc/<name>.cu`` and the headers it may include."""
    return [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]


def library_path(name: str, flags: tuple[str, ...]) -> pathlib.Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update(" ".join(ARCH_FLAGS + BASE_FLAGS + flags).encode())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name in _loaded:
        return _loaded[name]
    so = library_path(name, flags)
    if not so.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        # compile to a private name, then rename: a concurrent or interrupted
        # build never leaves a truncated library under the final name
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        cmd = [find_nvcc(), *ARCH_FLAGS, *BASE_FLAGS, *flags,
               "-o", tmp, str(_CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed for {name}.cu (rc={proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
