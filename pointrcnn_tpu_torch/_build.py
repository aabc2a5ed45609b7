"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with
``nvcc`` into ``_build/<name>-<hash>.so``; the hash covers the source, every
header of ``csrc/`` (``*.cuh``, which the sources include by relative path)
and the flags, so an edited source or header is rebuilt and a stale library
never loads.
No PyTorch headers are included, which keeps a build to seconds.

Every C entry point that Python calls is bound here: :class:`Entry` (a
library, a symbol and its ctypes signature, set once at the first call and
kept: a launch's host time counts on the host-paced paths), and
:func:`launch`, the one way a counted kernel is launched (its span, its
return code checked, its count in ``ops/counts.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.ops import counts

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


class Entry:
    """The C function ``symbol`` of ``csrc/<lib>.cu`` with its ctypes
    signature (``argtypes``, ``restype``): the library is built, loaded and
    the signature set at the first call, then the function is kept."""

    __slots__ = ("lib", "symbol", "argtypes", "restype", "_fn")

    def __init__(self, lib: str, symbol: str, argtypes, restype=ctypes.c_int):
        self.lib, self.symbol = lib, symbol
        self.argtypes, self.restype = argtypes, restype
        self._fn = None

    def __call__(self, *args):
        fn = self._fn
        if fn is None:
            # every kernel library is built without FMA contraction
            fn = self._fn = bind(load(self.lib, NO_FMAD), self.symbol, self.argtypes,
                                 self.restype)
        return fn(*args)


def bind(lib: ctypes.CDLL, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of a loaded library with its signature set."""
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


def launch(name: str, entry: Entry, t: torch.Tensor, *args) -> None:
    """One launch of kernel ``name`` (its key in ``ops/counts.py``):
    ``entry(*args, stream)`` on the current stream of ``t``'s device under
    the span ``name``, its return code checked, then one added to its
    count."""
    stream = torch.cuda.current_stream(t.device).cuda_stream
    with trace.span(name):
        err = entry(*args, stream)
    check(err, entry.symbol)
    counts.add(name)
