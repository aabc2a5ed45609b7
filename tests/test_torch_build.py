"""The kernel libraries' cache key (``pointrcnn_tpu_torch._build``): an
edited source or header of ``csrc/`` must give a new library path, so a
stale library never loads.  Runs without ``nvcc``: it only computes paths."""

from __future__ import annotations

import re
import shutil

import pytest

from pointrcnn_tpu_torch import _build
from test_torch_port_slice import one_torch_thread  # noqa: F401 (fixture)

NAMES = ("fps", "knn", "gather", "mlp", "ballquery")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that the builder reads instead of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, copy)
    monkeypatch.setattr(_build, "_CSRC", copy)
    monkeypatch.setattr(_build, "_BUILD", tmp_path / "_build")
    return copy


@pytest.mark.parametrize("name", NAMES)
def test_sources_cover_every_quoted_include(name):
    """Each header a source includes by relative path (and the headers
    those include) is hashed into its library's path."""
    listed = {p.name for p in _build.sources(name)}
    todo, seen = [f"{name}.cu"], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        todo += re.findall(r'^#include "([^"]+)"', (_build._CSRC / f).read_text(), re.M)
    assert seen <= listed, f"{name}.cu includes {sorted(seen - listed)} outside the hash"


@pytest.mark.parametrize("header", ("wgmma.cuh", "scatter.cuh"))
def test_editing_a_header_changes_the_library_paths(csrc, header):
    before = {n: _build.library_path(n, _build.NO_FMAD) for n in NAMES}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n, _build.NO_FMAD) for n in NAMES}
    for n in NAMES:
        if header in (csrc / f"{n}.cu").read_text():
            assert after[n] != before[n], f"{n}.cu includes {header}: its path must change"
    assert after["mlp"] != before["mlp"]


def test_editing_a_source_changes_only_its_library_path(csrc):
    before = {n: _build.library_path(n, _build.NO_FMAD) for n in NAMES}
    with open(csrc / "mlp.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n, _build.NO_FMAD) for n in NAMES}
    assert after["mlp"] != before["mlp"]
    assert all(after[n] == before[n] for n in NAMES if n != "mlp")


def test_flags_change_the_library_path(csrc):
    assert _build.library_path("mlp", ()) != _build.library_path("mlp", _build.NO_FMAD)
    assert _build.library_path("mlp", _build.NO_FMAD) == _build.library_path("mlp", _build.NO_FMAD)
