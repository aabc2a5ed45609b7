"""Per-run source snapshotting for reproducibility.

Mirrors the reference's ``backup_files`` convention (train_rcnn.py:184-188,
eval_rcnn.py:754-759): every train/eval run copies the framework's sources
into ``<run_dir>/backup_files/`` so results can be diffed against the exact
code that produced them.  The port's command-line entry points live in its
own package, so the package is the whole snapshot: its Python sources and
the kernel and host-op sources of ``csrc/``.
"""

from __future__ import annotations

import os
import pathlib
import shutil

_PKG_ROOT = pathlib.Path(__file__).resolve().parents[1]
_PATTERNS = ("*.py", "csrc/*.cu", "csrc/*.cuh", "csrc/*.cpp")


def backup_source(run_dir: str | os.PathLike, logger=None) -> str:
    """Copy the package's sources into ``run_dir/backup_files``."""
    dst_root = pathlib.Path(run_dir) / "backup_files"
    # _build/ holds built libraries and scratch runs, not sources
    srcs = sorted({p for pat in _PATTERNS for p in _PKG_ROOT.rglob(pat)
                   if p.relative_to(_PKG_ROOT).parts[0] != "_build"})
    for src in srcs:
        dst = dst_root / _PKG_ROOT.name / src.relative_to(_PKG_ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy2(src, dst)
    if logger is not None:
        logger.info("backed up %d source files to %s", len(srcs), dst_root)
    return str(dst_root)
