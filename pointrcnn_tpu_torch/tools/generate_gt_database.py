"""GT-database generation CLI (counterpart of ``tools/generate_gt_database.py``;
reference tools/generate_gt_database.py):

    python -m pointrcnn_tpu_torch.tools.generate_gt_database --data_root data \\
        [--save_dir data/gt_database] [--class_name Car] [--split train]

Writes ``<save_dir>/<split>_gt_database_level_<class_name>.pkl``, the
records the train CLI pastes with ``GT_AUG_ENABLED``.
"""

from __future__ import annotations

import argparse
import os
import sys

from pointrcnn_tpu_torch.data.gt_database import GTDatabaseGenerator


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--save_dir", type=str, default="data/gt_database")
    p.add_argument("--class_name", type=str, default="Car")
    p.add_argument("--split", type=str, default="train")
    return p.parse_args(argv)


def main(argv=None) -> str:
    """-> the path of the written database."""
    args = parse_args(argv)
    gen = GTDatabaseGenerator(args.data_root, split=args.split, classes=args.class_name)
    db = gen.generate_gt_database()
    path = os.path.join(
        args.save_dir, f"{args.split}_gt_database_level_{args.class_name}.pkl"
    )
    gen.save(path)
    print(f"saved {len(db)} objects to {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
