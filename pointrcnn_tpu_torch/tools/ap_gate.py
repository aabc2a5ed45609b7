"""Detection-quality gate (counterpart of ``tools/ap_gate.py``): train the
two-stage pipeline on the synthetic mini-KITTI fixture through the train
CLI (``python -m pointrcnn_tpu_torch.train``), rpn then rcnn, evaluate the
rcnn checkpoint through the eval CLI's ``eval_ckpt`` (KITTI result files +
the official 11-point AP), and print the metric dict as one JSON line.

    python -m pointrcnn_tpu_torch.tools.ap_gate [--striped] [--people] [--device cpu]

The recipe is ``tests/test_ap_convergence.py``'s: 24 fixture frames, batch
4, 250 rpn and 160 rcnn epochs, ``tests/cfgs_ap.yaml`` (Car) or
``tests/cfgs_ap_people.yaml`` (``--people``: Pedestrian + Cyclist); the
fixture's design is explained in ``tools/ap_gate.py``.  ``--striped``
scales it to 4096 points (``STRIPED_SET``) so the shipping approximations
engage: blockwise FPS in z stripes at RPN SA1 and SA2, the banded ball query
at RPN SA1.  The port trains on one device, so the dict has no
``mesh_devices``; the JSON line adds the kernel launches of the whole run
under ``launches`` (all 0 on the CPU, where the plain versions run).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
AP_CFG = str(REPO / "tests" / "cfgs_ap.yaml")
AP_CFG_PEOPLE = str(REPO / "tests" / "cfgs_ap_people.yaml")
WORK = str(REPO / "pointrcnn_tpu_torch" / "_build" / "ap_gate")

STRIPED_SET = [
    "RPN.NUM_POINTS", "4096",
    "RPN.SA_CONFIG.NPOINTS", "[2048, 512]",
]


def build_fixture(root, num_samples=24, seed=3, n_points=1100,
                  pts_per_obj=300, classes=("Car", "Car")):
    from pointrcnn_tpu_torch.tools.fixture import make_mini_kitti

    make_mini_kitti(
        root, num_samples=num_samples, n_points=n_points, seed=seed,
        z_range=(10.0, 22.0), x_range=(-5.0, 5.0), surface=True,
        pts_per_obj=pts_per_obj, bg_in_frustum=True, project_box2d=True,
        classes=classes,
    )
    return root


def run_gate(work=WORK, rpn_epochs=250, rcnn_epochs=160, num_samples=24,
             batch_size=4, fresh=False, set_cfgs=None, n_points=1100,
             pts_per_obj=300, cfg_file=AP_CFG, classes=("Car", "Car"), device="cuda",
             seed=0):
    """Train rpn -> rcnn on the fixture, joint-eval, return the metric dict
    (recalls + official AP).  ``seed``: the train CLI's ``--seed`` (weights,
    shuffling, augmentation draws)."""
    from pointrcnn_tpu_torch.config import load_config, merge_from_list
    from pointrcnn_tpu_torch.eval.__main__ import eval_ckpt
    from pointrcnn_tpu_torch.train.__main__ import main as train_main

    root = os.path.join(work, "kitti")
    if fresh or not os.path.isdir(root):
        build_fixture(root, num_samples=num_samples, n_points=n_points,
                      pts_per_obj=pts_per_obj, classes=classes)

    extra = list(set_cfgs or [])
    common = ["--cfg_file", cfg_file, "--data_root", root, "--batch_size", str(batch_size),
              "--workers", "1", "--device", device, "--seed", str(seed)]
    rpn_dir = os.path.join(work, "rpn")
    rpn_ckpt = os.path.join(rpn_dir, "ckpt", f"checkpoint_epoch_{rpn_epochs}")
    if not os.path.isfile(rpn_ckpt):
        train_main(common + ["--train_mode", "rpn", "--epochs", str(rpn_epochs),
                             "--ckpt_save_interval", str(rpn_epochs), "--output_dir", rpn_dir]
                   + (["--set"] + extra if extra else []))

    rcnn_dir = os.path.join(work, "rcnn")
    rcnn_ckpt = os.path.join(rcnn_dir, "ckpt", f"checkpoint_epoch_{rcnn_epochs}")
    if not os.path.isfile(rcnn_ckpt):
        train_main(common + ["--train_mode", "rcnn", "--epochs", str(rcnn_epochs),
                             "--ckpt_save_interval", str(rcnn_epochs), "--output_dir", rcnn_dir,
                             "--rpn_ckpt", rpn_ckpt]
                   + (["--set"] + extra if extra else []))

    cfg = load_config(cfg_file, set_cfgs)
    cfg = merge_from_list(cfg, ["RPN.ENABLED", "True", "RCNN.ENABLED", "True"])
    logger = logging.getLogger("ap_gate")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    eargs = argparse.Namespace(
        eval_mode="rcnn", rcnn_eval_roi_dir=None, rcnn_eval_feature_dir=None, rpn_ckpt=None,
        rcnn_ckpt=None, test=False, batch_size=batch_size,
        workers=1, worker_processes=False, data_root=root,
        output_dir=os.path.join(work, "eval"), save_rpn_feature=False, save_result=False,
        device=device,
    )
    ret = eval_ckpt(eargs, cfg, rcnn_ckpt, logger)
    return {k: float(v) for k, v in ret.items()}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--work", type=str, default=WORK)
    p.add_argument("--rpn_epochs", type=int, default=250)
    p.add_argument("--rcnn_epochs", type=int, default=160)
    p.add_argument("--num_samples", type=int, default=24)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--seed", type=int, default=0, help="the train CLI's --seed")
    p.add_argument("--fresh", action="store_true", help="rebuild the fixture")
    p.add_argument("--striped", action="store_true",
                   help="scale to the striped regime (4096 points) so the shipping "
                        "approximations engage")
    p.add_argument("--people", action="store_true",
                   help="multi-class gate: Pedestrian+Cyclist fixture through "
                        "cfgs_ap_people.yaml (3-class head, per-class anchors, "
                        "per-class AP)")
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = p.parse_args(argv)

    set_cfgs = list(args.set_cfgs or [])
    n_points, pts_per_obj = 1100, 300
    if args.striped:
        set_cfgs = STRIPED_SET + set_cfgs
        n_points, pts_per_obj = 4400, 1200
    cfg_file, classes = AP_CFG, ("Car", "Car")
    if args.people:
        cfg_file, classes = AP_CFG_PEOPLE, ("Pedestrian", "Cyclist")
    from pointrcnn_tpu_torch.ops import counts

    before = counts.read()
    ret = run_gate(args.work, args.rpn_epochs, args.rcnn_epochs, args.num_samples,
                   args.batch_size, fresh=args.fresh, set_cfgs=set_cfgs, n_points=n_points,
                   pts_per_obj=pts_per_obj, cfg_file=cfg_file, classes=classes,
                   device=args.device, seed=args.seed)
    launches = {k: v - before[k] for k, v in counts.read().items()}
    print(json.dumps({**ret, "launches": launches}), flush=True)
    return ret


if __name__ == "__main__":
    main(sys.argv[1:])
