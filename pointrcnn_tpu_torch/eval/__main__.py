"""Evaluation CLI (counterpart of ``tools/eval.py``; reference
tools/eval_rcnn.py), on the card unless ``--device`` says otherwise:

    python -m pointrcnn_tpu_torch.eval --eval_mode rcnn --ckpt .../checkpoint_epoch_N \\
        --data_root data [--device cpu]

Modes:
  rpn   — RPN-only eval: proposal recall, seg IoU, optional feature dump
          (--save_rpn_feature) for the offline RCNN stage interface
  rcnn  — full two-stage eval: recall, KITTI result files, official AP
  rcnn_offline — the RCNN alone over the proposals and features that an
          rpn eval with --save_rpn_feature wrote (--rcnn_eval_roi_dir,
          --rcnn_eval_feature_dir): recall, KITTI result files, official AP

Data parallel: under torchrun (``torchrun --nproc_per_node N -m
pointrcnn_tpu_torch.eval ...``) every rank loads the same batches and runs
the step on its slice of each (``--batch_size`` is the global batch; the
slices of a last batch that the world does not divide differ by a frame);
rank 0 gathers the outputs, writes the log and the KITTI files and
computes recall, seg IoU and AP, which every rank returns.  The files and
results equal one device's.

--eval_all evaluates every checkpoint in the ckpt dir (reference
repeat_eval_ckpt / eval_all, eval_rcnn.py:729-841); each checkpoint's
scalars go to the log and, one JSON line an epoch, to
``<log_dir>/eval_all_<split>.jsonl`` (no tensorboard writer).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
from pointrcnn_tpu_torch.parallel import mesh


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PointRCNN evaluator (PyTorch + CUDA)")
    p.add_argument("--cfg_file", type=str, default="cfgs/default.yaml")
    p.add_argument("--eval_mode", type=str, required=True,
                   choices=["rpn", "rcnn", "rcnn_offline"])
    p.add_argument("--rcnn_eval_roi_dir", type=str, default=None)
    p.add_argument("--rcnn_eval_feature_dir", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--rpn_ckpt", type=str, default=None,
                   help="restore only the RPN subtree from this checkpoint "
                        "(reference eval_rcnn.py:35 + load_ckpt_based_on_args "
                        "eval_rcnn.py:698-726: full --ckpt first, then stage "
                        "subtrees override)")
    p.add_argument("--rcnn_ckpt", type=str, default=None,
                   help="restore only the RCNN subtree from this checkpoint")
    p.add_argument("--eval_all", action="store_true")
    p.add_argument("--extra_tag", type=str, default="default",
                   help="extra tag appended to the output dir for multiple "
                        "evaluations of one config (reference eval_rcnn.py:40,"
                        "738-739)")
    p.add_argument("--ckpt_dir", type=str, default=None,
                   help="checkpoint directory for --eval_all (reference "
                        "eval_rcnn.py:42; defaults to --ckpt)")
    # --random_select exists in the reference CLI (eval_rcnn.py:48) but is
    # action='store_true' with default=True — it can never be disabled from
    # the command line, so the fixed-shape eval path here matches exactly
    p.add_argument("--start_epoch", type=int, default=0,
                   help="with --eval_all: skip checkpoints whose epoch is "
                        "below this (reference eval_rcnn.py:49, 795)")
    p.add_argument("--wait", action="store_true",
                   help="with --eval_all: keep polling the ckpt dir for new "
                        "checkpoints (reference repeat_eval_ckpt, eval_rcnn.py:784-841)")
    p.add_argument("--test", action="store_true", help="test split (no labels)")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--workers", type=int, default=None,
                   help="loader workers (default: min(8, cpu_count))")
    p.add_argument("--worker_processes", action="store_true",
                   help="fork process-pool workers instead of threads "
                        "(the reference DataLoader shape; for multi-core hosts)")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--save_rpn_feature", action="store_true")
    p.add_argument("--save_result", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the eval step (under "
                        "torchrun: cuda is cuda:<LOCAL_RANK>)")
    p.add_argument("--dist_backend", type=str, default=None,
                   help="torch.distributed backend under torchrun (default: nccl "
                        "on cuda, gloo on cpu)")
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


AP_CLASSES = {  # cfg.CLASSES -> kitti_eval class indices
    "Car": (0,), "Pedestrian": (1,), "Cyclist": (2,), "People": (1, 2),
}


def create_logger(log_file, name):
    """A logger to ``log_file`` and the console; under data parallel on rank
    0 alone (the other ranks' logger drops every record)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    logger.propagate = False
    if mesh.rank() != 0:
        logger.addHandler(logging.NullHandler())
        return logger
    os.makedirs(os.path.dirname(log_file), exist_ok=True)
    fmt = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def restore(args, model, ckpt_path, logger) -> int:
    """Load the weights in the reference's order (load_ckpt_based_on_args,
    eval_rcnn.py:698-726): the full ``ckpt_path`` first, then the RPN and
    RCNN subtrees from ``--rpn_ckpt`` / ``--rcnn_ckpt`` -> the epoch."""
    from pointrcnn_tpu_torch.train.checkpoint import (
        epoch_from_path,
        load_checkpoint,
        load_params_partial,
    )
    from pointrcnn_tpu_torch.train.state import TrainState

    epoch = 0
    if ckpt_path is not None:
        _, epoch, _ = load_checkpoint(ckpt_path, TrainState(step=0, model=model, opt_state={}))
    if args.rpn_ckpt is not None:
        logger.info("==> loading RPN subtree from %s", args.rpn_ckpt)
        load_params_partial(args.rpn_ckpt, model, ("rpn",))
        epoch = epoch_from_path(args.rpn_ckpt) or epoch
    if args.rcnn_ckpt is not None:
        logger.info("==> loading RCNN subtree from %s", args.rcnn_ckpt)
        load_params_partial(args.rcnn_ckpt, model, ("rcnn_net",))
        epoch = epoch_from_path(args.rcnn_ckpt) or epoch
    return epoch


class ProposalDataset(KittiRCNNDataset):
    """The offline eval's dataset: a frame's saved proposals without their
    scores.  Frames hold different counts of proposals; ``collate_batch``
    pads the boxes (``roi_valid``) but stacks the scores as they are, which
    fails on the first batch whose frames differ, and no step reads them
    (``tools/eval.py`` stops there: ROADMAP C20)."""

    def get_proposal_from_file(self, index: int) -> dict:
        info = super().get_proposal_from_file(index)
        del info["roi_scores"]
        return info


def eval_ckpt(args, cfg, ckpt_path, logger, device=None):
    """Evaluate one checkpoint on ``device`` (default ``args.device``) -> the
    result dict (every rank's, under data parallel)."""
    from pointrcnn_tpu_torch.data.loader import DataLoader
    from pointrcnn_tpu_torch.eval.evaluator import (
        eval_one_epoch_joint,
        eval_one_epoch_rcnn_offline,
        eval_one_epoch_rpn,
    )
    from pointrcnn_tpu_torch.eval.kitti_eval import evaluate
    from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

    np.random.seed(666 if args.eval_mode == "rcnn" else 1024)  # reference seeds
    split = cfg.TEST.SPLIT if not args.test else "test"
    mode = "TEST" if args.test else "EVAL"
    dataset_cls = ProposalDataset if args.eval_mode == "rcnn_offline" else KittiRCNNDataset
    dataset = dataset_cls(
        args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split=split, mode=mode,
        classes=cfg.CLASSES, logger=logger, random_select=True,
        rcnn_eval_roi_dir=args.rcnn_eval_roi_dir,
        rcnn_eval_feature_dir=args.rcnn_eval_feature_dir,
        # per-point labels only feed the rpn evaluator's seg-IoU; skip the
        # host label pass for the joint and offline modes
        rpn_eval_labels=(args.eval_mode == "rpn"),
    )
    loader = DataLoader(dataset, batch_size=args.batch_size, num_workers=args.workers,
                        use_processes=args.worker_processes)

    # weights drawn from a fixed seed stand wherever no checkpoint restores
    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0))
    model = model.to(torch.device(args.device) if device is None else device)
    epoch = restore(args, model, ckpt_path, logger)
    model.eval()

    anchor = ckpt_path or args.rcnn_ckpt or args.rpn_ckpt
    out_root = args.output_dir or os.path.join(
        os.path.dirname(os.path.dirname(anchor)), "eval", f"epoch_{epoch}", split
    )
    os.makedirs(out_root, exist_ok=True)

    if args.eval_mode == "rpn":
        ret, _ = eval_one_epoch_rpn(
            model, cfg, loader, out_root, logger,
            test_mode=args.test, save_rpn_feature=args.save_rpn_feature,
        )
        return ret

    if args.eval_mode == "rcnn_offline":
        ret, final_dir = eval_one_epoch_rcnn_offline(model, cfg, loader, out_root, logger,
                                                     test_mode=args.test)
    else:
        ret, final_dir = eval_one_epoch_joint(
            model, cfg, loader, out_root, logger,
            test_mode=args.test, save_result=args.save_result,
        )
    if not args.test and mesh.rank() == 0:
        split_file = os.path.join(args.data_root, "KITTI", "ImageSets", f"{split}.txt")
        label_dir = os.path.join(args.data_root, "KITTI", "object", "training", "label_2")
        result_str, ap = evaluate(label_dir, final_dir, split_file,
                                  current_classes=AP_CLASSES[cfg.CLASSES])
        logger.info("\n%s", result_str)
        ret.update(ap)
    return mesh.broadcast_object(ret)


def main(argv=None):
    args = parse_args(argv)
    with mesh.process_group(args.device, args.dist_backend) as device:
        return _evaluate(args, device)


def _evaluate(args, device):
    from pointrcnn_tpu_torch.config import load_config, merge_from_list
    from pointrcnn_tpu_torch.train.checkpoint import list_checkpoints
    from pointrcnn_tpu_torch.utils.snapshot import backup_source

    cfg = load_config(args.cfg_file, args.set_cfgs)
    if args.eval_mode == "rcnn_offline":
        overrides = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True",
                     "RCNN.ROI_SAMPLE_JIT", "False"]
        assert args.rcnn_eval_roi_dir and args.rcnn_eval_feature_dir, (
            "rcnn_offline eval requires --rcnn_eval_roi_dir and --rcnn_eval_feature_dir"
        )
    else:
        overrides = ["RPN.ENABLED", "True"]
        overrides += ["RCNN.ENABLED", "True" if args.eval_mode == "rcnn" else "False"]
    cfg = merge_from_list(cfg, overrides)

    tag = os.path.splitext(os.path.basename(args.cfg_file))[0]
    if args.extra_tag != "default":
        # nest ALL outputs (log + result trees via args.output_dir) under the
        # tag (reference eval_rcnn.py:738-739)
        args.output_dir = os.path.join(
            args.output_dir or os.path.join("output", args.eval_mode, tag),
            args.extra_tag,
        )
    log_dir = args.output_dir or os.path.join("output", args.eval_mode, tag)
    logger = create_logger(os.path.join(log_dir, "log_eval.txt"), "eval")
    if mesh.rank() == 0:
        backup_source(log_dir, logger)

    if args.eval_all:
        # per-checkpoint eval scalars (reference eval_rcnn.py:833-836)
        scalars = os.path.join(log_dir, f"eval_all_{cfg.TEST.SPLIT}.jsonl")
        evaluated: set[int] = set()
        while True:
            # rank 0's listing: a checkpoint written meanwhile would part the ranks
            ckpts = mesh.broadcast_object(
                [c for c in list_checkpoints(args.ckpt_dir or args.ckpt)
                 if c[0] not in evaluated and c[0] >= args.start_epoch])
            if not ckpts and not args.wait:
                assert evaluated, (
                    f"no checkpoints under {args.ckpt_dir or args.ckpt} "
                    f"with epoch >= {args.start_epoch}"
                )
                break
            for epoch, path in ckpts:
                logger.info("==== evaluating %s ====", path)
                ret = eval_ckpt(args, cfg, path, logger, device)
                logger.info("epoch %d: %s", epoch, ret)
                row = {key: float(val) for key, val in ret.items()
                       if isinstance(val, (int, float, np.floating, np.integer))}
                if mesh.rank() == 0:
                    with open(scalars, "a") as f:
                        f.write(json.dumps({"epoch": epoch, **row}) + "\n")
                evaluated.add(epoch)
            if not args.wait:
                break
            time.sleep(30)  # poll interval (reference eval_rcnn.py:817-824)
        return None
    assert args.ckpt or args.rpn_ckpt or args.rcnn_ckpt, (
        "one of --ckpt / --rpn_ckpt / --rcnn_ckpt required"
    )
    ret = eval_ckpt(args, cfg, args.ckpt, logger, device)
    logger.info("result: %s", ret)
    return ret


if __name__ == "__main__":
    main(sys.argv[1:])
