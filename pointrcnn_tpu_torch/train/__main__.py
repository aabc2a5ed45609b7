"""Training CLI (counterpart of ``tools/train.py``; reference
tools/train_rcnn.py), on the card unless ``--device`` says otherwise:

    python -m pointrcnn_tpu_torch.train --train_mode rpn --data_root data [--device cpu]
    python -m pointrcnn_tpu_torch.train --train_mode rcnn --data_root data \\
        --rpn_ckpt output/rpn/default/ckpt/checkpoint_epoch_200

Modes (reference train_rcnn.py:151-164):
  rpn   — train stage 1
  rcnn  — train stage 2 online (frozen RPN weights via --rpn_ckpt)
  rcnn_offline — train stage 2 over the proposals and features that an rpn
          eval with --save_rpn_feature wrote (--rcnn_training_roi_dir,
          --rcnn_training_feature_dir; with --train_with_eval also
          --rcnn_eval_roi_dir, --rcnn_eval_feature_dir)

What ``tools/train.py`` does that this CLI leaves out:
- the data-parallel mesh over every device that divides the batch: this
  CLI trains on one device (data parallel is ROADMAP A8);
- in ``rcnn_offline`` mode the val epoch's dataset: ``tools/train.py``
  gives it the saved proposals of the val split without targets, and its
  first val epoch fails (ROADMAP C18); this CLI samples the val split's
  rois as the training set's (``AUG_DATA`` off) so the loss-only val epoch
  has its targets;
- the tensorboard writer: ``tensorboardX`` is no dependency of the port,
  and ``tools/train.py`` skips the writer where it is absent.  The log
  (``log_train.txt``) has each epoch's steps, time and last loss, and the
  val loss with ``--train_with_eval``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import NamedTuple


class TrainRun(NamedTuple):
    """What a run leaves: the final epoch and iteration, the checkpoint
    directory, and the trainer's per-epoch records (``Trainer.history``)."""

    epoch: int
    it: int
    ckpt_dir: str
    history: list


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PointRCNN trainer (PyTorch + CUDA)")
    p.add_argument("--cfg_file", type=str, default="cfgs/default.yaml")
    p.add_argument("--train_mode", type=str, required=True,
                   choices=["rpn", "rcnn", "rcnn_offline"])
    p.add_argument("--rcnn_training_roi_dir", type=str, default=None,
                   help="rpn proposal txts for offline rcnn training")
    p.add_argument("--rcnn_training_feature_dir", type=str, default=None,
                   help="rpn feature npys for offline rcnn training")
    p.add_argument("--rcnn_eval_roi_dir", type=str, default=None,
                   help="val-split rpn proposal txts for --train_with_eval in "
                        "rcnn_offline mode (reference train_rcnn.py:44-46)")
    p.add_argument("--rcnn_eval_feature_dir", type=str, default=None,
                   help="val-split rpn feature npys for --train_with_eval in "
                        "rcnn_offline mode")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--workers", type=int, default=None,
                   help="loader workers (default: min(8, cpu_count))")
    p.add_argument("--worker_processes", action="store_true",
                   help="fork process-pool workers instead of threads "
                        "(the reference DataLoader shape; for multi-core hosts)")
    p.add_argument("--ckpt_save_interval", type=int, default=5)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--ckpt", type=str, default=None, help="resume checkpoint")
    p.add_argument("--rpn_ckpt", type=str, default=None,
                   help="RPN weights for rcnn training (stage hand-off)")
    p.add_argument("--gt_database", type=str,
                   default="data/gt_database/train_gt_database_level_Car.pkl")
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--train_with_eval", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the model and the train step")
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> TrainRun:
    args = parse_args(argv)
    from pointrcnn_tpu_torch.config import format_config, load_config, merge_from_list
    from pointrcnn_tpu_torch.data.loader import DataLoader
    from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
    from pointrcnn_tpu_torch.eval.__main__ import create_logger
    from pointrcnn_tpu_torch.train.checkpoint import load_checkpoint, load_params_partial
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import create_train_state
    from pointrcnn_tpu_torch.train.trainer import Trainer
    from pointrcnn_tpu_torch.utils.snapshot import backup_source

    cfg = load_config(args.cfg_file, args.set_cfgs)
    tag = os.path.splitext(os.path.basename(args.cfg_file))[0]

    # mode switch (reference train_rcnn.py:151-164)
    if args.train_mode == "rpn":
        overrides = ["RPN.ENABLED", "True", "RCNN.ENABLED", "False"]
    elif args.train_mode == "rcnn":
        overrides = ["RPN.ENABLED", "True", "RPN.FIXED", "True", "RCNN.ENABLED", "True"]
    else:  # rcnn_offline: stage 2 over saved RPN proposals and features
        overrides = ["RPN.ENABLED", "False", "RCNN.ENABLED", "True",
                     "RCNN.ROI_SAMPLE_JIT", "False"]
        assert args.rcnn_training_roi_dir and args.rcnn_training_feature_dir, (
            "rcnn_offline requires --rcnn_training_roi_dir and --rcnn_training_feature_dir "
            "(written by python -m pointrcnn_tpu_torch.eval --eval_mode rpn --save_rpn_feature)"
        )
    cfg = merge_from_list(cfg, overrides)
    root_result_dir = args.output_dir or os.path.join("output", args.train_mode, tag)
    os.makedirs(root_result_dir, exist_ok=True)

    logger = create_logger(os.path.join(root_result_dir, "log_train.txt"), "train")
    logger.info("**** config ****\n%s", format_config(cfg))
    backup_source(root_result_dir, logger)

    gt_db = args.gt_database if cfg.GT_AUG_ENABLED and os.path.exists(args.gt_database) else None
    train_set = KittiRCNNDataset(
        args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split=cfg.TRAIN.SPLIT,
        mode="TRAIN", classes=cfg.CLASSES, gt_database_path=gt_db, logger=logger,
        rcnn_training_roi_dir=args.rcnn_training_roi_dir,
        rcnn_training_feature_dir=args.rcnn_training_feature_dir,
    )
    train_loader = DataLoader(
        train_set, batch_size=args.batch_size, shuffle=True,
        num_workers=args.workers, drop_last=True, seed=args.seed,
        use_processes=args.worker_processes,
    )
    val_loader = None
    if args.train_with_eval and args.train_mode == "rcnn_offline":
        # the loss-only val epoch needs targets: the val split's saved rois
        # are sampled and pooled as the training set's are, with no
        # augmentation (tools/train.py hands it the proposals alone, and its
        # first val epoch stops on the missing pts_input: ROADMAP C18)
        assert args.rcnn_eval_roi_dir and args.rcnn_eval_feature_dir, (
            "rcnn_offline --train_with_eval requires --rcnn_eval_roi_dir and "
            "--rcnn_eval_feature_dir")
        val_set = KittiRCNNDataset(
            args.data_root, merge_from_list(cfg, ["AUG_DATA", "False"]),
            npoints=cfg.RPN.NUM_POINTS, split=cfg.TRAIN.VAL_SPLIT, mode="TRAIN",
            classes=cfg.CLASSES, logger=logger,
            rcnn_training_roi_dir=args.rcnn_eval_roi_dir,
            rcnn_training_feature_dir=args.rcnn_eval_feature_dir,
        )
    elif args.train_with_eval:
        val_set = KittiRCNNDataset(
            args.data_root, cfg, npoints=cfg.RPN.NUM_POINTS, split=cfg.TRAIN.VAL_SPLIT,
            mode="EVAL", classes=cfg.CLASSES, logger=logger,
        )
    if args.train_with_eval:
        val_loader = DataLoader(val_set, batch_size=args.batch_size, num_workers=args.workers,
                                use_processes=args.worker_processes)

    steps_per_epoch = len(train_loader)
    total_steps = steps_per_epoch * args.epochs
    tx = build_optimizer(cfg, total_steps, steps_per_epoch)
    state = create_train_state(cfg, tx, seed=args.seed, device=args.device)

    start_epoch = start_it = 0
    ckpt_dir = os.path.join(root_result_dir, "ckpt")
    if args.ckpt:
        state, start_epoch, start_it = load_checkpoint(args.ckpt, state)
        logger.info("resumed from %s at epoch %d", args.ckpt, start_epoch)
    elif args.rpn_ckpt:
        load_params_partial(args.rpn_ckpt, state.model, ("rpn",))
        logger.info("loaded RPN weights from %s", args.rpn_ckpt)

    trainer = Trainer(cfg, tx, ckpt_dir, ckpt_save_interval=args.ckpt_save_interval,
                      logger=logger, seed=args.seed)
    _, it = trainer.train(state, start_epoch, args.epochs, train_loader, val_loader,
                          start_it=start_it)
    logger.info("**** training finished ****")
    return TrainRun(max(start_epoch, args.epochs), it, ckpt_dir, trainer.history)


if __name__ == "__main__":
    main(sys.argv[1:])
