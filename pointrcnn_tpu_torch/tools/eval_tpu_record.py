"""Evaluate the JAX package's TPU-trained striped AP-gate weights through the
port's eval path, on the fixture that run trained and scored on:

    python -m pointrcnn_tpu_torch.tools.eval_tpu_record [--device cpu]

The weights are ``output/ap_gate_striped_tpu/rcnn/ckpt/checkpoint_epoch_160``
(``tools/ap_gate.py --striped`` on a TPU, 250 rpn and 160 rcnn epochs),
converted into a port checkpoint (``RECORD_CKPT``, parameters and BN
statistics, no optimizer state; ``tests/test_torch_convert_ckpt.py``
converts it afresh and holds it equal).  The fixture
(``output/ap_gate_striped_tpu/kitti``) is copied into the work directory,
so nothing under ``output/`` is written.  The eval is the AP gate's
(``tests/cfgs_ap.yaml`` + ``ap_gate.STRIPED_SET``, batch 4, the val split)
through ``eval/__main__.py::eval_ckpt``; the JSON line holds its recall and
official AP, JAX's record beside them (``RECORD_AP``: its committed
``eval/final_result/data`` scored by the port's ``kitti_eval``), and the
kernel launches of the run.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import pathlib
import shutil
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
RECORD = REPO / "output" / "ap_gate_striped_tpu"
RECORD_CKPT = str(pathlib.Path(__file__).resolve().parent / "records" / "ap_gate_striped_tpu"
                  / "checkpoint_epoch_160")
WORK = str(REPO / "pointrcnn_tpu_torch" / "_build" / "tpu_record")


def record_ap(split: str = "val") -> dict:
    """The official AP of JAX's committed result files of the record."""
    from pointrcnn_tpu_torch.eval.kitti_eval import evaluate

    kitti = RECORD / "kitti" / "KITTI"
    _, ap = evaluate(str(kitti / "object" / "training" / "label_2"),
                     str(RECORD / "eval" / "final_result" / "data"),
                     str(kitti / "ImageSets" / f"{split}.txt"), current_classes=(0,))
    return {k: float(v) for k, v in ap.items()}


def run(work: str = WORK, device: str = "cuda", batch_size: int = 4) -> dict:
    """Copy the fixture under ``work``, evaluate ``RECORD_CKPT`` on it ->
    the eval's scalars and the count of boxes written."""
    from pointrcnn_tpu_torch.config import load_config, merge_from_list
    from pointrcnn_tpu_torch.eval.__main__ import eval_ckpt
    from pointrcnn_tpu_torch.tools.ap_gate import AP_CFG, STRIPED_SET

    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "kitti")
    shutil.copytree(RECORD / "kitti", root)
    cfg = merge_from_list(load_config(AP_CFG, STRIPED_SET),
                          ["RPN.ENABLED", "True", "RCNN.ENABLED", "True"])
    logger = logging.getLogger("eval_tpu_record")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler())
    eargs = argparse.Namespace(
        eval_mode="rcnn", rpn_ckpt=None, rcnn_ckpt=None, rcnn_eval_roi_dir=None,
        rcnn_eval_feature_dir=None, test=False, batch_size=batch_size, workers=1,
        worker_processes=False, data_root=root, output_dir=os.path.join(work, "eval"),
        save_rpn_feature=False, save_result=False, device=device,
    )
    ret = {k: float(v) for k, v in eval_ckpt(eargs, cfg, RECORD_CKPT, logger).items()}
    final = os.path.join(work, "eval", "final_result", "data")
    ret["boxes_written"] = float(sum(len(open(os.path.join(final, f)).read().split("\n")) - 1
                                     for f in os.listdir(final)))
    return ret


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--work", type=str, default=WORK)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    from pointrcnn_tpu_torch.tools.ap_gate import launch_counts

    before = launch_counts()
    ret = run(args.work, args.device)
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    print(json.dumps({**ret, "record": record_ap(), "launches": launches}), flush=True)
    return ret


if __name__ == "__main__":
    main(sys.argv[1:])
