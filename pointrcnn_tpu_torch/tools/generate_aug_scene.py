"""Offline augmented-scene generation CLI (counterpart of
``tools/generate_aug_scene.py``; reference tools/generate_aug_scene.py:14-325):

    python -m pointrcnn_tpu_torch.tools.generate_aug_scene --data_root data \\
        --gt_database data/gt_database/train_gt_database_level_Car.pkl

Writes ``aug_times`` paste-augmented copies of each train scene:
points to ``<save_dir>/rectified_data/<id>.bin`` (rect-frame xyz +
intensity), labels to ``<save_dir>/aug_label/<id>.txt``, with sample ids
offset by 10000*(epoch+1) — the dataset resolves ``idx % 10000`` back to the
source calib/image (rpn_dataset.get_calib) — and the split list
``<split>_aug.txt`` to ``<save_dir>`` and to ``<data_root>/KITTI/ImageSets``.
A host tool (numpy); the database may come from either package's generator.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pointrcnn_tpu_torch.config import default_config
from pointrcnn_tpu_torch.data.calibration import Calibration
from pointrcnn_tpu_torch.data.object3d import objs_to_boxes3d
from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset, load_gt_database
from pointrcnn_tpu_torch.utils.np_geometry import boxes3d_to_corners3d


def save_extra_objects_kitti(calib: Calibration, boxes3d, obj_list, img_shape, fp):
    """Write pasted objects as KITTI label lines with projected 2D boxes."""
    corners3d = boxes3d_to_corners3d(boxes3d)
    img_boxes, _ = calib.corners3d_to_img_boxes(corners3d)
    img_boxes[:, 0] = np.clip(img_boxes[:, 0], 0, img_shape[1] - 1)
    img_boxes[:, 1] = np.clip(img_boxes[:, 1], 0, img_shape[0] - 1)
    img_boxes[:, 2] = np.clip(img_boxes[:, 2], 0, img_shape[1] - 1)
    img_boxes[:, 3] = np.clip(img_boxes[:, 3], 0, img_shape[0] - 1)
    for k, obj in enumerate(obj_list):
        x, z, ry = boxes3d[k, 0], boxes3d[k, 2], boxes3d[k, 6]
        beta = np.arctan2(z, x)
        alpha = -np.sign(beta) * np.pi / 2 + beta + ry
        print(
            "%s %.2f %d %.4f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
            % (
                obj.cls_type, obj.truncation, int(obj.occlusion), alpha,
                img_boxes[k, 0], img_boxes[k, 1], img_boxes[k, 2], img_boxes[k, 3],
                boxes3d[k, 3], boxes3d[k, 4], boxes3d[k, 5],
                boxes3d[k, 0], boxes3d[k, 1], boxes3d[k, 2], boxes3d[k, 6],
            ),
            file=fp,
        )


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", type=str, default="data")
    p.add_argument("--save_dir", type=str, default="data/KITTI/aug_scene/training")
    p.add_argument("--class_name", type=str, default="Car")
    p.add_argument("--split", type=str, default="train")
    p.add_argument("--aug_times", type=int, default=4)
    p.add_argument("--gt_database", type=str,
                   default="data/gt_database/train_gt_database_level_Car.pkl")
    p.add_argument("--seed", type=int, default=1024)  # reference seed
    return p.parse_args(argv)


def main(argv=None) -> list[str]:
    """-> the sample ids of the written split list."""
    args = parse_args(argv)
    cfg = default_config().thaw()
    cfg.GT_AUG_ENABLED = True
    cfg.GT_AUG_RAND_NUM = True
    cfg.GT_EXTRA_NUM = 15
    cfg.GT_AUG_HARD_RATIO = 0.0
    cfg = cfg.freeze()

    ds = KittiRCNNDataset(
        args.data_root, cfg, split=args.split, mode="TRAIN",
        classes=args.class_name, gt_database_path=None,
    )
    ds.gt_database = load_gt_database(args.gt_database)

    rng = np.random.RandomState(args.seed)
    data_dir = os.path.join(args.save_dir, "rectified_data")
    label_dir = os.path.join(args.save_dir, "aug_label")
    os.makedirs(data_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)

    split_list = list(ds.image_idx_list)
    for epoch in range(args.aug_times):
        base_id = (epoch + 1) * 10000
        for sid_str in ds.image_idx_list:
            sample_id = int(sid_str)
            pts_lidar = ds.get_lidar(sample_id)
            calib = ds.get_calib(sample_id)
            img_shape = ds.get_image_shape(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_img, depth = calib.rect_to_img(pts_rect)
            valid = ds.get_valid_flag(pts_rect, pts_img, depth, img_shape)
            pts_rect = pts_rect[valid][:, 0:3]
            pts_intensity = pts_lidar[valid][:, 3]

            all_gt = objs_to_boxes3d(ds.filtrate_dc_objects(ds.get_label(sample_id)))
            obj_list = ds.filtrate_objects(ds.get_label(sample_id))
            if args.class_name != "Car" and len(obj_list) == 0:
                continue

            aug_flag, pts_rect, pts_intensity, extra_boxes, extra_objs = (
                ds.apply_gt_aug_to_one_scene(sample_id, pts_rect, pts_intensity, all_gt, rng)
            )

            out_id = base_id + sample_id
            pts_info = np.concatenate(
                [pts_rect, pts_intensity.reshape(-1, 1)], axis=1
            ).astype(np.float32)
            pts_info.tofile(os.path.join(data_dir, "%06d.bin" % out_id))

            with open(os.path.join(label_dir, "%06d.txt" % out_id), "w") as f:
                for obj in obj_list:
                    print(obj.to_kitti_format(), file=f)
                if aug_flag:
                    save_extra_objects_kitti(calib, extra_boxes, extra_objs, img_shape, f)
            split_list.append("%06d" % out_id)

    split_file = os.path.join(args.save_dir, f"{args.split}_aug.txt")
    with open(split_file, "w") as f:
        f.write("\n".join(split_list) + "\n")
    dst = os.path.join(args.data_root, "KITTI", "ImageSets", f"{args.split}_aug.txt")
    with open(dst, "w") as f:
        f.write("\n".join(split_list) + "\n")
    print(f"wrote {len(split_list)} ids to {split_file} and {dst}")
    return split_list


if __name__ == "__main__":
    main(sys.argv[1:])
