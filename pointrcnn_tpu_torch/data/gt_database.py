"""GT-database generation for paste augmentation
(reference tools/generate_gt_database.py:14-103)."""

from __future__ import annotations

import os
import pickle

import numpy as np

from pointrcnn_tpu_torch.data.kitti_dataset import KittiDataset
from pointrcnn_tpu_torch.data.object3d import objs_to_boxes3d
from pointrcnn_tpu_torch.utils.native import points_in_boxes3d


class GTDatabaseGenerator(KittiDataset):
    def __init__(self, root_dir: str, split: str = "train", classes: str = "Car"):
        super().__init__(root_dir, split=split)
        if classes == "Car":
            self.classes = ("Background", "Car")
        elif classes == "People":
            self.classes = ("Background", "Pedestrian", "Cyclist")
        elif classes == "Pedestrian":
            self.classes = ("Background", "Pedestrian")
        elif classes == "Cyclist":
            self.classes = ("Background", "Cyclist")
        else:
            raise ValueError(classes)
        self.gt_database = None

    def filtrate_objects(self, obj_list):
        """Keep target classes at Easy/Moderate/Hard difficulty
        (reference generate_gt_database.py:36-48)."""
        return [
            obj
            for obj in obj_list
            if obj.cls_type in self.classes and obj.level_str in ("Easy", "Moderate", "Hard")
        ]

    def generate_gt_database(self) -> list[dict]:
        db = []
        for idx in range(self.num_sample):
            sample_id = int(self.image_idx_list[idx])
            obj_list = self.filtrate_objects(self.get_label(sample_id))
            if not obj_list:
                continue

            calib = self.get_calib(sample_id)
            pts_lidar = self.get_lidar(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3]).astype(np.float32)
            pts_intensity = pts_lidar[:, 3]

            gt_boxes3d = objs_to_boxes3d(obj_list)
            inside = points_in_boxes3d(pts_rect, gt_boxes3d)  # (M, N)
            for k, obj in enumerate(obj_list):
                m = inside[k]
                db.append(
                    {
                        "sample_id": sample_id,
                        "cls_type": obj.cls_type,
                        "gt_box3d": gt_boxes3d[k],
                        "points": pts_rect[m],
                        "intensity": pts_intensity[m].astype(np.float32),
                        "obj": obj,
                    }
                )
        self.gt_database = db
        return db

    def save(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.gt_database, f)
