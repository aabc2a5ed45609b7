"""KITTI label objects (reference lib/utils/object3d.py:4-102)."""

from __future__ import annotations

import numpy as np

CLS_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def cls_type_to_id(cls_type: str) -> int:
    return CLS_TO_ID.get(cls_type, -1)


class Object3d:
    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array([float(x) for x in label[4:8]], dtype=np.float32)
        self.h, self.w, self.l = float(label[8]), float(label[9]), float(label[10])
        self.pos = np.array([float(x) for x in label[11:14]], dtype=np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.pos))
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_obj_level()

    def get_obj_level(self) -> int:
        """KITTI difficulty by 2D height / truncation / occlusion
        (reference object3d.py:31-45)."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 1
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 2
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 3
        self.level_str = "UnKnown"
        return 4

    def to_box3d(self) -> np.ndarray:
        return np.array(
            [*self.pos, self.h, self.w, self.l, self.ry], dtype=np.float32
        )

    def to_kitti_format(self) -> str:
        return (
            "%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f"
            % (
                self.cls_type, self.truncation, int(self.occlusion), self.alpha,
                self.box2d[0], self.box2d[1], self.box2d[2], self.box2d[3],
                self.h, self.w, self.l, self.pos[0], self.pos[1], self.pos[2], self.ry,
            )
        )


def get_objects_from_label(label_file: str) -> list[Object3d]:
    with open(label_file) as f:
        return [Object3d(line) for line in f.readlines() if line.strip()]


def objs_to_boxes3d(obj_list) -> np.ndarray:
    boxes = np.zeros((len(obj_list), 7), dtype=np.float32)
    for k, obj in enumerate(obj_list):
        boxes[k] = obj.to_box3d()
    return boxes


def objs_to_scores(obj_list) -> np.ndarray:
    return np.array([obj.score for obj in obj_list], dtype=np.float32)
