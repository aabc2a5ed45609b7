"""KITTI training/eval dataset with augmentation and label generation.

Host-side re-design of the reference KittiRCNNDataset
(lib/datasets/kitti_rcnn_dataset.py:12-1137) with two structural changes for
TPU fixed shapes:

- gt boxes are padded to ``cfg.RCNN.MAX_GT_BOXES`` with a ``gt_valid`` mask
  (the reference pads to the per-batch max, kitti_rcnn_dataset.py:1104-1122);
- randomness flows through an explicit per-sample ``np.random.RandomState``
  so epochs are reproducible and loader workers can't correlate.

The Delaunay ``in_hull`` foreground test (kitti_utils.py:163-177) is replaced
by the exact oriented-box test (identical results for boxes).
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from pointrcnn_tpu_torch.data.kitti_dataset import KittiDataset
from pointrcnn_tpu_torch.data.object3d import get_objects_from_label, objs_to_boxes3d
from pointrcnn_tpu_torch.utils.native import points_in_boxes3d
from pointrcnn_tpu_torch.utils.np_geometry import (
    boxes_iou3d,
    enlarge_box3d,
    rotate_pc_along_y,
)

_warned_gt_trunc = False


class _GTDBUnpickler(pickle.Unpickler):
    """Unpickle gt databases from EITHER framework.

    The reference's tools/generate_gt_database.py embeds
    ``lib.utils.object3d.Object3d`` instances in its records
    (generate_gt_database.py:79-85); remap that class (attribute-compatible
    — parity-pinned in tests/test_reference_parity.py) onto ours so a
    reference-generated ``*_gt_database_*.pkl`` loads directly."""

    def find_class(self, module, name):
        if name == "Object3d" and module.rsplit(".", 1)[-1] == "object3d":
            from pointrcnn_tpu_torch.data.object3d import Object3d

            return Object3d
        return super().find_class(module, name)


def load_gt_database(path: str) -> list[dict]:
    """Load a gt database pickle produced by this framework OR the
    reference's generate_gt_database.py."""
    with open(path, "rb") as f:
        return _GTDBUnpickler(f).load()


def _warn_gt_truncated(n: int, width: int) -> None:
    """Warn (once) when a TRAIN scene carries more gt boxes than the fixed
    pad width — dropped boxes would train their points as background."""
    global _warned_gt_trunc
    if not _warned_gt_trunc:
        import logging

        logging.getLogger(__name__).warning(
            "collate_batch: %d gt boxes truncated to %d — points in dropped "
            "boxes will be labeled background; raise RCNN.MAX_GT_BOXES",
            n, width,
        )
        _warned_gt_trunc = True


class KittiRCNNDataset(KittiDataset):
    def __init__(
        self,
        root_dir: str,
        cfg,
        npoints: int = 16384,
        split: str = "train",
        classes: str = "Car",
        mode: str = "TRAIN",
        random_select: bool = True,
        gt_database_path: str | None = None,
        aug_scene_root_dir: str | None = None,
        rcnn_eval_roi_dir: str | None = None,
        rcnn_eval_feature_dir: str | None = None,
        rcnn_training_roi_dir: str | None = None,
        rcnn_training_feature_dir: str | None = None,
        rpn_eval_labels: bool = True,
        logger=None,
    ):
        super().__init__(root_dir=root_dir, split=split)
        self.cfg = cfg
        assert mode in ("TRAIN", "EVAL", "TEST"), mode
        self.mode = mode
        self.npoints = npoints
        self.random_select = random_select
        # EVAL-mode per-point labels are only read by the rpn evaluator's
        # seg-IoU accounting; the joint/offline evaluators never touch them,
        # and the label pass is ~1/3 of EVAL sample prep
        self.rpn_eval_labels = rpn_eval_labels
        self.logger = logger

        if classes == "Car":
            self.classes = ("Background", "Car")
            aug_scene_dir = "aug_scene"
        elif classes == "People":
            self.classes = ("Background", "Pedestrian", "Cyclist")
            aug_scene_dir = "aug_scene_ped_cyc"
        elif classes == "Pedestrian":
            self.classes = ("Background", "Pedestrian")
            aug_scene_dir = "aug_scene_ped"
        elif classes == "Cyclist":
            self.classes = ("Background", "Cyclist")
            aug_scene_dir = "aug_scene_cyc"
        else:
            raise ValueError(f"Invalid classes: {classes}")

        aug_root = aug_scene_root_dir or os.path.join(root_dir, "KITTI", aug_scene_dir)
        self.aug_label_dir = os.path.join(aug_root, "training", "aug_label")
        self.aug_pts_dir = os.path.join(aug_root, "training", "rectified_data")

        self.rcnn_eval_roi_dir = rcnn_eval_roi_dir
        self.rcnn_eval_feature_dir = rcnn_eval_feature_dir
        self.rcnn_training_roi_dir = rcnn_training_roi_dir
        self.rcnn_training_feature_dir = rcnn_training_feature_dir

        # gt database for paste augmentation, split easy/hard by point count
        # (reference kitti_rcnn_dataset.py:64-80)
        self.gt_database = None
        if gt_database_path and cfg.GT_AUG_ENABLED and mode == "TRAIN":
            db = load_gt_database(gt_database_path)
            if cfg.GT_AUG_HARD_RATIO > 0:
                easy = [o for o in db if o["points"].shape[0] > 100]
                hard = [o for o in db if o["points"].shape[0] <= 100]
                self.gt_database = [easy, hard]
            else:
                self.gt_database = db

        self.sample_id_list: list[int] = []
        if cfg.RPN.ENABLED:
            if mode == "TRAIN":
                self._preprocess_rpn_training_data()
            else:
                self.sample_id_list = [int(s) for s in self.image_idx_list]
        elif cfg.RCNN.ENABLED:
            if mode == "TRAIN":
                for s in self.image_idx_list:
                    if self.filtrate_objects(self.get_label(int(s))):
                        self.sample_id_list.append(int(s))
            else:
                self.sample_id_list = [int(s) for s in self.image_idx_list]

    # -------------------------------------------------------- bookkeeping

    def _preprocess_rpn_training_data(self):
        """Keep only samples with >=1 object of the target classes
        (reference kitti_rcnn_dataset.py:100-115)."""
        for s in self.image_idx_list:
            if self.filtrate_objects(self.get_label(int(s))):
                self.sample_id_list.append(int(s))

    def get_label(self, idx: int):
        if idx < 10000:
            return super().get_label(idx)
        label_file = os.path.join(self.aug_label_dir, "%06d.txt" % idx)
        assert os.path.exists(label_file), label_file
        return get_objects_from_label(label_file)

    def get_image_shape(self, idx):
        return super().get_image_shape(idx % 10000)

    def get_calib(self, idx):
        return super().get_calib(idx % 10000)

    def get_road_plane(self, idx):
        return super().get_road_plane(idx % 10000)

    def filtrate_objects(self, obj_list):
        """Class + range filtering (reference kitti_rcnn_dataset.py:152-173)."""
        cfg = self.cfg
        type_whitelist = list(self.classes)
        if self.mode == "TRAIN" and cfg.INCLUDE_SIMILAR_TYPE:
            if "Car" in self.classes:
                type_whitelist.append("Van")
            if "Pedestrian" in self.classes:
                type_whitelist.append("Person_sitting")
        out = []
        for obj in obj_list:
            if obj.cls_type not in type_whitelist:
                continue
            if (
                self.mode == "TRAIN"
                and cfg.PC_REDUCE_BY_RANGE
                and not self._check_pc_range(obj.pos)
            ):
                continue
            out.append(obj)
        return out

    def cls_index(self, cls_type: str) -> int:
        """0-based foreground-class index; similar types map to their main
        class (Van->Car, Person_sitting->Pedestrian; reference
        kitti_rcnn_dataset.py:166-173 treats them as the same category)."""
        if cls_type == "Van":
            cls_type = "Car"
        elif cls_type == "Person_sitting":
            cls_type = "Pedestrian"
        try:
            return max(self.classes.index(cls_type) - 1, 0)
        except ValueError:
            return 0

    @staticmethod
    def filtrate_dc_objects(obj_list):
        return [obj for obj in obj_list if obj.cls_type != "DontCare"]

    def _check_pc_range(self, xyz) -> bool:
        x, y, z = self.cfg.PC_AREA_SCOPE
        return (
            x[0] <= xyz[0] <= x[1] and y[0] <= xyz[1] <= y[1] and z[0] <= xyz[2] <= z[1]
        )

    def get_valid_flag(self, pts_rect, pts_img, pts_rect_depth, img_shape):
        """In-image + in-range filter (reference kitti_rcnn_dataset.py:197-219)."""
        flag = (
            (pts_img[:, 0] >= 0)
            & (pts_img[:, 0] < img_shape[1])
            & (pts_img[:, 1] >= 0)
            & (pts_img[:, 1] < img_shape[0])
            & (pts_rect_depth >= 0)
        )
        if self.cfg.PC_REDUCE_BY_RANGE:
            x, y, z = self.cfg.PC_AREA_SCOPE
            p = pts_rect
            flag &= (
                (p[:, 0] >= x[0]) & (p[:, 0] <= x[1])
                & (p[:, 1] >= y[0]) & (p[:, 1] <= y[1])
                & (p[:, 2] >= z[0]) & (p[:, 2] <= z[1])
            )
        return flag

    def __len__(self):
        return len(self.sample_id_list)

    def __getitem__(self, index):
        return self.getitem(index, np.random)

    def getitem(self, index, rng):
        cfg = self.cfg
        if cfg.RPN.ENABLED:
            return self.get_rpn_sample(index, rng)
        if cfg.RCNN.ENABLED:
            if self.mode == "TRAIN":
                if cfg.RCNN.ROI_SAMPLE_JIT:
                    return self.get_rcnn_sample_jit(index)
                return self.get_rcnn_training_sample_batch(index, rng)
            return self.get_proposal_from_file(index)
        raise NotImplementedError

    # -------------------------------------------------------- RPN samples

    def get_rpn_sample(self, index: int, rng) -> dict:
        """(reference get_rpn_sample, kitti_rcnn_dataset.py:246-362)."""
        cfg = self.cfg
        sample_id = int(self.sample_id_list[index])
        if sample_id < 10000:
            calib = self.get_calib(sample_id)
            img_shape = self.get_image_shape(sample_id)
            pts_lidar = self.get_lidar(sample_id)
            pts_rect = calib.lidar_to_rect(pts_lidar[:, 0:3])
            pts_intensity = pts_lidar[:, 3]
        else:
            calib = self.get_calib(sample_id % 10000)
            img_shape = self.get_image_shape(sample_id % 10000)
            pts_file = os.path.join(self.aug_pts_dir, "%06d.bin" % sample_id)
            aug_pts = np.fromfile(pts_file, dtype=np.float32).reshape(-1, 4)
            pts_rect, pts_intensity = aug_pts[:, 0:3], aug_pts[:, 3]

        pts_img, pts_rect_depth = calib.rect_to_img(pts_rect)
        valid = self.get_valid_flag(pts_rect, pts_img, pts_rect_depth, img_shape)
        pts_rect = pts_rect[valid][:, 0:3]
        pts_intensity = pts_intensity[valid]

        gt_aug_flag = False
        extra_gt_obj_list = None
        if cfg.GT_AUG_ENABLED and self.mode == "TRAIN" and self.gt_database is not None:
            all_gt = objs_to_boxes3d(self.filtrate_dc_objects(self.get_label(sample_id)))
            if rng.rand() < cfg.GT_AUG_APPLY_PROB:
                (
                    gt_aug_flag,
                    pts_rect,
                    pts_intensity,
                    _,
                    extra_gt_obj_list,
                ) = self.apply_gt_aug_to_one_scene(
                    sample_id, pts_rect, pts_intensity, all_gt, rng
                )

        # fixed-size sampling: depth-stratified (near < 40 m)
        # (reference kitti_rcnn_dataset.py:285-301)
        if self.mode == "TRAIN" or self.random_select:
            if self.npoints < len(pts_rect):
                depth = pts_rect[:, 2]
                near_idxs = np.nonzero(depth < 40.0)[0]
                far_idxs = np.nonzero(depth >= 40.0)[0]
                take_near = self.npoints - len(far_idxs)
                if take_near > 0:
                    near_choice = rng.choice(near_idxs, take_near, replace=False)
                    choice = (
                        np.concatenate([near_choice, far_idxs])
                        if len(far_idxs) > 0 else near_choice
                    )
                else:
                    choice = rng.choice(np.arange(len(pts_rect)), self.npoints, replace=False)
            else:
                choice = np.arange(len(pts_rect), dtype=np.int64)
                if self.npoints > len(pts_rect):
                    extra = rng.choice(choice, self.npoints - len(pts_rect), replace=True)
                    choice = np.concatenate([choice, extra])
            rng.shuffle(choice)
            ret_pts_rect = pts_rect[choice]
            ret_pts_intensity = pts_intensity[choice] - 0.5
        else:
            ret_pts_rect = pts_rect
            ret_pts_intensity = pts_intensity - 0.5

        ret_pts_features = ret_pts_intensity.reshape(-1, 1).astype(np.float32)
        info = {"sample_id": sample_id, "random_select": self.random_select}

        if self.mode == "TEST":
            pts_input = (
                np.concatenate([ret_pts_rect, ret_pts_features], axis=1)
                if cfg.RPN.USE_INTENSITY else ret_pts_rect
            )
            info.update(
                pts_input=pts_input.astype(np.float32),
                pts_rect=ret_pts_rect.astype(np.float32),
                pts_features=ret_pts_features,
            )
            return info

        gt_obj_list = self.filtrate_objects(self.get_label(sample_id))
        if gt_aug_flag and extra_gt_obj_list:
            gt_obj_list.extend(extra_gt_obj_list)
        gt_boxes3d = objs_to_boxes3d(gt_obj_list)
        gt_alpha = np.array([obj.alpha for obj in gt_obj_list], dtype=np.float32)

        aug_pts_rect = ret_pts_rect.copy().astype(np.float32)
        aug_gt_boxes3d = gt_boxes3d.copy()
        if cfg.AUG_DATA and self.mode == "TRAIN":
            aug_pts_rect, aug_gt_boxes3d, aug_method = self.data_augmentation(
                aug_pts_rect, aug_gt_boxes3d, gt_alpha, rng
            )
            info["aug_method"] = aug_method

        pts_input = (
            np.concatenate([aug_pts_rect, ret_pts_features], axis=1)
            if cfg.RPN.USE_INTENSITY else aug_pts_rect
        )
        info.update(
            pts_input=pts_input.astype(np.float32),
            pts_rect=aug_pts_rect.astype(np.float32),
            pts_features=ret_pts_features,
            gt_boxes3d=aug_gt_boxes3d.astype(np.float32),
            gt_cls=np.array(
                [self.cls_index(o.cls_type) for o in gt_obj_list], np.int32
            ),
        )
        if self.mode == "TRAIN":
            # default: labels are generated on device inside the train step
            # (train/labels.py); host labels only when DEVICE_LABELS is off
            emit_labels = not (
                "DEVICE_LABELS" not in cfg.RPN or cfg.RPN.DEVICE_LABELS
            )
        else:
            # EVAL: only the rpn evaluator reads them (seg-IoU accounting)
            emit_labels = self.rpn_eval_labels
        if not cfg.RPN.FIXED and emit_labels:
            cls_label, reg_label = self.generate_rpn_training_labels(
                aug_pts_rect, aug_gt_boxes3d
            )
            info["rpn_cls_label"] = cls_label
            info["rpn_reg_label"] = reg_label
        return info

    @staticmethod
    def generate_rpn_training_labels(pts_rect: np.ndarray, gt_boxes3d: np.ndarray):
        """Per-point fg label + box targets (reference
        kitti_rcnn_dataset.py:364-394); oriented-box test instead of Delaunay."""
        cls_label = np.zeros(pts_rect.shape[0], dtype=np.int32)
        reg_label = np.zeros((pts_rect.shape[0], 7), dtype=np.float32)
        if gt_boxes3d.shape[0] == 0:
            return cls_label, reg_label
        fg_all = points_in_boxes3d(pts_rect, gt_boxes3d)  # (M, N)
        enlarged = enlarge_box3d(gt_boxes3d, extra_width=0.2)
        fg_enlarged = points_in_boxes3d(pts_rect, enlarged)
        for k in range(gt_boxes3d.shape[0]):
            fg = fg_all[k]
            cls_label[fg] = 1
            cls_label[np.logical_xor(fg, fg_enlarged[k])] = -1

            center3d = gt_boxes3d[k, 0:3].copy()
            center3d[1] -= gt_boxes3d[k, 3] / 2  # true 3D center
            reg_label[fg, 0:3] = center3d - pts_rect[fg]
            reg_label[fg, 3:6] = gt_boxes3d[k, 3:6]
            reg_label[fg, 6] = gt_boxes3d[k, 6]
        return cls_label, reg_label

    # -------------------------------------------------------- augmentation

    def apply_gt_aug_to_one_scene(self, sample_id, pts_rect, pts_intensity,
                                  all_gt_boxes3d, rng):
        """GT-database paste augmentation (reference
        kitti_rcnn_dataset.py:408-511)."""
        cfg = self.cfg
        assert self.gt_database is not None
        extra_gt_num = (
            rng.randint(10, cfg.GT_EXTRA_NUM) if cfg.GT_AUG_RAND_NUM else cfg.GT_EXTRA_NUM
        )
        try_times = 100
        cnt = 0
        cur_gt_boxes3d = all_gt_boxes3d.copy()
        if cur_gt_boxes3d.shape[0] > 0:
            cur_gt_boxes3d[:, 4] += 0.5
            cur_gt_boxes3d[:, 5] += 0.5

        extra_gt_obj_list, extra_gt_boxes3d_list = [], []
        new_pts_list, new_pts_intensity_list = [], []
        carve_boxes_list: list[np.ndarray] = []
        src_pts_flag = np.ones(pts_rect.shape[0], dtype=bool)

        a, b, c, d = self.get_road_plane(sample_id)

        while try_times > 0:
            if cnt > extra_gt_num:
                break
            try_times -= 1
            if cfg.GT_AUG_HARD_RATIO > 0:
                use_hard = rng.rand() <= cfg.GT_AUG_HARD_RATIO
                pool = self.gt_database[1] if use_hard else self.gt_database[0]
                if not pool:  # fall back when the easy/hard split is empty
                    pool = self.gt_database[0] or self.gt_database[1]
                new_gt_dict = pool[rng.randint(0, len(pool))]
            else:
                new_gt_dict = self.gt_database[rng.randint(0, len(self.gt_database))]

            new_box = new_gt_dict["gt_box3d"].copy()
            new_pts = new_gt_dict["points"].copy()
            new_intensity = new_gt_dict["intensity"].copy()
            new_obj = new_gt_dict["obj"]
            if cfg.PC_REDUCE_BY_RANGE and not self._check_pc_range(new_box[0:3]):
                continue
            if len(new_pts) < 5:
                continue

            # drop onto the road plane
            cur_height = (-d - a * new_box[0] - c * new_box[2]) / b
            move = new_box[1] - cur_height
            new_box[1] -= move
            new_pts[:, 1] -= move

            enlarged = new_box.copy()
            enlarged[4] += 0.5
            enlarged[5] += 0.5
            cnt += 1
            if cur_gt_boxes3d.shape[0] > 0:
                iou = boxes_iou3d(enlarged.reshape(1, 7), cur_gt_boxes3d)
                if iou.max() >= 1e-8:  # collision with existing boxes
                    continue

            # record pasted volume; original points are carved out in one
            # batched pass after the loop (carve-outs are independent)
            tall = new_box.copy()
            tall[3] += 2.0
            carve_boxes_list.append(tall)

            import copy as _copy

            new_obj = _copy.deepcopy(new_obj)
            new_obj.pos = new_obj.pos.copy()
            new_obj.pos[1] -= move

            new_pts_list.append(new_pts)
            new_pts_intensity_list.append(new_intensity)
            cur_gt_boxes3d = np.concatenate(
                [cur_gt_boxes3d, enlarged.reshape(1, 7)], axis=0
            )
            extra_gt_boxes3d_list.append(new_box.reshape(1, 7))
            extra_gt_obj_list.append(new_obj)

        if not new_pts_list:
            return False, pts_rect, pts_intensity, None, None

        # batched carve-out: one native pass over the cloud for all volumes
        carve = np.stack(carve_boxes_list).astype(np.float32)
        src_pts_flag &= ~points_in_boxes3d(pts_rect, carve).any(axis=0)

        extra_gt_boxes3d = np.concatenate(extra_gt_boxes3d_list, axis=0)
        pts_rect = np.concatenate([pts_rect[src_pts_flag]] + new_pts_list, axis=0)
        pts_intensity = np.concatenate(
            [pts_intensity[src_pts_flag]] + new_pts_intensity_list, axis=0
        )
        return True, pts_rect, pts_intensity, extra_gt_boxes3d, extra_gt_obj_list

    def data_augmentation(self, pts_rect, gt_boxes3d, gt_alpha, rng, mustaug=False):
        """Scene-level rotation/scaling/flip (reference
        kitti_rcnn_dataset.py:513-570, stage-1 path)."""
        cfg = self.cfg
        aug_list = cfg.AUG_METHOD_LIST
        aug_enable = 1 - rng.rand(3)
        if mustaug:
            aug_enable[0] = -1
            aug_enable[1] = -1
        aug_method = []

        if "rotation" in aug_list and aug_enable[0] < cfg.AUG_METHOD_PROB[0]:
            angle = rng.uniform(-np.pi / cfg.AUG_ROT_RANGE, np.pi / cfg.AUG_ROT_RANGE)
            pts_rect = rotate_pc_along_y(pts_rect, angle)
            gt_boxes3d = rotate_pc_along_y(gt_boxes3d, angle)
            # alpha-preserving ry recompute
            x, z = gt_boxes3d[:, 0], gt_boxes3d[:, 2]
            beta = np.arctan2(z, x)
            gt_boxes3d[:, 6] = np.sign(beta) * np.pi / 2 + gt_alpha - beta
            aug_method.append(["rotation", float(angle)])

        if "scaling" in aug_list and aug_enable[1] < cfg.AUG_METHOD_PROB[1]:
            scale = rng.uniform(0.95, 1.05)
            pts_rect = pts_rect * scale
            gt_boxes3d[:, 0:6] = gt_boxes3d[:, 0:6] * scale
            aug_method.append(["scaling", float(scale)])

        if "flip" in aug_list and aug_enable[2] < cfg.AUG_METHOD_PROB[2]:
            pts_rect[:, 0] = -pts_rect[:, 0]
            gt_boxes3d[:, 0] = -gt_boxes3d[:, 0]
            gt_boxes3d[:, 6] = np.sign(gt_boxes3d[:, 6]) * np.pi - gt_boxes3d[:, 6]
            aug_method.append("flip")

        return pts_rect, gt_boxes3d, aug_method

    # -------------------------------------------------------- RCNN samples

    def get_rpn_features(self, rpn_feature_dir: str, idx: int):
        """(reference kitti_rcnn_dataset.py:138-150)."""
        cfg = self.cfg
        xyz = np.load(os.path.join(rpn_feature_dir, "%06d_xyz.npy" % idx))
        feats = np.load(os.path.join(rpn_feature_dir, "%06d.npy" % idx))
        intensity = np.load(
            os.path.join(rpn_feature_dir, "%06d_intensity.npy" % idx)
        ).reshape(-1)
        if cfg.RCNN.USE_SEG_SCORE:
            raw = np.load(os.path.join(rpn_feature_dir, "%06d_rawscore.npy" % idx)).reshape(-1)
            seg = 1.0 / (1.0 + np.exp(-raw))
        else:
            seg = np.load(os.path.join(rpn_feature_dir, "%06d_seg.npy" % idx)).reshape(-1)
        return xyz, feats, intensity, seg

    def get_rcnn_sample_jit(self, index: int) -> dict:
        """(reference kitti_rcnn_dataset.py:1079-1102)."""
        sample_id = int(self.sample_id_list[index])
        xyz, feats, intensity, seg = self.get_rpn_features(
            self.rcnn_training_feature_dir, sample_id
        )
        roi_file = os.path.join(self.rcnn_training_roi_dir, "%06d.txt" % sample_id)
        roi_boxes3d = objs_to_boxes3d(get_objects_from_label(roi_file))
        gt_objs = self.filtrate_objects(self.get_label(sample_id))
        gt_boxes3d = objs_to_boxes3d(gt_objs)
        gt_cls = np.array([self.cls_index(o.cls_type) for o in gt_objs], np.int32)
        return {
            "sample_id": sample_id,
            "gt_cls": gt_cls,
            "rpn_xyz": xyz.astype(np.float32),
            "rpn_features": feats.astype(np.float32),
            "rpn_intensity": intensity.astype(np.float32),
            "seg_mask": seg.astype(np.float32),
            "roi_boxes3d": roi_boxes3d,
            "gt_boxes3d": gt_boxes3d,
            "pts_depth": np.linalg.norm(xyz, ord=2, axis=1).astype(np.float32),
        }

    # ------------------------------------------- offline RCNN training

    @staticmethod
    def random_aug_box3d_np(box3d: np.ndarray, method: str, rng) -> np.ndarray:
        """Numpy roi jitter (reference kitti_rcnn_dataset.py:770-788)."""
        if method == "single":
            pos = rng.rand(3) - 0.5
            hwl = (rng.rand(3) - 0.5) / (0.5 / 0.15) + 1.0
            ang = (rng.rand(1) - 0.5) / (0.5 / (np.pi / 12))
        elif method == "multiple":
            ranges = [
                [0.2, 0.1, np.pi / 12],
                [0.3, 0.15, np.pi / 12],
                [0.5, 0.15, np.pi / 9],
                [0.8, 0.15, np.pi / 6],
                [1.0, 0.15, np.pi / 3],
            ]
            r = ranges[rng.randint(len(ranges))]
            pos = ((rng.rand(3) - 0.5) / 0.5) * r[0]
            hwl = ((rng.rand(3) - 0.5) / 0.5) * r[1] + 1.0
            ang = ((rng.rand(1) - 0.5) / 0.5) * r[2]
        elif method == "normal":
            pos = rng.normal(0, [0.3, 0.2, 0.3])
            hwl_shift = rng.normal(0, [0.25, 0.15, 0.5])
            ang = ((rng.rand(1) - 0.5) / 0.5) * np.pi / 12
            return np.concatenate(
                [box3d[0:3] + pos, box3d[3:6] + hwl_shift, box3d[6:7] + ang]
            ).astype(np.float32)
        else:
            raise NotImplementedError(method)
        return np.concatenate(
            [box3d[0:3] + pos, box3d[3:6] * hwl, box3d[6:7] + ang]
        ).astype(np.float32)

    def aug_roi_by_noise_batch(self, roi_boxes3d, gt_of_rois, aug_times, rng):
        """Retry-until-IoU jitter (reference aug_roi_by_noise_batch)."""
        cfg = self.cfg
        pos_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
        out = roi_boxes3d.copy()
        iou_out = np.zeros(len(out), np.float32)
        for k in range(len(out)):
            temp_iou = cnt = 0
            aug_box = roi_boxes3d[k]
            keep = True
            while temp_iou < pos_thresh and cnt < aug_times:
                if rng.rand() < 0.2:
                    aug_box = roi_boxes3d[k]
                    keep = True
                else:
                    aug_box = self.random_aug_box3d_np(
                        roi_boxes3d[k], cfg.RCNN.REG_AUG_METHOD, rng
                    )
                    keep = False
                temp_iou = boxes_iou3d(
                    aug_box.reshape(1, 7), gt_of_rois[k].reshape(1, 7)
                )[0, 0]
                cnt += 1
            out[k] = aug_box
            if cnt == 0 or keep:
                iou_out[k] = boxes_iou3d(
                    roi_boxes3d[k].reshape(1, 7), gt_of_rois[k].reshape(1, 7)
                )[0, 0]
            else:
                iou_out[k] = temp_iou
        return out, iou_out

    def _sample_bg_inds_np(self, hard_bg, easy_bg, num, rng):
        """(reference sample_bg_inds, proposal_target_layer.py:184-211)."""
        cfg = self.cfg
        if hard_bg.size > 0 and easy_bg.size > 0:
            hard_num = int(num * cfg.RCNN.HARD_BG_RATIO)
            easy_num = num - hard_num
            return np.concatenate(
                [
                    hard_bg[rng.randint(0, hard_bg.size, hard_num)],
                    easy_bg[rng.randint(0, easy_bg.size, easy_num)],
                ]
            )
        pool = hard_bg if hard_bg.size > 0 else easy_bg
        return pool[rng.randint(0, pool.size, num)]

    @staticmethod
    def canonical_transform_batch(pts_input, roi_boxes3d, gt_boxes3d):
        """(reference kitti_rcnn_dataset.py:700-719)."""
        roi_ry = roi_boxes3d[:, 6] % (2 * np.pi)
        roi_center = roi_boxes3d[:, 0:3]
        pts = pts_input.copy()
        pts[:, :, 0:3] -= roi_center[:, None, :]
        gt_ct = gt_boxes3d.copy()
        gt_ct[:, 0:3] -= roi_center
        gt_ct[:, 6] -= roi_ry
        for k in range(len(roi_ry)):
            pts[k] = rotate_pc_along_y(pts[k], roi_ry[k])
            gt_ct[k : k + 1] = rotate_pc_along_y(gt_ct[k : k + 1], roi_ry[k])
        return pts, gt_ct

    def get_rcnn_training_sample_batch(self, index: int, rng) -> dict:
        """Offline (CPU-side) RoI sampling + pooling for RCNN training
        (reference kitti_rcnn_dataset.py:876-1022)."""
        from pointrcnn_tpu_torch.utils.native import roipool3d_cpu

        cfg = self.cfg
        sample_id = int(self.sample_id_list[index])
        rpn_xyz, rpn_features, rpn_intensity, seg_mask = self.get_rpn_features(
            self.rcnn_training_feature_dir, sample_id
        )
        roi_file = os.path.join(self.rcnn_training_roi_dir, "%06d.txt" % sample_id)
        roi_boxes3d = objs_to_boxes3d(get_objects_from_label(roi_file))
        gt_objs = self.filtrate_objects(self.get_label(sample_id))
        gt_boxes3d = objs_to_boxes3d(gt_objs)
        gt_cls = np.array([self.cls_index(o.cls_type) for o in gt_objs], np.int32)

        iou = boxes_iou3d(roi_boxes3d, gt_boxes3d)
        max_overlaps, gt_assignment = iou.max(axis=1), iou.argmax(axis=1)
        max_iou_of_gt, roi_assignment = iou.max(axis=0), iou.argmax(axis=0)
        roi_assignment = roi_assignment[max_iou_of_gt > 0].reshape(-1)

        R = cfg.RCNN.ROI_PER_IMAGE
        fg_rois_per_image = int(np.round(cfg.RCNN.FG_RATIO * R))
        fg_thresh = min(cfg.RCNN.REG_FG_THRESH, cfg.RCNN.CLS_FG_THRESH)
        fg_inds = np.nonzero(max_overlaps >= fg_thresh)[0]
        # best-roi-per-gt also counts as fg (kitti_rcnn_dataset.py:901)
        fg_inds = np.concatenate([fg_inds, roi_assignment])
        easy_bg = np.nonzero(max_overlaps < cfg.RCNN.CLS_BG_THRESH_LO)[0]
        hard_bg = np.nonzero(
            (max_overlaps < cfg.RCNN.CLS_BG_THRESH)
            & (max_overlaps >= cfg.RCNN.CLS_BG_THRESH_LO)
        )[0]

        fg_num, bg_num = fg_inds.size, easy_bg.size + hard_bg.size
        if fg_num > 0 and bg_num > 0:
            fg_take = min(fg_rois_per_image, fg_num)
            fg_inds = fg_inds[rng.permutation(fg_num)[:fg_take]]
            bg_inds = self._sample_bg_inds_np(hard_bg, easy_bg, R - fg_take, rng)
        elif fg_num > 0:
            fg_inds = fg_inds[np.floor(rng.rand(R) * fg_num).astype(np.int64)]
            fg_take, bg_inds = R, np.array([], np.int64)
        elif bg_num > 0:
            fg_take, fg_inds = 0, np.array([], np.int64)
            bg_inds = self._sample_bg_inds_np(hard_bg, easy_bg, R, rng)
        else:
            # degenerate scene: cycle rois, all labels invalidated below
            fg_take, fg_inds = 0, np.array([], np.int64)
            bg_inds = np.arange(R) % max(len(roi_boxes3d), 1)

        roi_list, iou_list, gt_list, cls_list = [], [], [], []
        if fg_take > 0:
            fg_rois, fg_iou = self.aug_roi_by_noise_batch(
                roi_boxes3d[fg_inds].copy(), gt_boxes3d[gt_assignment[fg_inds]],
                aug_times=cfg.RCNN.ROI_FG_AUG_TIMES, rng=rng,
            )
            roi_list.append(fg_rois)
            iou_list.append(fg_iou)
            gt_list.append(gt_boxes3d[gt_assignment[fg_inds]])
            cls_list.append(gt_cls[gt_assignment[fg_inds]])
        if len(bg_inds) > 0:
            bg_rois, bg_iou = self.aug_roi_by_noise_batch(
                roi_boxes3d[bg_inds].copy(), gt_boxes3d[gt_assignment[bg_inds]],
                aug_times=1, rng=rng,
            )
            roi_list.append(bg_rois)
            iou_list.append(bg_iou)
            gt_list.append(gt_boxes3d[gt_assignment[bg_inds]])
            cls_list.append(gt_cls[gt_assignment[bg_inds]])

        rois = np.concatenate(roi_list, axis=0)
        iou_of_rois = np.concatenate(iou_list, axis=0)
        gt_of_rois = np.concatenate(gt_list, axis=0)
        gt_cls_of_rois = np.concatenate(cls_list, axis=0).astype(np.int32)

        extra = [seg_mask.reshape(-1, 1)]
        if cfg.RCNN.USE_INTENSITY:
            extra.insert(0, rpn_intensity.reshape(-1, 1))
        if cfg.RCNN.USE_DEPTH:
            depth = (np.linalg.norm(rpn_xyz, ord=2, axis=1) / 70.0) - 0.5
            extra.append(depth.reshape(-1, 1))
        all_feats = np.concatenate(extra + [rpn_features], axis=1)

        pooled, empty = roipool3d_cpu(
            rpn_xyz, all_feats, rois, cfg.RCNN.POOL_EXTRA_WIDTH, cfg.RCNN.NUM_POINTS
        )
        n_extra = len(extra)
        pts_input = pooled[:, :, : 3 + n_extra].copy()  # xyz + extra channels
        pts_features = pooled[:, :, 3 + n_extra :].copy()

        if cfg.AUG_DATA and self.mode == "TRAIN":
            for k in range(len(rois)):
                boxes2 = np.stack([rois[k], gt_of_rois[k]], axis=0)
                beta = np.arctan2(boxes2[:, 2], boxes2[:, 0]).astype(np.float64)
                alpha = -np.sign(beta) * np.pi / 2 + beta + boxes2[:, 6]
                aug_pts, aug_boxes, _ = self.data_augmentation(
                    pts_input[k, :, 0:3].copy(), boxes2, alpha, rng, mustaug=True
                )
                pts_input[k, :, 0:3] = aug_pts
                rois[k], gt_of_rois[k] = aug_boxes[0], aug_boxes[1]

        valid_mask = (~empty).astype(np.int32)
        reg_valid_mask = ((iou_of_rois > cfg.RCNN.REG_FG_THRESH).astype(np.int32) & valid_mask)
        # foreground label is the 1-based gt class index — same convention
        # as the online target layer (models/target.py); single-class
        # configs have gt_cls all zero, reducing to the binary 0/1 form
        cls_label = np.where(
            iou_of_rois > cfg.RCNN.CLS_FG_THRESH, gt_cls_of_rois + 1, 0
        ).astype(np.int32)
        invalid = (iou_of_rois > cfg.RCNN.CLS_BG_THRESH) & (iou_of_rois < cfg.RCNN.CLS_FG_THRESH)
        cls_label[invalid] = -1
        cls_label[valid_mask == 0] = -1

        pts_input_ct, gt_boxes3d_ct = self.canonical_transform_batch(
            pts_input, rois, gt_of_rois
        )

        return {
            "sample_id": sample_id,
            "pts_input": pts_input_ct.astype(np.float32),
            "pts_features": pts_features.astype(np.float32),
            "cls_label": cls_label,
            "reg_valid_mask": reg_valid_mask,
            "gt_boxes3d_ct": gt_boxes3d_ct.astype(np.float32),
            "gt_cls_of_rois": gt_cls_of_rois,
            "roi_boxes3d": rois.astype(np.float32),
            "roi_size": rois[:, 3:6].astype(np.float32),
        }

    def get_proposal_from_file(self, index: int) -> dict:
        """Eval from saved RPN proposals + features (reference
        kitti_rcnn_dataset.py:790-874, tensors-only subset)."""
        sample_id = int(self.image_idx_list[index])
        xyz, feats, intensity, seg = self.get_rpn_features(
            self.rcnn_eval_feature_dir, sample_id
        )
        roi_file = os.path.join(self.rcnn_eval_roi_dir, "%06d.txt" % sample_id)
        roi_objs = get_objects_from_label(roi_file)
        roi_boxes3d = objs_to_boxes3d(roi_objs)
        roi_scores = np.array([obj.score for obj in roi_objs], dtype=np.float32)
        info = {
            "sample_id": sample_id,
            "rpn_xyz": xyz.astype(np.float32),
            "rpn_features": feats.astype(np.float32),
            "rpn_intensity": intensity.astype(np.float32),
            "seg_mask": seg.astype(np.float32),
            "roi_boxes3d": roi_boxes3d,
            "roi_scores": roi_scores,
            "pts_depth": np.linalg.norm(xyz, ord=2, axis=1).astype(np.float32),
        }
        if self.mode == "EVAL":
            gt_obj_list = self.filtrate_objects(self.get_label(sample_id))
            info["gt_boxes3d"] = objs_to_boxes3d(gt_obj_list)
        return info

    # -------------------------------------------------------- batching

    def collate_batch(self, batch: list[dict]) -> dict:
        """Stack a list of samples; variable-count box arrays are padded to
        ``cfg.RCNN.MAX_GT_BOXES`` with a ``*_valid`` mask (fixed shapes for
        jit; reference pads to batch max, kitti_rcnn_dataset.py:1104-1137)."""
        cfg = self.cfg
        max_gt = cfg.RCNN.MAX_GT_BOXES
        # GT paste-aug can push crowded TRAIN scenes past MAX_GT_BOXES, and
        # the on-device label generator (train/labels.py) reads the padded
        # tensor — a truncated box would silently label its points
        # background.  Widen the TRAIN pad by the paste budget instead
        # (still a fixed shape per config, so the train step jits once).
        if self.mode == "TRAIN" and cfg.GT_AUG_ENABLED:
            max_gt = max_gt + cfg.GT_EXTRA_NUM
        offline_rcnn_train = (
            cfg.RCNN.ENABLED and not cfg.RPN.ENABLED
            and not cfg.RCNN.ROI_SAMPLE_JIT and self.mode == "TRAIN"
        )
        out = {}
        for key in batch[0].keys():
            vals = [b[key] for b in batch]
            if offline_rcnn_train and isinstance(vals[0], np.ndarray):
                # per-roi arrays: merge the (batch, roi) axes — rois are the
                # RCNN's batch dimension
                out[key] = np.concatenate(vals, axis=0)
                continue
            if key == "gt_cls":
                padded = np.zeros((len(batch), max_gt), np.int32)
                for i, v in enumerate(vals):
                    n = min(len(v), max_gt)
                    padded[i, :n] = v[:n]
                out[key] = padded
                continue
            if key in ("gt_boxes3d", "roi_boxes3d"):
                # rois loaded from proposal files can be up to the post-NMS
                # budget; gt boxes cap at MAX_GT_BOXES
                width = max_gt
                if key == "roi_boxes3d":
                    budget = (
                        cfg.TRAIN.RPN_POST_NMS_TOP_N
                        if self.mode == "TRAIN" else cfg.TEST.RPN_POST_NMS_TOP_N
                    )
                    width = max(max_gt, budget)
                padded = np.zeros((len(batch), width, 7), np.float32)
                valid = np.zeros((len(batch), width), bool)
                for i, v in enumerate(vals):
                    n = min(len(v), width)
                    if len(v) > width and key == "gt_boxes3d" \
                            and self.mode == "TRAIN":
                        _warn_gt_truncated(len(v), width)
                    padded[i, :n] = v[:n]
                    valid[i, :n] = True
                out[key] = padded
                out[key.replace("boxes3d", "valid")] = valid
            elif isinstance(vals[0], np.ndarray):
                out[key] = np.stack(vals, axis=0)
            elif isinstance(vals[0], (int, np.integer)):
                out[key] = np.array(vals, dtype=np.int32)
            elif isinstance(vals[0], (float, np.floating)):
                out[key] = np.array(vals, dtype=np.float32)
            else:
                out[key] = vals
        return out
