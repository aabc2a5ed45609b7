"""Raw KITTI file IO (reference lib/datasets/kitti_dataset.py:9-74).

The image shape comes from the PNG header (:func:`png_size`), not from an
image library, so loading a frame needs numpy alone."""

from __future__ import annotations

import os
import struct

import numpy as np

from pointrcnn_tpu_torch.data.calibration import Calibration
from pointrcnn_tpu_torch.data.object3d import get_objects_from_label

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def png_size(path: str) -> tuple[int, int]:
    """(width, height) of a PNG from its IHDR chunk, which the format puts
    first: the 8-byte signature, the chunk's length and type, then width
    and height as big-endian 32-bit integers.  Needs no image library."""
    with open(path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != _PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


class KittiDataset:
    def __init__(self, root_dir: str, split: str = "train"):
        self.split = split
        is_test = split == "test"
        self.imageset_dir = os.path.join(root_dir, "KITTI", "object", "testing" if is_test else "training")

        split_file = os.path.join(root_dir, "KITTI", "ImageSets", f"{split}.txt")
        assert os.path.exists(split_file), split_file
        with open(split_file) as f:
            self.image_idx_list = [x.strip() for x in f.readlines() if x.strip()]
        self.num_sample = len(self.image_idx_list)

        self.image_dir = os.path.join(self.imageset_dir, "image_2")
        self.lidar_dir = os.path.join(self.imageset_dir, "velodyne")
        self.calib_dir = os.path.join(self.imageset_dir, "calib")
        self.label_dir = os.path.join(self.imageset_dir, "label_2")
        self.plane_dir = os.path.join(self.imageset_dir, "planes")

    def get_image(self, idx: int):
        from PIL import Image

        img_file = os.path.join(self.image_dir, "%06d.png" % idx)
        assert os.path.exists(img_file), img_file
        with Image.open(img_file) as im:
            return np.asarray(im)

    def get_image_shape(self, idx: int):
        img_file = os.path.join(self.image_dir, "%06d.png" % idx)
        assert os.path.exists(img_file), img_file
        width, height = png_size(img_file)
        return height, width, 3

    def get_lidar(self, idx: int) -> np.ndarray:
        lidar_file = os.path.join(self.lidar_dir, "%06d.bin" % idx)
        assert os.path.exists(lidar_file), lidar_file
        return np.fromfile(lidar_file, dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx: int) -> Calibration:
        calib_file = os.path.join(self.calib_dir, "%06d.txt" % idx)
        assert os.path.exists(calib_file), calib_file
        return Calibration(calib_file)

    def get_label(self, idx: int):
        label_file = os.path.join(self.label_dir, "%06d.txt" % idx)
        assert os.path.exists(label_file), label_file
        return get_objects_from_label(label_file)

    def get_road_plane(self, idx: int) -> np.ndarray:
        plane_file = os.path.join(self.plane_dir, "%06d.txt" % idx)
        with open(plane_file) as f:
            lines = f.readlines()
        plane = np.asarray([float(x) for x in lines[3].split()])
        # make the normal always point up (y down in cam coords)
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])
