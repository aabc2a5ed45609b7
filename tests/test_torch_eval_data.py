"""The port's copies of the JAX package's host modules against their
originals: the data pipeline (``data/``), ``utils/np_geometry.py``,
``utils/native.py`` with ``csrc/host_ops.cpp``, ``eval/kitti_eval.py`` and
``utils/snapshot.py``.

- The verbatim copies are the original's source with the package renamed
  (``test_copies_are_verbatim``); ``kitti_eval.py`` adds the standalone AP
  CLI after the copy.
- The deviations, each held here: ``kitti_dataset.get_image_shape`` reads
  the PNG header, not PIL (equal to PIL's answer); ``native`` builds its
  library into the package's ``_build/`` under a hashed name (the same
  answers as the original's library, and without a library the same
  numpy fallbacks); ``snapshot`` backs up the port's own package.
- The same samples and batches from the same fixture tree and seed, in
  ``EVAL``, ``TEST`` and rpn-``TRAIN`` modes, through both loaders.
"""

from __future__ import annotations

import os
import pathlib
import re

import numpy as np
import pytest

from pointrcnn_tpu.config import load_config as jax_load_config
from pointrcnn_tpu.data import kitti_dataset as jkitti
from pointrcnn_tpu.data.loader import DataLoader as JaxDataLoader
from pointrcnn_tpu.data.rpn_dataset import KittiRCNNDataset as JaxDataset
from pointrcnn_tpu.eval import kitti_eval as jke
from pointrcnn_tpu.utils import native as jnative
from pointrcnn_tpu.utils import np_geometry as jgeo

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.data import kitti_dataset as tkitti
from pointrcnn_tpu_torch.data.loader import DataLoader
from pointrcnn_tpu_torch.data.rpn_dataset import KittiRCNNDataset
from pointrcnn_tpu_torch.eval import kitti_eval as tke
from pointrcnn_tpu_torch.utils import native as tnative
from pointrcnn_tpu_torch.utils import np_geometry as tgeo
from pointrcnn_tpu_torch.utils import snapshot

from kitti_fixture import make_mini_kitti
from test_torch_port_slice import _CFG, one_torch_thread  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
# (original, copy): the copy is the original with the package renamed
VERBATIM = [
    ("pointrcnn_tpu/data/calibration.py", "pointrcnn_tpu_torch/data/calibration.py"),
    ("pointrcnn_tpu/data/object3d.py", "pointrcnn_tpu_torch/data/object3d.py"),
    ("pointrcnn_tpu/data/rpn_dataset.py", "pointrcnn_tpu_torch/data/rpn_dataset.py"),
    ("pointrcnn_tpu/data/loader.py", "pointrcnn_tpu_torch/data/loader.py"),
    ("pointrcnn_tpu/data/gt_database.py", "pointrcnn_tpu_torch/data/gt_database.py"),
    ("pointrcnn_tpu/utils/np_geometry.py", "pointrcnn_tpu_torch/utils/np_geometry.py"),
    ("csrc/host_ops.cpp", "pointrcnn_tpu_torch/csrc/host_ops.cpp"),
]
DATA_OVERRIDES = ["RPN.NUM_POINTS", "1024", "GT_AUG_ENABLED", "False", "RCNN.MAX_GT_BOXES", "8"]


def renamed(text: str) -> str:
    return re.sub(r"\bpointrcnn_tpu\b(?!_torch)", "pointrcnn_tpu_torch", text)


@pytest.mark.parametrize("orig,copy", VERBATIM, ids=[c for _, c in VERBATIM])
def test_copies_are_verbatim(orig, copy):
    assert (REPO / copy).read_text() == renamed((REPO / orig).read_text())


def test_kitti_eval_is_the_copy_plus_its_cli():
    orig = renamed((REPO / "pointrcnn_tpu/eval/kitti_eval.py").read_text())
    port = (REPO / "pointrcnn_tpu_torch/eval/kitti_eval.py").read_text()
    assert port.startswith(orig)
    assert "\ndef main(argv=None):" in port[len(orig):]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_eval_data"))
    make_mini_kitti(root, num_samples=4, n_points=3000, seed=2, z_range=(10.0, 25.0),
                    project_box2d=True)
    return root


def _cfgs(extra=()):
    overrides = DATA_OVERRIDES + list(extra)
    return load_config(str(_CFG), overrides), jax_load_config(str(_CFG), overrides)


def _equal_samples(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(b[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode,extra", [
    ("EVAL", []), ("EVAL", ["RPN.FIXED", "True"]), ("TEST", []),
    ("TRAIN", []), ("TRAIN", ["RPN.DEVICE_LABELS", "False"])])
def test_samples_and_collate_equal(tree, mode, extra):
    cfg, jcfg = _cfgs(extra)
    split = "train" if mode == "TRAIN" else "val"
    tds = KittiRCNNDataset(tree, cfg, npoints=1024, split=split, mode=mode)
    jds = JaxDataset(tree, jcfg, npoints=1024, split=split, mode=mode)
    assert len(tds) == len(jds) == 4
    ts = [tds.getitem(i, np.random.RandomState(i)) for i in range(4)]
    js = [jds.getitem(i, np.random.RandomState(i)) for i in range(4)]
    for a, b in zip(ts, js):
        _equal_samples(a, b)
    _equal_samples(tds.collate_batch(ts), jds.collate_batch(js))
    if mode == "TRAIN":
        assert "aug_method" in ts[0]
    if mode == "EVAL" and not extra:
        assert ts[0]["rpn_cls_label"].sum() > 0


@pytest.mark.parametrize("use_processes", [False, True])
def test_loader_batches_equal(tree, use_processes):
    cfg, jcfg = _cfgs()
    tds = KittiRCNNDataset(tree, cfg, npoints=1024, split="train", mode="TRAIN")
    jds = JaxDataset(tree, jcfg, npoints=1024, split="train", mode="TRAIN")
    kw = dict(batch_size=3, shuffle=True, num_workers=2, seed=7, use_processes=use_processes)
    tl, jl = DataLoader(tds, **kw), JaxDataLoader(jds, **kw)
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        tb, jb = list(tl), list(jl)
        assert len(tb) == len(jb) == len(tl) == 2
        for a, b in zip(tb, jb):
            _equal_samples(a, b)


def _write_png(path, width, height, mode):
    from PIL import Image

    Image.new(mode, (width, height)).save(path)


def test_png_shape_equals_pil(tree, tmp_path):
    ds = tkitti.KittiDataset(tree, split="val")
    jds = jkitti.KittiDataset(tree, split="val")
    for sid in range(4):
        assert ds.get_image_shape(sid) == jds.get_image_shape(sid) == (375, 1242, 3)
    for i, (w, h, mode) in enumerate([(640, 200, "RGB"), (1, 70000, "L"), (3000, 9, "RGBA")]):
        path = tmp_path / f"{i}.png"
        _write_png(path, w, h, mode)
        assert tkitti.png_size(str(path)) == (w, h)
        ds.image_dir = jds.image_dir = str(tmp_path)
        os.replace(path, tmp_path / f"{i:06d}.png")
        assert ds.get_image_shape(i) == jds.get_image_shape(i) == (h, w, 3)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"GIF89a" + bytes(30))
    with pytest.raises(ValueError, match="not a PNG"):
        tkitti.png_size(str(bad))


@pytest.fixture(params=["native", "numpy"])
def host_ops(request, monkeypatch):
    """Both packages with their native library, then both on the numpy
    fallbacks."""
    if request.param == "native":
        assert tnative.get_lib() is not None and jnative.get_lib() is not None
        path = tnative.library_path()
        assert os.path.dirname(path) == str(REPO / "pointrcnn_tpu_torch" / "_build")
        assert re.fullmatch(r"libhost_ops-[0-9a-f]{16}\.so", os.path.basename(path))
        assert os.path.exists(path)
    else:
        for mod in (tnative, jnative):
            monkeypatch.setattr(mod, "_lib", None)
            monkeypatch.setattr(mod, "_tried", True)
        assert tnative.get_lib() is None
    return request.param


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-8, 8, n)
    b[:, 1] = rng.uniform(-1, 2, n)
    b[:, 2] = rng.uniform(0, 16, n)
    b[:, 3:6] = rng.uniform(1.0, 4.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def test_host_geometry_equal(host_ops):
    rng = np.random.RandomState(4)
    pts = rng.uniform(-10, 20, (3000, 3)).astype(np.float32)
    feats = rng.randn(3000, 5).astype(np.float32)
    boxes = _boxes(rng, 12)
    np.testing.assert_array_equal(tnative.points_in_boxes3d(pts, boxes),
                                  jnative.points_in_boxes3d(pts, boxes))
    for a, b in zip(tnative.roipool3d_cpu(pts, feats, boxes, 0.5, 64),
                    jnative.roipool3d_cpu(pts, feats, boxes, 0.5, 64)):
        np.testing.assert_array_equal(a, b)
    bev = tgeo._boxes3d_to_bev_rects(boxes)
    np.testing.assert_array_equal(bev, jgeo._boxes3d_to_bev_rects(boxes))
    np.testing.assert_array_equal(tnative.bev_overlap(bev, bev[::-1]),
                                  jnative.bev_overlap(bev, bev[::-1]))
    for need_bev in (False, True):
        for a, b in zip(np.atleast_1d(tgeo.boxes_iou3d(boxes, boxes[3:], need_bev)),
                        np.atleast_1d(jgeo.boxes_iou3d(boxes, boxes[3:], need_bev))):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgeo.bev_iou_rotated(boxes, boxes), jgeo.bev_iou_rotated(boxes, boxes))
    np.testing.assert_array_equal(tgeo.boxes3d_to_corners3d(boxes), jgeo.boxes3d_to_corners3d(boxes))
    np.testing.assert_array_equal(tgeo.enlarge_box3d(boxes, 0.2), jgeo.enlarge_box3d(boxes, 0.2))
    np.testing.assert_array_equal(tgeo.rotate_pc_along_y(pts.copy(), 0.3),
                                  jgeo.rotate_pc_along_y(pts.copy(), 0.3))


def write_detections(tree, out_dir, seed, ids=range(4)):
    """Detections from the labels: each gt box jittered, with a score, plus
    a false positive a frame; written as KITTI result files."""
    rng = np.random.RandomState(seed)
    label_dir = os.path.join(tree, "KITTI", "object", "training", "label_2")
    os.makedirs(out_dir, exist_ok=True)
    for sid in ids:
        lines = []
        with open(os.path.join(label_dir, "%06d.txt" % sid)) as f:
            for ln in f.read().splitlines():
                v = ln.split()
                if v[0] != "Car":
                    continue
                num = np.array(v[3:15], float)
                num[1:5] += rng.normal(0, 2, 4)      # 2D box
                num[8:11] += rng.normal(0, 0.1, 3)   # location
                num[11] += rng.normal(0, 0.1)        # ry
                lines.append("Car -1 -1 " + " ".join("%.4f" % x for x in num)
                             + " %.4f" % rng.uniform(0.3, 1.0))
        fp = [0.0, 500, 150, 560, 200, 1.5, 1.6, 3.9, 5.0, 1.6, 30.0, 0.3]
        lines.append("Car -1 -1 " + " ".join("%.4f" % x for x in fp) + " 0.2500")
        with open(os.path.join(out_dir, "%06d.txt" % sid), "w") as f:
            f.write("\n".join(lines) + "\n")


def test_kitti_ap_equal(tree, tmp_path, host_ops):
    det = str(tmp_path / "det")
    write_detections(tree, det, seed=5)
    split = os.path.join(tree, "KITTI", "ImageSets", "val.txt")
    labels = os.path.join(tree, "KITTI", "object", "training", "label_2")
    s_t, ap_t = tke.evaluate(labels, det, split)
    s_j, ap_j = jke.evaluate(labels, det, split)
    assert s_t == s_j
    assert ap_t.keys() == ap_j.keys()
    for k in ap_j:
        assert float(ap_t[k]) == float(ap_j[k]), k
    assert ap_t["Car_3d_easy"] > 0 and ap_t["Car_bev_moderate"] > 0
    ids = list(range(4))
    gt_t, gt_j = tke.get_label_annos(labels, ids), jke.get_label_annos(labels, ids)
    dt_t, dt_j = tke.get_label_annos(det, ids), jke.get_label_annos(det, ids)
    c_t, _ = tke.get_coco_eval_result(gt_t, dt_t, [0])
    c_j, _ = jke.get_coco_eval_result(gt_j, dt_j, [0])
    assert c_t == c_j


def test_backup_source_copies_the_port(tmp_path):
    dst = pathlib.Path(snapshot.backup_source(tmp_path / "run"))
    pkg = dst / "pointrcnn_tpu_torch"
    for rel in ("eval/__main__.py", "eval/evaluator.py", "data/rpn_dataset.py",
                "csrc/mlp.cu", "csrc/wgmma.cuh", "csrc/host_ops.cpp"):
        assert (pkg / rel).read_bytes() == (REPO / "pointrcnn_tpu_torch" / rel).read_bytes()
    assert sorted(p.name for p in dst.iterdir()) == ["pointrcnn_tpu_torch"]
    assert not list(pkg.rglob("*.so"))


def test_chip_smoke_kitti_tree(tmp_path):
    """The KITTI tree ``chip_smoke.py`` writes for its eval and train-CLI
    phases (no PIL there): every frame has more valid points than
    ``cfgs/default.yaml`` samples (no padding), labels with 2-4 cars whose
    points lie inside their boxes, a PNG that PIL reads at 1242 x 375, and
    the ``val``, ``train`` and ``smallval`` splits."""
    from PIL import Image

    import chip_smoke

    boxes = chip_smoke.write_kitti_tree(str(tmp_path), frames=3, seed=1)
    ids = ["%06d" % i for i in range(3)]
    for split, want in (("val", ids), ("train", ids), ("smallval", ids[:1])):
        with open(tmp_path / "KITTI" / "ImageSets" / f"{split}.txt") as f:
            assert f.read().split() == want, split
    cfg = load_config(str(_CFG))
    ds = KittiRCNNDataset(str(tmp_path), cfg, npoints=cfg.RPN.NUM_POINTS, split="val",
                          mode="EVAL")
    assert len(ds) == 3
    for sid in range(3):
        calib = ds.get_calib(sid)
        pts = calib.lidar_to_rect(ds.get_lidar(sid)[:, :3])
        img, depth = calib.rect_to_img(pts)
        valid = ds.get_valid_flag(pts, img, depth, ds.get_image_shape(sid))
        assert chip_smoke.FRAME_POINTS - 200 < valid.sum() and valid.sum() > cfg.RPN.NUM_POINTS
        labels = ds.filtrate_objects(ds.get_label(sid))
        assert 2 <= len(labels) <= 4 and len(labels) == len(boxes[sid])
        inside = tnative.points_in_boxes3d(pts[valid], boxes[sid]).sum(1)
        assert (inside >= chip_smoke.FRAME_POINTS // 100).all()
        with Image.open(os.path.join(ds.image_dir, "%06d.png" % sid)) as im:
            im.load()
            assert im.size == (1242, 375)
        sample = ds.getitem(sid, np.random.RandomState(sid))
        assert len(np.unique(sample["pts_rect"], axis=0)) == cfg.RPN.NUM_POINTS
