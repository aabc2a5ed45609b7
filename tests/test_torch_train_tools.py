"""The port's data tools against the JAX package's, on the CPU:

- ``python -m pointrcnn_tpu_torch.tools.generate_gt_database`` gives the
  records of ``tools/generate_gt_database.py`` (field by field; the pickles
  name other classes), and a JAX-made database loads into the port's
  ``Object3d``;
- ``python -m pointrcnn_tpu_torch.tools.generate_aug_scene`` writes the
  files and split lists of ``tools/generate_aug_scene.py``, byte for byte;
- ``pointrcnn_tpu_torch/tools/fixture.py`` writes ``tests/kitti_fixture.py``'s
  files byte for byte, its PNG (zlib, no image library) at PIL's size;
- ``chip_smoke.py``'s train-CLI phase's inputs (its KITTI tree with the
  train and smallval splits, the gt database) through a one-step train CLI
  run with GT_AUG on the CPU;
- ``python -m pointrcnn_tpu_torch.tools.ap_gate`` end to end at one epoch
  a stage (the recipe itself is ``test_torch_ap_gate.py``, slow), and its
  defaults held to ``tools/ap_gate.py``'s.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import pickle
import sys

import numpy as np
import pytest

from pointrcnn_tpu.data import object3d as jobject3d

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.data import object3d as tobject3d
from pointrcnn_tpu_torch.data import rpn_dataset
from pointrcnn_tpu_torch.data.kitti_dataset import png_size
from pointrcnn_tpu_torch.data.rpn_dataset import load_gt_database
from pointrcnn_tpu_torch.tools import ap_gate, fixture, generate_aug_scene, generate_gt_database
from pointrcnn_tpu_torch.train.__main__ import main as train_main

import kitti_fixture
from test_torch_port_slice import TINY, one_torch_thread  # noqa: F401 (fixture)

REPO = pathlib.Path(__file__).resolve().parent.parent
DEFAULT_CFG = str(REPO / "cfgs" / "default.yaml")
PEOPLE = ("Pedestrian", "Cyclist")


def run_tool(monkeypatch, name, argv):
    sys.path.insert(0, str(REPO / "tools"))
    mod = importlib.import_module(name)
    monkeypatch.setattr(sys, "argv", [name + ".py", *argv])
    mod.main()


def _tree(tmp_path, classes):
    root = str(tmp_path / "kitti")
    kitti_fixture.make_mini_kitti(root, num_samples=4, n_points=2500, seed=5, classes=classes,
                                  z_range=(10.0, 30.0))
    return root


@pytest.mark.parametrize("class_name,classes", [("Car", ("Car", "Car")), ("People", PEOPLE)])
def test_gt_database_gives_jax_records(tmp_path, monkeypatch, class_name, classes):
    root = _tree(tmp_path, classes)
    args = ["--data_root", root, "--class_name", class_name]
    run_tool(monkeypatch, "generate_gt_database", args + ["--save_dir", str(tmp_path / "jax")])
    path = generate_gt_database.main(args + ["--save_dir", str(tmp_path / "port")])
    name = f"train_gt_database_level_{class_name}.pkl"
    assert path == str(tmp_path / "port" / name)
    with open(tmp_path / "jax" / name, "rb") as f:
        want = pickle.load(f)
    got = load_gt_database(path)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert (a["sample_id"], a["cls_type"]) == (b["sample_id"], b["cls_type"])
        for k in ("gt_box3d", "points", "intensity"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert type(a["obj"]) is tobject3d.Object3d and type(b["obj"]) is jobject3d.Object3d
        va, vb = vars(a["obj"]), vars(b["obj"])
        assert va.keys() == vb.keys()
        for k in va:
            np.testing.assert_array_equal(va[k], vb[k], err_msg=k)
    # a JAX-made database loads into the port's Object3d
    assert all(type(r["obj"]) is tobject3d.Object3d
               for r in load_gt_database(str(tmp_path / "jax" / name)))


def _files(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(pathlib.Path(root).rglob("*")) if p.is_file()}


def test_generate_aug_scene_matches_tools(tmp_path, monkeypatch):
    root = _tree(tmp_path, ("Car", "Car"))
    db = generate_gt_database.main(["--data_root", root, "--save_dir", str(tmp_path / "db")])
    split_file = os.path.join(root, "KITTI", "ImageSets", "train_aug.txt")
    common = ["--data_root", root, "--gt_database", db, "--aug_times", "2"]
    run_tool(monkeypatch, "generate_aug_scene", common + ["--save_dir", str(tmp_path / "jax")])
    want_split = pathlib.Path(split_file).read_bytes()
    os.remove(split_file)
    ids = generate_aug_scene.main(common + ["--save_dir", str(tmp_path / "port")])
    assert pathlib.Path(split_file).read_bytes() == want_split
    assert want_split.decode().split() == ids and len(ids) == 4 * 3
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got.keys() == want.keys() and len(got) == 2 * 2 * 4 + 1
    assert [k for k in want if got[k] != want[k]] == []


@pytest.mark.parametrize("kwargs", [
    dict(num_samples=3, n_points=2500, seed=1, split="test"),
    dict(num_samples=4, n_points=1100, seed=3, z_range=(10.0, 22.0), x_range=(-5.0, 5.0),
         surface=True, pts_per_obj=300, bg_in_frustum=True, project_box2d=True, classes=PEOPLE),
], ids=["default", "ap_gate_people"])
def test_fixture_matches_kitti_fixture(tmp_path, kwargs):
    from PIL import Image

    r1, b1 = fixture.make_mini_kitti(str(tmp_path / "port"), **kwargs)
    r2, b2 = kitti_fixture.make_mini_kitti(str(tmp_path / "orig"), **kwargs)
    assert b1 == b2
    got, want = _files(r1), _files(r2)
    assert got.keys() == want.keys()
    pngs = [k for k in want if k.endswith(".png")]
    assert len(pngs) == kwargs["num_samples"]
    assert [k for k in want if k not in pngs and got[k] != want[k]] == []
    for k in pngs:
        with Image.open(os.path.join(r2, k)) as im:
            assert png_size(os.path.join(r1, k)) == im.size == (1242, 375)


def test_chip_smoke_train_phase_on_cpu(tmp_path, monkeypatch):
    """The inputs of ``chip_smoke.py``'s ``phase_train_cli``: the KITTI tree
    with its train and smallval splits and the train split's gt database,
    through a one-step rpn run of the train CLI at ``cfgs/default.yaml`` (its
    AUG_DATA and GT_AUG) at TINY widths with the val epoch."""
    import chip_smoke

    data_root, db = chip_smoke.prepare_train_cli(str(tmp_path), frames=4)
    sets = os.path.join(data_root, "KITTI", "ImageSets")
    assert open(os.path.join(sets, "train.txt")).read().split() == ["%06d" % i for i in range(4)]
    assert open(os.path.join(sets, "smallval.txt")).read().split() == ["000000"]
    records = load_gt_database(db)
    assert len(records) >= 8 and all(len(r["points"]) >= 100 for r in records)
    cfg = load_config(DEFAULT_CFG)
    assert (cfg.GT_AUG_ENABLED, cfg.AUG_DATA, cfg.TRAIN.VAL_SPLIT) == (True, True, "smallval")
    loaded = []
    monkeypatch.setattr(rpn_dataset, "load_gt_database",
                        lambda path: loaded.append(path) or load_gt_database(path))
    run = train_main(["--cfg_file", DEFAULT_CFG, "--train_mode", "rpn", "--data_root", data_root,
                      "--gt_database", db, "--batch_size", "4", "--epochs", "1",
                      "--ckpt_save_interval", "1", "--train_with_eval", "--device", "cpu",
                      "--output_dir", str(tmp_path / "rpn"), "--set", *TINY[2:]])
    assert (run.epoch, run.it) == (1, 1)
    (epoch,) = run.history
    assert np.isfinite(epoch["loss"]) and np.isfinite(epoch["val_loss"])
    assert os.path.isfile(os.path.join(run.ckpt_dir, "checkpoint_epoch_1"))
    assert loaded == [db]  # the train set pastes from it, the val set does not


def test_ap_gate_tool_on_cpu(tmp_path, capsys):
    ret = ap_gate.main(["--work", str(tmp_path), "--rpn_epochs", "1", "--rcnn_epochs", "1",
                        "--num_samples", "4", "--batch_size", "2", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed.pop("launches") == dict.fromkeys(ap_gate.launch_counts(), 0)
    assert printed == ret and ret["total_gt_bbox"] == 8 and "Car_3d_easy" in ret
    for stage, epoch in (("rpn", 1), ("rcnn", 1)):
        assert (tmp_path / stage / "ckpt" / f"checkpoint_epoch_{epoch}").is_file()
    assert len(os.listdir(tmp_path / "eval" / "final_result" / "data")) == 4


@pytest.mark.parametrize("flags", [[], ["--striped"], ["--people"]], ids=["car", "striped", "people"])
def test_ap_gate_defaults_equal_the_tools(flags, monkeypatch):
    """Every default of the twin's parser and of its ``run_gate`` is
    ``tools/ap_gate.py``'s (ROADMAP C16: the twin trained the rcnn stage 150
    epochs, the tool 160); only the work directory (the twin writes under
    the port's ``_build``) and the twin's own ``--device`` and ``--seed``
    differ."""
    import inspect

    sys.path.insert(0, str(REPO / "tools"))
    tool = importlib.import_module("ap_gate")
    own = ("work", "device", "seed")

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters.items() if k not in own}

    want_defaults, got_defaults = defaults(tool.run_gate), defaults(ap_gate.run_gate)
    for d in (want_defaults, got_defaults):
        d["cfg_file"] = pathlib.Path(d["cfg_file"]).resolve()
    assert got_defaults == want_defaults and want_defaults["rcnn_epochs"] == 160
    calls = {}

    def recorder(key, fn):
        def run_gate(*args, **kwargs):
            bound = inspect.signature(fn).bind(*args, **kwargs).arguments
            calls[key] = {k: v for k, v in bound.items() if k not in own}
            calls[key]["cfg_file"] = pathlib.Path(calls[key]["cfg_file"]).resolve()
            return {}
        return run_gate

    monkeypatch.setattr(tool, "run_gate", recorder("jax", tool.run_gate))
    monkeypatch.setattr(sys, "argv", ["ap_gate.py", *flags])
    tool.main()
    monkeypatch.setattr(ap_gate, "run_gate", recorder("port", ap_gate.run_gate))
    ap_gate.main(flags)
    assert calls["port"] == calls["jax"] and calls["jax"]["rcnn_epochs"] == 160
