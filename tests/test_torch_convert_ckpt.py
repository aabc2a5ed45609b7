"""The port's reference-checkpoint import
(``pointrcnn_tpu_torch/tools/convert_torch_ckpt.py``) against the JAX
package's ``tools/convert_torch_ckpt.py``, on the CPU.

- Reference-named state dicts come from
  ``tests/test_torch_convert.py::build_torch_like_sd`` on seeded flax
  weights (a joint model, its rpn-only half, ``RCNN.USE_RPN_FEATURES``
  False).  The port's ``convert_state_dict`` gives JAX's trees array for
  array (exact), and ``verify_against_template`` the same problems for a
  bad shape, a missing key and an unexpected one; the port's template (its
  own model's flax-named tree) equals the shapes of JAX's.
- A TEST forward from the converted weights against JAX's from its own
  conversion, in the exact f32 setting, to the slice tests' ``F32_TOL``
  with every decision equal.
- The CLI end to end: a ``torch.save`` of ``{model_state, optimizer_state,
  epoch, it}`` (an Adam state dict included) loads with
  ``weights_only=True``; the port's ``main`` writes a port checkpoint whose
  parameters equal those of JAX's ``main`` restored from its orbax
  checkpoint; the port's eval CLI loads it with ``--ckpt`` and
  ``--rcnn_ckpt`` (``--device cpu``), the train CLI with ``--rpn_ckpt``.
  An rpn-only ``.pth`` exits 1 from both ``main``s.
- The TPU record (ROADMAP C17): JAX's TPU-trained striped AP-gate weights
  (``output/ap_gate_striped_tpu/rcnn/ckpt/checkpoint_epoch_160``, orbax)
  restored on the CPU and converted afresh equal the committed port
  checkpoint; slow: the port's eval of it scores the re-anchor's Car 3d
  easy AP.
"""

from __future__ import annotations

import copy
import importlib
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp

from pointrcnn_tpu.config import load_config as jax_load_config

from pointrcnn_tpu_torch.config import load_config
from pointrcnn_tpu_torch.convert import load_jax_variables
from pointrcnn_tpu_torch.entry import synthetic_cloud
from pointrcnn_tpu_torch.eval.__main__ import main as eval_main
from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN
from pointrcnn_tpu_torch.tools import convert_torch_ckpt as tcvt
from pointrcnn_tpu_torch.tools import eval_tpu_record
from pointrcnn_tpu_torch.tools.ap_gate import AP_CFG, STRIPED_SET
from pointrcnn_tpu_torch.train.__main__ import main as train_main
from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
from pointrcnn_tpu_torch.train.state import TrainState

import test_torch_port_slice as slice_tests
from kitti_fixture import make_mini_kitti
from test_torch_convert import build_torch_like_sd, cvt as jcvt
from test_torch_port_slice import F32_TOL, _close, one_torch_thread  # noqa: F401 (fixture)
from test_torch_train_step import _port_names

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY_CFG = str(REPO / "tests" / "cfgs_tiny.yaml")
KINDS = ("joint", "rpn_only", "no_rpn_features")
VERBATIM_FUNCTIONS = ("_conv_w", "_vec", "_shared_mlp_entries", "_head_entries",
                      "convert_state_dict", "verify_against_template")


def _init(cfg, seed=0):
    """Seeded flax variables of JAX's TEST model -> numpy trees."""
    from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN

    jm = JaxPointRCNN(cfg=cfg, mode="TEST")
    pts = synthetic_cloud(1, cfg.RPN.NUM_POINTS, seed=seed)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, {"pts_input": jnp.asarray(pts)},
                train=False)
    return jax.device_get(v["params"]), jax.device_get(v.get("batch_stats", {}))


def reference_sd(params, stats, cfg, kind):
    """A reference-named state dict of ``params``/``stats`` for ``kind``."""
    if kind == "no_rpn_features":
        # build_torch_like_sd writes the up/merge layers unconditionally: give
        # it stand-ins and drop what it wrote for them
        rc = dict(params["rcnn_net"])
        stand_in = {"w0": np.zeros((1, 1), np.float32), "b0": np.zeros(1, np.float32)}
        rc.update(xyz_up_layer=stand_in, merge_down_layer=stand_in)
        sd = build_torch_like_sd({**params, "rcnn_net": rc}, stats, cfg)
        return {k: v for k, v in sd.items()
                if not k.startswith(("rcnn_net.xyz_up_layer.", "rcnn_net.merge_down_layer."))}
    sd = build_torch_like_sd(params, stats, cfg)
    if kind == "rpn_only":
        sd = {k: v for k, v in sd.items() if k.startswith("rpn.")}
    return sd


def _cfgs(kind, extra=()):
    over = ["RCNN.ENABLED", "True", *extra]
    if kind == "no_rpn_features":
        over += ["RCNN.USE_RPN_FEATURES", "False"]
    return load_config(TINY_CFG, over), jax_load_config(TINY_CFG, over)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert set(g) == set(w)
    for path, a in w.items():
        assert np.asarray(g[path]).dtype == np.asarray(a).dtype, path
        np.testing.assert_array_equal(g[path], a, err_msg=str(path))


@pytest.mark.parametrize("name", VERBATIM_FUNCTIONS)
def test_functions_are_copies(name):
    """Each conversion function is JAX's, text for text."""
    import ast

    def source(path):
        text = path.read_text()
        return {n.name: ast.get_source_segment(text, n) for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef)}

    port = source(REPO / "pointrcnn_tpu_torch" / "tools" / "convert_torch_ckpt.py")
    jax_tool = source(REPO / "tools" / "convert_torch_ckpt.py")
    assert port[name] == jax_tool[name]


@pytest.mark.parametrize("kind", KINDS)
def test_convert_state_dict_equals_jax(kind):
    tcfg, jcfg = _cfgs(kind)
    params, stats = _init(jcfg)
    sd = reference_sd(params, stats, jcfg, kind)
    got, want = tcvt.convert_state_dict(sd, tcfg), jcvt.convert_state_dict(sd, jcfg)
    for g, w in zip(got, want):
        _assert_trees_equal(g, w)
    if kind == "rpn_only":
        assert set(got[0]) == {"rpn"}
    else:
        # the conversion gives back the weights it was built from
        _assert_trees_equal(got[0], params)
        _assert_trees_equal(got[1], stats)
        assert ("xyz_up_layer" in got[0]["rcnn_net"]) == (kind == "joint")
    # the port's template has JAX's shapes
    t_params, t_stats = tcvt.flax_tree(PointRCNN(tcfg, generator=torch.Generator().manual_seed(0)))
    if kind != "rpn_only":
        assert tcvt.verify_against_template(t_params, params) == []
        assert tcvt.verify_against_template(params, t_params) == []
        assert tcvt.verify_against_template(t_stats, stats) == []


@pytest.mark.parametrize("fault", ["bad_shape", "missing", "unexpected", "rpn_only"])
def test_verify_reports_the_same_problems(fault):
    tcfg, jcfg = _cfgs("joint")
    params, stats = _init(jcfg)
    template, _ = tcvt.flax_tree(PointRCNN(tcfg, generator=torch.Generator().manual_seed(0)))
    bad = copy.deepcopy(tcvt.convert_state_dict(reference_sd(params, stats, jcfg, "joint"),
                                                tcfg)[0])
    if fault == "bad_shape":
        bad["rcnn_net"]["cls_head"]["Dense_0"]["bias"] = np.zeros(3, np.float32)
    elif fault == "missing":
        del bad["rpn"]["reg_head"]["Dense_0"]["kernel"]
    elif fault == "unexpected":
        bad["rcnn_net"]["extra"] = {"w0": np.zeros((2, 2), np.float32)}
    else:
        del bad["rcnn_net"]
    got = tcvt.verify_against_template(bad, template)
    want = jcvt.verify_against_template(bad, jax.device_get(params))
    assert got and sorted(got) == sorted(want)


@pytest.mark.parametrize("kind", ["joint", "no_rpn_features"])
def test_converted_forward_equals_jax(kind, monkeypatch):
    """The TEST forward of the port from its conversion against JAX's from
    its own, exact methods in f32 (``test_torch_port_slice``'s setting)."""
    from pointrcnn_tpu.models.point_rcnn import PointRCNN as JaxPointRCNN

    extra = ["RCNN.USE_RPN_FEATURES", "False"] if kind == "no_rpn_features" else []
    cfg = load_config(str(slice_tests._CFG), slice_tests.EXACT_OVERRIDES + slice_tests.TINY
                      + ["COMPUTE_DTYPE", "float32"] + extra)
    jcfg = jax_load_config(str(slice_tests._CFG), slice_tests.EXACT_OVERRIDES + slice_tests.TINY
                           + ["COMPUTE_DTYPE", "float32"] + extra)
    pts = synthetic_cloud(2, cfg.RPN.NUM_POINTS, seed=3)
    params, stats = _init(jcfg, seed=5)
    sd = reference_sd(params, stats, jcfg, kind)
    tp, ts = tcvt.convert_state_dict(sd, cfg)
    jp, js = jcvt.convert_state_dict(sd, jcfg)
    tm = PointRCNN(cfg, generator=torch.Generator().manual_seed(0)).eval()
    load_jax_variables(tm, {"params": tp, "batch_stats": ts})
    jm = JaxPointRCNN(cfg=jcfg, mode="TEST")
    monkeypatch.setattr(slice_tests, "_models",
                        lambda c, p: (jm, {"params": jp, "batch_stats": js}, tm))
    jo, to, jlog, tlog, _, _ = slice_tests._run_both(monkeypatch, cfg, pts)
    np.testing.assert_array_equal(to["backbone_xyz"], jo["backbone_xyz"])
    for key in ("fps", "bq"):
        assert len(tlog[key]) == len(jlog[key]) == 5
        for t_outs, j_outs in zip(tlog[key], jlog[key]):
            for a, b in zip(t_outs, j_outs):
                np.testing.assert_array_equal(a, b)
    for k in ("roi_valid", "pooled_empty_flag", "seg_result"):
        np.testing.assert_array_equal(to[k], jo[k])
    np.testing.assert_allclose(to["rois"], jo["rois"], rtol=0, atol=F32_TOL)
    for k in ("rpn_cls", "rpn_reg", "backbone_features", "rcnn_cls", "rcnn_reg"):
        _close(to[k], jo[k], F32_TOL)


def save_pth(path, params, stats, cfg, kind, epoch=7, it=70):
    """A ``torch.save`` of the reference's checkpoint dict: torch tensors
    under ``model_state``, an Adam ``optimizer_state``, ``epoch``, ``it``."""
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in reference_sd(params, stats, cfg, kind).items()}
    w = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([w], lr=0.002, betas=(0.9, 0.99))
    w.sum().backward()
    opt.step()
    torch.save({"epoch": epoch, "it": it, "model_state": sd,
                "optimizer_state": opt.state_dict()}, path)
    return path


def _jax_main(monkeypatch, argv):
    sys.path.insert(0, str(REPO / "tools"))
    tool = importlib.import_module("convert_torch_ckpt")
    monkeypatch.setattr(sys, "argv", ["convert_torch_ckpt.py", *argv])
    tool.main()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti_convert"))
    make_mini_kitti(root, num_samples=4, n_points=2500, seed=3)
    return root


def test_cli_end_to_end(tree, tmp_path, monkeypatch):
    tcfg, jcfg = _cfgs("joint")
    params, stats = _init(jcfg, seed=2)
    pth = save_pth(str(tmp_path / "PointRCNN.pth"), params, stats, jcfg, "joint")
    assert set(torch.load(pth, weights_only=True)) == {"epoch", "it", "model_state",
                                                       "optimizer_state"}
    path = tcvt.main(["--torch_ckpt", pth, "--cfg_file", TINY_CFG, "--out",
                      str(tmp_path / "port")])
    assert path == str(tmp_path / "port" / "checkpoint_epoch_7")
    _jax_main(monkeypatch, ["--torch_ckpt", pth, "--cfg_file", TINY_CFG, "--out",
                            str(tmp_path / "jax")])
    got = torch.load(path, weights_only=True)
    want = ocp.PyTreeCheckpointer().restore(str(tmp_path / "jax" / "checkpoint_epoch_7"))
    assert got["meta"] == {"epoch": 7, "it": 70} and got["step"] == int(want["step"]) == 0
    for coll in ("params", "batch_stats"):
        names = _port_names(want[coll])
        assert set(names) == set(got[coll])
        for k, a in names.items():
            np.testing.assert_array_equal(got[coll][k].numpy(), a, err_msg=k)

    common = ["--cfg_file", TINY_CFG, "--data_root", tree, "--batch_size", "2",
              "--workers", "1", "--device", "cpu"]
    ret = eval_main(common + ["--eval_mode", "rcnn", "--ckpt", path, "--output_dir",
                              str(tmp_path / "eval")])
    assert "Car_3d_easy" in ret and np.isfinite(ret["recall_0.7"])
    part = eval_main(common + ["--eval_mode", "rcnn", "--rpn_ckpt", path, "--rcnn_ckpt", path,
                               "--output_dir", str(tmp_path / "eval_part")])
    assert {k: float(v) for k, v in part.items()} == {k: float(v) for k, v in ret.items()}
    run = train_main(common + ["--train_mode", "rcnn", "--rpn_ckpt", path, "--epochs", "1",
                               "--ckpt_save_interval", "1", "--output_dir",
                               str(tmp_path / "train")])
    trained = torch.load(os.path.join(run.ckpt_dir, "checkpoint_epoch_1"), weights_only=True)
    # the fixed RPN started from the converted weights: the tiny config's
    # optimizer has no weight decay, so it has not moved
    for k, v in got["params"].items():
        if k.startswith("rpn."):
            assert torch.equal(trained["params"][k], v), k


def test_cli_no_rpn_features(tmp_path):
    """``--set RCNN.USE_RPN_FEATURES False`` converts a model without the up
    and merge layers; the eval CLI loads it under the same setting."""
    tcfg, jcfg = _cfgs("no_rpn_features")
    params, stats = _init(jcfg, seed=4)
    pth = save_pth(str(tmp_path / "p.pth"), params, stats, jcfg, "no_rpn_features", epoch=3)
    path = tcvt.main(["--torch_ckpt", pth, "--cfg_file", TINY_CFG, "--out", str(tmp_path / "o"),
                      "--set", "RCNN.USE_RPN_FEATURES", "False"])
    got = torch.load(path, weights_only=True)["params"]
    assert not any(".xyz_up_layer." in k or ".merge_down_layer." in k for k in got)
    for k, a in _port_names(params).items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)


def test_cli_rpn_only_exits_1(tmp_path, monkeypatch, capsys):
    """An rpn-only ``.pth`` (no ``rcnn_net.*``): JAX's ``main`` forces the
    RCNN on and exits 1 on the missing subtree; so does the port's, with the
    same report (ROADMAP C19: recorded, no rpn-only mode added)."""
    _, jcfg = _cfgs("joint")
    params, stats = _init(jcfg, seed=1)
    pth = save_pth(str(tmp_path / "rpn.pth"), params, stats, jcfg, "rpn_only")
    argv = ["--torch_ckpt", pth, "--cfg_file", TINY_CFG]
    with pytest.raises(SystemExit) as port_exit:
        tcvt.main(argv + ["--out", str(tmp_path / "port")])
    port_out = capsys.readouterr().out
    with pytest.raises(SystemExit) as jax_exit:
        _jax_main(monkeypatch, argv + ["--out", str(tmp_path / "jax")])
    jax_out = capsys.readouterr().out
    assert port_exit.value.code == jax_exit.value.code == 1
    assert "missing /rcnn_net" in port_out and port_out == jax_out
    assert not (tmp_path / "port").exists()


# ------------------------------------------------------------ the TPU record

TPU_RECORD = REPO / "output" / "ap_gate_striped_tpu" / "rcnn" / "ckpt" / "checkpoint_epoch_160"


def restore_on_cpu(path) -> dict:
    """An orbax checkpoint saved on a TPU, restored on the CPU: every array
    gets a ``SingleDeviceSharding`` restore argument (the default asks for
    the device it was saved from)."""
    ckptr = ocp.PyTreeCheckpointer()
    tree = ckptr.metadata(str(path)).item_metadata.tree
    sharding = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    args = jax.tree_util.tree_map(lambda _: ocp.ArrayRestoreArgs(sharding=sharding), tree)
    return jax.device_get(ckptr.restore(str(path), args=ocp.args.PyTreeRestore(restore_args=args)))


def convert_tpu_record(out_root) -> str:
    """The TPU record as a port checkpoint under ``out_root``: its
    parameters and BN statistics, no optimizer state, its epoch and
    iteration (how ``eval_tpu_record.RECORD_CKPT`` was written)."""
    r = restore_on_cpu(TPU_RECORD)
    cfg = load_config(AP_CFG, STRIPED_SET + ["RPN.ENABLED", "True", "RCNN.ENABLED", "True"])
    model = PointRCNN(cfg, generator=torch.Generator().manual_seed(0))
    load_jax_variables(model, {"params": r["params"], "batch_stats": r["batch_stats"]})
    state = TrainState(step=int(r["step"]), model=model, opt_state={})
    return save_checkpoint(str(out_root), state, int(r["meta"]["epoch"]), int(r["meta"]["it"]))


def test_tpu_record_conversion_equals_committed(tmp_path):
    fresh = torch.load(convert_tpu_record(tmp_path), weights_only=True)
    committed = torch.load(eval_tpu_record.RECORD_CKPT, weights_only=True)
    assert fresh["meta"] == committed["meta"] == {"epoch": 160, "it": 960}
    assert fresh["step"] == committed["step"] and committed["opt_state"] == {}
    for coll in ("params", "batch_stats"):
        assert fresh[coll].keys() == committed[coll].keys()
        for k, v in committed[coll].items():
            assert torch.equal(fresh[coll][k], v), k
    assert sum(v.numel() for v in committed["params"].values()) == 53404


@pytest.mark.slow
def test_tpu_record_eval_scores_the_reanchor(tmp_path):
    """The port's eval of JAX's TPU weights on the CPU: the re-anchor's Car
    3d easy AP 89.72 (bev 90.91), 47 boxes of 48 gt (ROADMAP C17)."""
    ret = eval_tpu_record.run(str(tmp_path / "work"), device="cpu")
    assert ret["Car_3d_easy"] == pytest.approx(89.72, abs=0.01), ret
    assert ret["Car_bev_easy"] == pytest.approx(90.91, abs=0.01), ret
    assert (ret["final_total"], ret["total_gt_bbox"]) == (47, 48), ret
