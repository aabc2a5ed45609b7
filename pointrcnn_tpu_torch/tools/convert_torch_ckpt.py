"""Convert a reference PointRCNN checkpoint (``PointRCNN.pth``, the
reference's ``torch.save`` of ``{model_state, optimizer_state, epoch, it}``)
into a port checkpoint (counterpart of ``tools/convert_torch_ckpt.py``):

    python -m pointrcnn_tpu_torch.tools.convert_torch_ckpt --torch_ckpt PointRCNN.pth \
        --cfg_file cfgs/default.yaml --out converted_ckpt [--set KEY VALUE ...]

The reference's module tree (``SA_modules.k.mlps.j.layer{i}.conv/bn.bn``,
``rpn_cls_layer.{0,2}``, ...) maps onto the flax-named tree of the JAX
package, which :func:`pointrcnn_tpu_torch.convert.load_jax_variables` loads
into the port's model; the result is written by
``train.checkpoint.save_checkpoint`` as ``<out>/checkpoint_epoch_<epoch>``,
which the eval CLI's ``--ckpt`` and ``--rcnn_ckpt`` and the train CLI's
``--rpn_ckpt`` load.  As the JAX tool does, :func:`main` converts a joint
model (``RPN.ENABLED`` and ``RCNN.ENABLED`` forced True) and exits 1 on any
problem of the strict check against the port's own model, so an rpn-only
``.pth`` (no ``rcnn_net.*``) fails there; :func:`convert_state_dict` alone
converts it.

The conversion functions are copies of the JAX tool's, numpy only
(``tests/test_torch_convert_ckpt.py`` holds them text-equal).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _conv_w(t):
    """torch conv (out, in, 1[, 1]) -> dense kernel (in, out)."""
    a = np.asarray(t, dtype=np.float32)
    a = a.reshape(a.shape[0], a.shape[1])
    return a.T.copy()


def _vec(t):
    return np.asarray(t, dtype=np.float32).reshape(-1)


def _shared_mlp_entries(sd, prefix, n_layers, bn):
    """Reference SharedMLP/pt_utils layer{i} -> our SharedMLP params/stats."""
    params, stats = {}, {}
    for i in range(n_layers):
        base = f"{prefix}.layer{i}"
        params[f"w{i}"] = _conv_w(sd[f"{base}.conv.weight"])
        if bn:
            params[f"bn{i}_scale"] = _vec(sd[f"{base}.bn.bn.weight"])
            params[f"bn{i}_bias"] = _vec(sd[f"{base}.bn.bn.bias"])
            stats[f"bn{i}_mean"] = _vec(sd[f"{base}.bn.bn.running_mean"])
            stats[f"bn{i}_var"] = _vec(sd[f"{base}.bn.bn.running_var"])
        else:
            params[f"b{i}"] = _vec(sd[f"{base}.conv.bias"])
    return params, stats


def _head_entries(sd, prefix, hidden_count, bn, dropout=True):
    """Reference head Sequential -> our HeadMLP (ConvBN_i + final Dense_0).

    The reference builds [Conv1d x hidden, Conv1d final] and then, when
    DP_RATIO >= 0, ``insert(1, Dropout)`` (lib/net/rpn.py:21-28,
    lib/net/rcnn_net.py:46-54): with dropout the hidden convs sit at
    Sequential indices 0, 2, 3, ..., hidden and the FINAL conv at
    hidden+1 — including the hidden_count==1 case ([C0, D, Cf] -> final
    at 2, cf. the init_weights reference to rpn_cls_layer[2])."""
    params: dict = {}
    stats: dict = {}
    if dropout:
        torch_idx = [0] + [i + 2 for i in range(hidden_count - 1)]
        final_idx = hidden_count + 1 if hidden_count > 0 else 0
    else:
        torch_idx = list(range(hidden_count))
        final_idx = hidden_count
    for our_i, ti in enumerate(torch_idx):
        cp = {"Dense_0": {"kernel": _conv_w(sd[f"{prefix}.{ti}.conv.weight"])}}
        if bn:
            cs = {
                "BatchNorm_0": {
                    "scale": _vec(sd[f"{prefix}.{ti}.bn.bn.weight"]),
                    "bias": _vec(sd[f"{prefix}.{ti}.bn.bn.bias"]),
                }
            }
            stats[f"ConvBN_{our_i}"] = {
                "BatchNorm_0": {
                    "mean": _vec(sd[f"{prefix}.{ti}.bn.bn.running_mean"]),
                    "var": _vec(sd[f"{prefix}.{ti}.bn.bn.running_var"]),
                }
            }
        else:
            cs = {}
            cp["Dense_0"]["bias"] = _vec(sd[f"{prefix}.{ti}.conv.bias"])
        params[f"ConvBN_{our_i}"] = {**cp, **cs}
    params["Dense_0"] = {
        "kernel": _conv_w(sd[f"{prefix}.{final_idx}.conv.weight"]),
        "bias": _vec(sd[f"{prefix}.{final_idx}.conv.bias"]),
    }
    return params, stats


def convert_state_dict(sd: dict, cfg) -> tuple[dict, dict]:
    """torch state_dict -> (params, batch_stats) pytrees."""
    params: dict = {}
    stats: dict = {}

    if cfg.RPN.ENABLED:
        rpn_p: dict = {"Pointnet2MSG_0": {}}
        rpn_s: dict = {"Pointnet2MSG_0": {}}
        n_sa = len(cfg.RPN.SA_CONFIG.NPOINTS)
        for k in range(n_sa):
            sa_p, sa_s = {}, {}
            for j in range(len(cfg.RPN.SA_CONFIG.MLPS[k])):
                n_layers = len(cfg.RPN.SA_CONFIG.MLPS[k][j])
                p, s = _shared_mlp_entries(
                    sd, f"rpn.backbone_net.SA_modules.{k}.mlps.{j}",
                    n_layers, cfg.RPN.USE_BN,
                )
                sa_p[f"SharedMLP_{j}"] = p
                sa_s[f"SharedMLP_{j}"] = s
            rpn_p["Pointnet2MSG_0"][f"SetAbstractionMSG_{k}"] = sa_p
            rpn_s["Pointnet2MSG_0"][f"SetAbstractionMSG_{k}"] = sa_s
        n_fp = len(cfg.RPN.FP_MLPS)
        for n in range(n_fp):
            # our FeaturePropagation_n was built from fp_mlps[-1-n]
            ref_k = n_fp - 1 - n
            p, s = _shared_mlp_entries(
                sd, f"rpn.backbone_net.FP_modules.{ref_k}.mlp",
                len(cfg.RPN.FP_MLPS[ref_k]), cfg.RPN.USE_BN,
            )
            rpn_p["Pointnet2MSG_0"][f"FeaturePropagation_{n}"] = {"SharedMLP_0": p}
            rpn_s["Pointnet2MSG_0"][f"FeaturePropagation_{n}"] = {"SharedMLP_0": s}

        for head, ref_name, fcs in (
            ("cls_head", "rpn.rpn_cls_layer", cfg.RPN.CLS_FC),
            ("reg_head", "rpn.rpn_reg_layer", cfg.RPN.REG_FC),
        ):
            p, s = _head_entries(sd, ref_name, len(fcs), cfg.RPN.USE_BN,
                                 dropout=cfg.RPN.DP_RATIO >= 0)
            rpn_p[head] = p
            if s:
                rpn_s[head] = s
        params["rpn"] = rpn_p
        stats["rpn"] = rpn_s

    if cfg.RCNN.ENABLED and any(key.startswith("rcnn_net.") for key in sd):
        rc_p: dict = {}
        rc_s: dict = {}
        if cfg.RCNN.USE_RPN_FEATURES:
            for name, n_layers in (
                ("xyz_up_layer", len(cfg.RCNN.XYZ_UP_LAYER)),
                ("merge_down_layer", 1),
            ):
                p, s = _shared_mlp_entries(
                    sd, f"rcnn_net.{name}", n_layers, cfg.RCNN.USE_BN
                )
                rc_p[name] = p
                if s:
                    rc_s[name] = s
        for k in range(len(cfg.RCNN.SA_CONFIG.NPOINTS)):
            p, s = _shared_mlp_entries(
                sd, f"rcnn_net.SA_modules.{k}.mlps.0",
                len(cfg.RCNN.SA_CONFIG.MLPS[k]), cfg.RCNN.USE_BN,
            )
            rc_p[f"SetAbstraction_{k}"] = {"SharedMLP_0": p}
            if s:
                rc_s[f"SetAbstraction_{k}"] = {"SharedMLP_0": s}
        for head, ref_name, fcs in (
            ("cls_head", "rcnn_net.cls_layer", cfg.RCNN.CLS_FC),
            ("reg_head", "rcnn_net.reg_layer", cfg.RCNN.REG_FC),
        ):
            p, s = _head_entries(sd, ref_name, len(fcs), cfg.RCNN.USE_BN,
                                 dropout=cfg.RCNN.DP_RATIO >= 0)
            rc_p[head] = p
            if s:
                rc_s[head] = s
        params["rcnn_net"] = rc_p
        if rc_s:
            stats["rcnn_net"] = rc_s
    return params, stats


def verify_against_template(converted, template, path=""):
    """Strict shape check of the converted tree against a freshly-initialized
    model's tree; returns a list of problems."""
    problems = []
    t_keys = set(template)
    c_keys = set(converted)
    for k in t_keys - c_keys:
        problems.append(f"missing {path}/{k}")
    for k in c_keys - t_keys:
        problems.append(f"unexpected {path}/{k}")
    for k in t_keys & c_keys:
        t, c = template[k], converted[k]
        if isinstance(t, dict):
            problems += verify_against_template(c, t, f"{path}/{k}")
        else:
            if tuple(np.shape(c)) != tuple(np.shape(t)):
                problems.append(
                    f"shape mismatch {path}/{k}: {np.shape(c)} vs {np.shape(t)}"
                )
    return problems


def flax_tree(model) -> tuple[dict, dict]:
    """The port model's tensors as the flax-named trees that
    ``load_jax_variables`` takes -> (params, batch_stats) of numpy arrays:
    parameters and buffers by module path, a Dense ``weight`` (out, in) as
    its ``kernel`` (in, out)."""
    trees = ({}, {})
    for tree, named in zip(trees, (model.named_parameters(), model.named_buffers())):
        for key, t in named:
            *mods, name = key.split(".")
            a = t.detach().cpu().numpy()
            if name == "weight":
                name, a = "kernel", a.T
            node = tree
            for m in mods:
                node = node.setdefault(m, {})
            node[name] = a
    return trees


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--torch_ckpt", required=True)
    ap.add_argument("--cfg_file", default="cfgs/default.yaml")
    ap.add_argument("--out", required=True)
    ap.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    import torch

    from pointrcnn_tpu_torch.config import load_config, merge_from_list
    from pointrcnn_tpu_torch.convert import load_jax_variables
    from pointrcnn_tpu_torch.train.checkpoint import save_checkpoint
    from pointrcnn_tpu_torch.train.optimizer import build_optimizer
    from pointrcnn_tpu_torch.train.state import create_train_state

    cfg = load_config(args.cfg_file, args.set_cfgs)
    cfg = merge_from_list(cfg, ["RPN.ENABLED", "True", "RCNN.ENABLED", "True"])

    # a torch.save of plain containers, tensors and numbers (the reference's
    # checkpoint_state) loads with weights_only=True
    ckpt = torch.load(args.torch_ckpt, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state", ckpt)
    epoch = int(ckpt.get("epoch", 0))
    params, stats = convert_state_dict(sd, cfg)

    # the template: the port's own model, on the CPU
    state = create_train_state(cfg, build_optimizer(cfg, 1, 1), seed=0, device="cpu")
    t_params, t_stats = flax_tree(state.model)
    problems = verify_against_template(params, t_params)
    problems += verify_against_template(stats, t_stats)
    if problems:
        print("conversion problems:")
        for p in problems:
            print(" ", p)
        sys.exit(1)

    load_jax_variables(state.model, {"params": params, "batch_stats": stats})
    path = save_checkpoint(args.out, state, epoch, int(ckpt.get("it", 0)))
    print(f"converted -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
