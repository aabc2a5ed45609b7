"""The output check: what the timed path produced against the plain reference.

The reference (``benchmark/reference``) is a frozen copy of the model's
mathematics on plain PyTorch paths; it imports nothing of the program and
takes the benchmark's weights and host batches, never anything the program
made from them.  Each number below has a limit in ``limits/<cell>.json``.

Eval (batches of the window drawn from the seed).  The reference follows
the program stage by stage from the program's own outputs, since a
discrete choice (an NMS survivor, a score near a threshold) that rounding
flips would part the two runs for good:

- ``rpn_rel``: the RPN's per-point outputs (``rpn_cls``, ``rpn_reg``,
  ``backbone_features``) on the batch, the reference's own RPN forward
  against the program's: the largest gap over the output's largest
  magnitude;
- ``proposal_mismatch``: roi slots (of B x M) whose box or validity differs
  between the program's proposals and the reference's proposal layer run
  on the program's RPN outputs;
- ``rcnn_rel``: ``rcnn_cls`` / ``rcnn_reg`` of the reference's roipool,
  canonical transform and RCNN on the program's rois and RPN outputs;
- ``post_box_rel`` and ``post_sel_mismatch``: the refined boxes (largest gap
  over their largest magnitude) and the final NMS's survivors (slots that
  differ) of the reference's post-process on the program's RCNN outputs.

Training (the first ``CHECK_STEPS`` steps, run at set-up through the
window's own call on distinct batches; the reference runs them from the
same weights, batches and step seed):

- ``loss_rel``: each step's loss, the largest gap over the reference's;
- ``grad1_leaf``: the first gradient as the optimizer got it (Adam's first
  moment after one step, ``(1 - b1) g``, the same factor on both sides),
  by the worst leaf: the gap between the two norms over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update3_leaf``: the parameters' change over the steps, by the worst
  leaf the same way, leaving out the leaves whose reference gradient is
  under a thousandth of the median leaf's (they move by round-off alone).
  A median is over the leaves with a gradient: a fixed RPN's have none.

In the rcnn stage the reference's step takes the program's proposals, since
a flipped NMS survivor would part the two steps for good; its start and
the stages it skips are compared on the way: ``rpn_rel`` (the fixed RPN's
scores and boxes), ``proposal_mismatch`` (its proposal layer on the
program's RPN outputs) and ``target_mismatch`` (the target layer's sampled
rois, labels and regression masks: rois of B x ROI_PER_IMAGE that differ).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under one scale for the tensor (its
    largest magnitude at e4m3's largest), back in ``x``'s dtype."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return ((xf * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale).to(x.dtype)


class LowerPrecision(TorchFunctionMode):
    """The control's arithmetic: wherever the reference rounds a float
    tensor to the configuration's bf16, it first rounds it to fp8 e4m3
    (the nearest precision below), scaled per tensor."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.to and args and isinstance(args[0], torch.Tensor):
            target = kwargs.get("dtype")
            if target is None:
                target = next((a for a in args[1:] if isinstance(a, torch.dtype)), None)
            x = args[0]
            if target == torch.bfloat16 and x.is_floating_point() \
                    and x.dtype != torch.bfloat16 and x.numel():
                args = (_fp8(x), *args[1:])
        return func(*args, **kwargs)


def bf16_inputs(fn):
    """``fn`` computed from its float tensor arguments rounded to bf16: the
    control of a stage the configuration runs in f32 (the proposal layer,
    the target layer, the post-process), the nearest precision below."""

    def rnd(a):
        if isinstance(a, dict):
            return {k: rnd(v) for k, v in a.items()}
        if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
            return a.to(torch.bfloat16).to(torch.float32)
        return a

    def lowered(*a, **kw):
        return fn(*(rnd(x) for x in a), **{k: rnd(v) for k, v in kw.items()})

    return lowered


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The largest gap over the reference's largest magnitude."""
    p, r = p.to(torch.float32), r.to(torch.float32)
    if p.shape != r.shape:
        return float("inf")
    if not bool(torch.isfinite(p).all()):
        return float("inf")
    return float((p - r).abs().max() / r.abs().max().clamp(min=1e-30))


# ---------------------------------------------------------------- eval


def ref_config(cell_cfg_path, overrides):
    from benchmark.reference.config import load_config

    return load_config(str(cell_cfg_path), list(overrides))


def ref_eval_model(cfg, state: dict, device):
    from benchmark.harness import weights
    from benchmark.reference.models.point_rcnn import PointRCNN

    model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    weights.load(model, state)
    return model


def _rcnn_from(model, cfg, rpn: dict):
    """The reference's RCNN stage of the eval forward (roipool, canonical
    transform, RCNN) on given RPN outputs and rois."""
    from benchmark.reference.models.point_rcnn import canonical_transform
    from benchmark.reference.ops.common import sqrt_rn
    from benchmark.reference.ops.roipool3d import roipool3d

    xyz, feats, rois = rpn["backbone_xyz"], rpn["backbone_features"], rpn["rois"]
    seg_mask = (torch.sigmoid(rpn["rpn_cls"][..., 0]) > cfg.RPN.SCORE_THRESH).to(torch.float32)
    depth = sqrt_rn(xyz[..., 0] * xyz[..., 0] + xyz[..., 1] * xyz[..., 1]
                    + xyz[..., 2] * xyz[..., 2])
    extra = [seg_mask[..., None]]
    if cfg.RCNN.USE_DEPTH:
        extra.append((depth / 70.0 - 0.5)[..., None])
    pts_feature = torch.cat(extra + [feats], dim=-1)
    pooled, _ = roipool3d(xyz, pts_feature, rois, cfg.RCNN.POOL_EXTRA_WIDTH,
                          cfg.RCNN.NUM_POINTS, method=cfg.RCNN.ROIPOOL_METHOD)
    pooled = torch.cat([canonical_transform(pooled[..., 0:3], rois), pooled[..., 3:]], dim=-1)
    B, M = rois.shape[0], rois.shape[1]
    return model.rcnn_net(pooled.reshape(B * M, cfg.RCNN.NUM_POINTS, -1))


def _proposals(cfg, rpn: dict):
    from benchmark.reference.models.proposal import proposal_layer

    return proposal_layer(cfg, "TEST", rpn["rpn_cls"][..., 0], rpn["rpn_reg"],
                          rpn["backbone_xyz"])


def _post(cfg, rec: dict, gt):
    from benchmark.reference.postprocess import joint_postprocess

    keys = ("rois", "roi_scores_raw", "roi_valid", "seg_result", "rcnn_cls", "rcnn_reg",
            "rpn_cls", "backbone_xyz", "backbone_features")
    return joint_postprocess(cfg, {k: rec[k] for k in keys}, gt)


def eval_outputs(model, cfg, batch: dict, device, lower: bool = False) -> dict:
    """The reference put in the program's place: its whole eval step on a
    host batch, in the evidence's layout.  The control (``lower``) runs it
    under :class:`LowerPrecision` with its f32 stages on bf16 inputs."""
    mode = LowerPrecision() if lower else contextlib.nullcontext()
    stage = bf16_inputs if lower else (lambda fn: fn)
    with torch.inference_mode(), mode:
        pts = torch.from_numpy(batch["pts_input"]).to(device)
        gt = torch.from_numpy(batch["gt_boxes3d"]).to(device)
        rec = dict(model.rpn(pts))
        rois, scores, valid = stage(_proposals)(cfg, rec)
        seg = (torch.sigmoid(rec["rpn_cls"][..., 0]) > cfg.RPN.SCORE_THRESH).to(torch.float32)
        rec.update(rois=rois, roi_scores_raw=scores, roi_valid=valid, seg_result=seg)
        rec.update(_rcnn_from(model, cfg, rec))
        post = stage(_post)(cfg, rec, gt)
    out = {k: v.to("cpu") for k, v in rec.items()}
    out["post"] = {k: v.to("cpu") for k, v in post.items()}
    out["batch"] = batch
    return out


def compare_eval(model, cfg, rec: dict, device) -> dict:
    """The eval numbers of one batch's evidence ``rec`` (the program's, or
    the control's in its place)."""
    dev = lambda t: t.to(device)  # noqa: E731
    batch = rec["batch"]
    out = {}
    with torch.inference_mode():
        pts = torch.from_numpy(batch["pts_input"]).to(device)
        gt = torch.from_numpy(batch["gt_boxes3d"]).to(device)
        ref_rpn = model.rpn(pts)
        out["rpn_rel"] = max(rel_gap(rec[k], ref_rpn[k].cpu())
                             for k in ("rpn_cls", "rpn_reg", "backbone_features"))
        prog = {k: dev(rec[k]) for k in ("rpn_cls", "rpn_reg", "backbone_xyz",
                                         "backbone_features", "rois", "roi_valid")}
        rois, _, valid = _proposals(cfg, prog)
        box_gap = (rois - prog["rois"]).abs().amax(-1) > 1e-4 * (1 + rois.abs().amax(-1))
        out["proposal_mismatch"] = int(((valid != prog["roi_valid"]) | (valid & box_gap)).sum())
        ref_rcnn = _rcnn_from(model, cfg, prog)
        out["rcnn_rel"] = max(rel_gap(rec[k], ref_rcnn[k].cpu()) for k in ("rcnn_cls", "rcnn_reg"))
        post = _post(cfg, {k: dev(v) for k, v in rec.items() if isinstance(v, torch.Tensor)}, gt)
        out["post_box_rel"] = rel_gap(rec["post"]["pred_boxes3d"], post["pred_boxes3d"].cpu())
        sv_p, sv_r = rec["post"]["sel_valid"], post["sel_valid"].cpu()
        si_p, si_r = rec["post"]["sel_idx"], post["sel_idx"].cpu()
        out["post_sel_mismatch"] = int(((sv_p != sv_r) | (sv_r & (si_p != si_r))).sum())
    return out


def worst(rows: list[dict]) -> dict:
    """Each number's worst over the batches (or steps) compared."""
    return {k: max(r[k] for r in rows) for k in rows[0]} if rows else {}


# ---------------------------------------------------------------- train


def ref_train(cfg, traffic, evidence: dict, device, fault: str | None = None,
              capture: bool = False, lower: bool = False) -> dict:
    """The reference's first steps from the program's starting weights on
    the same batches and step seed -> {losses, mu1, theta3} and, in a stage
    with proposals, the numbers of the stages it follows the program
    through.  There the reference's step takes the program's proposals
    (``evidence["stages"]``): its own RPN and proposal layer are compared
    on the way (``rpn_rel``, ``proposal_mismatch``), its target layer's
    sampled rois and labels against the program's (``target_mismatch``).
    ``capture`` (the control in the program's place) records its own
    proposals and targets instead; ``lower`` runs the control's arithmetic
    (:class:`LowerPrecision`, and its proposal and target layers on bf16
    inputs).  ``fault`` plants a fault in the
    reference put in the program's place: "half" (a step that leaves out
    half of the batch and takes the mean over the rest)."""
    from benchmark.harness import drivers
    from benchmark.reference.models import point_rcnn
    from benchmark.reference.train.optimizer import (
        bn_momentum_for_epoch,
        build_optimizer,
        steps_for,
    )
    from benchmark.reference.train.state import create_train_state, make_train_step

    batch = int(traffic["batch"])
    tx = build_optimizer(cfg, *steps_for(drivers.KITTI_TRAIN_FRAMES, batch,
                                         drivers.TRAIN_EPOCHS))
    state = create_train_state(cfg, tx, seed=0, device=device)
    own = state.model.state_dict()
    with torch.no_grad():
        for k, v in evidence["theta0"].items():
            own[k].copy_(v)
    step = make_train_step(cfg, tx, evidence["step_seed"])
    momentum = bn_momentum_for_epoch(cfg, 0)
    stages = evidence.get("stages") or []
    follow = bool(stages) and not capture
    losses, mu1, rows = [], None, []
    layers = (point_rcnn.proposal_layer, point_rcnn.proposal_target_layer)
    if lower:
        point_rcnn.proposal_layer = bf16_inputs(layers[0])
        point_rcnn.proposal_target_layer = bf16_inputs(layers[1])
    mode = LowerPrecision() if lower else contextlib.nullcontext()
    with drivers.Capture(cfg.RCNN.ENABLED, point_rcnn) as cap, mode:
        recording = point_rcnn.proposal_layer
        for k, b in enumerate(evidence["batches"]):
            dev = {n: torch.from_numpy(v).to(device) for n, v in b.items()}
            if fault == "half":
                dev = {n: v[: max(1, v.shape[0] // 2)] for n, v in dev.items()}
            if follow:
                rows.append(_start_and_proposals(state.model, cfg, cap.originals[0], stages[k],
                                                 dev, device))
                given = tuple(o.to(device) for o in stages[k]["proposals"])

                def program_proposals(*a, _given=given):
                    recording(*a)  # the capture records the step; its result is not used
                    return _given

                point_rcnn.proposal_layer = program_proposals
            try:
                state, tb = step(state, dev, momentum)
            finally:
                point_rcnn.proposal_layer = recording
            losses.append(float(tb["loss"]))
            if k == 0:
                mu1 = {n: v.detach().to("cpu").clone() for n, v in state.opt_state["mu"].items()}
    point_rcnn.proposal_layer, point_rcnn.proposal_target_layer = layers
    theta3 = {n: v.detach().to("cpu").clone() for n, v in state.model.named_parameters()}
    out = {"losses": losses, "mu1": mu1, "theta3": theta3}
    if capture:
        out["stages"] = cap.steps
    if follow:
        for row, prog, mine in zip(rows, stages, cap.steps):
            t_p, t_r = prog["target"], mine["target"]
            box = (t_p["roi_boxes3d"] - t_r["roi_boxes3d"]).abs().amax(-1) \
                > 1e-4 * (1 + t_r["roi_boxes3d"].abs().amax(-1))
            row["target_mismatch"] = int((box | (t_p["cls_label"] != t_r["cls_label"])
                                          | (t_p["reg_valid_mask"] != t_r["reg_valid_mask"])).sum())
        out.update(worst(rows))
    return out


def _start_and_proposals(model, cfg, proposal_layer, stage: dict, batch: dict, device) -> dict:
    """One step's start and proposal stage against the program's: the
    reference's fixed RPN on the batch (``rpn_rel``) and its proposal layer
    on the program's RPN outputs (``proposal_mismatch``)."""
    with torch.no_grad():
        ref = model.rpn(batch["pts_input"])
        row = {"rpn_rel": max(rel_gap(stage["rpn_scores"], ref["rpn_cls"][..., 0].cpu()),
                              rel_gap(stage["rpn_reg"], ref["rpn_reg"].cpu()))}
        mine = proposal_layer(cfg, "TRAIN", stage["rpn_scores"].to(device),
                              stage["rpn_reg"].to(device), stage["xyz"].to(device))
    rois_p, _, valid_p = stage["proposals"]
    rois, valid = mine[0].cpu(), mine[2].cpu()
    box = (rois - rois_p).abs().amax(-1) > 1e-4 * (1 + rois.abs().amax(-1))
    row["proposal_mismatch"] = int(((valid != valid_p) | (valid & box)).sum())
    return row


def _median(norms) -> float:
    """The median of the nonzero leaf norms (a fixed RPN's leaves get no
    gradient and would make it 0)."""
    nz = [v for v in norms if v > 0]
    return float(np.median(nz)) if nz else 0.0


def _leaf_gap(p: dict, r: dict, keep=None) -> float:
    """The worst leaf's gap between the two norms, over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [n for n in r if keep is None or n in keep]
    rn = {n: float(r[n].norm()) for n in names}
    med = _median(rn.values())
    return max(abs(float(p[n].norm()) - rn[n]) / max(rn[n], med, 1e-30) for n in names)


def compare_train(prog: dict, ref: dict) -> dict:
    """The training numbers of the program's evidence ``prog`` (or the
    control's in its place) against the reference's steps ``ref``."""
    theta0 = prog["theta0"]
    lp, lr = np.array(prog["losses"]), np.array(ref["losses"])
    loss_rel = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)))
    if not np.all(np.isfinite(lp)):
        loss_rel = float("inf")
    gnorm = {n: float(v.norm()) for n, v in ref["mu1"].items()}
    med = _median(gnorm.values())
    moved = {n for n, g in gnorm.items() if g >= 1e-3 * med and g > 0}
    dp = {n: prog["theta3"][n] - theta0[n] for n in ref["theta3"]}
    dr = {n: ref["theta3"][n] - theta0[n] for n in ref["theta3"]}
    out = {"loss_rel": loss_rel, "grad1_leaf": _leaf_gap(prog["mu1"], ref["mu1"]),
           "update3_leaf": _leaf_gap(dp, dr, moved)}
    out.update({k: ref[k] for k in ("rpn_rel", "proposal_mismatch", "target_mismatch")
                if k in ref})
    return out


# ---------------------------------------------------------------- verdict


def verdict(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    rows = [(k, numbers.get(k, float("inf")), float(limits[k])) for k in sorted(limits)]
    extra = [k for k in numbers if k not in limits]
    ok = bool(rows) and not extra and all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
