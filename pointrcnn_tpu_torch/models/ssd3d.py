"""3DSSD (Yang et al., CVPR 2020, arXiv:2002.10187): a one-stage,
anchor-free point detector, at mmdetection3d's KITTI Car settings
(``ssd3d_config.py``), eval only.

- Backbone (``PointNet2SAMSG``, no FP layers): three SA-MSG stages with
  sampler specs (SA1 D-FPS 4096; SA2 fusion sampling, F-FPS 512 + D-FPS
  512 of the same 4096 rows; SA3 F-FPS 256 over rows [0, 512) and D-FPS 256
  over [512, 1024)), the exact ball query (the first ``nsample`` in-radius
  points in point order), grouped stacks through the fused kernel (K2, BN
  folded) at any table length, an aggregation Conv1d-BN-ReLU a stage.
- Vote module: the first 256 SA3 points are the candidates; Conv1d-BN-ReLU
  then a Conv1d to 3 offsets, each clamped to +-``VOTE.XYZ_RANGE`` by
  axis; vote = candidate + offset (f32).
- Vote aggregation: SA-MSG centred on the votes, grouping the 512 SA3
  points (convs with bias before BN), 1536 channels.
- Head: shared Conv1d-BN-ReLU 1536 -> 512 -> 128, then cls 128 -> 128 -> 1
  and reg 128 -> 128 -> 30 (``AnchorFreeBBoxCoder``: 3 centre offsets from
  the vote, 3 half sizes, 12 heading-bin scores, 12 normalised residuals).
- Test time (``SSD3DHead.get_bboxes``): sigmoid scores, the boxes decoded
  (:func:`decode_boxes`, f32), NMS at IoU ``TEST.NMS_THRESH`` over each
  box's axis-aligned BEV extent (the min and max of its corners), at most
  ``TEST.MAX_OUTPUT`` kept, then the score threshold.

The MLPs take bf16 operands with f32 accumulation (``COMPUTE_DTYPE``);
F-FPS distances, vote shifts, the decode and the NMS are f32.  Frames are
in the rect camera frame: a decoded box is KITTI's camera box (x, y, z of
its bottom centre, h, w, l, ry): the centre is the vote plus the offsets,
the three sizes are the extents along the box's length, height and width,
and the heading angle is its ry.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models.layers import SharedMLP, bf16_round
from pointrcnn_tpu_torch.models.pointnet2 import SetAbstractionMSG
from pointrcnn_tpu_torch.ops.iou3d import boxes_iou3d
from pointrcnn_tpu_torch.ops.nms import nms_bev
from pointrcnn_tpu_torch.ops.sampling import sampler_spec

# the backbone's stages, the vote layers, the head: span names of the forward
SA_SPANS = ("ssd3d.SA1", "ssd3d.SA2", "ssd3d.SA3")


class PointLinear(nn.Module):
    """A Conv1d of kernel 1 without norm (an output layer): bf16 operands,
    f32 accumulation, the f32 bias added after (``dtype`` None: f32)."""

    def __init__(self, cin, cout, dtype=None, gen=None):
        super().__init__()
        self.dtype = dtype
        lim = math.sqrt(1.0 / cin)
        self.weight = nn.Parameter((torch.rand((cout, cin), generator=gen) * 2 - 1) * lim)
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        if self.dtype is None:
            return x.to(torch.float32) @ self.weight.t() + self.bias
        return bf16_round(x) @ bf16_round(self.weight).t() + self.bias


class SSD3D(nn.Module):
    """3DSSD's forward: (B, N, 3 + C) points -> the outputs of each stage
    (:meth:`forward`)."""

    def __init__(self, cfg, generator: torch.Generator | None = None):
        super().__init__()
        gen = generator or torch.Generator().manual_seed(0)
        dt = torch.bfloat16 if cfg.COMPUTE_DTYPE == "bfloat16" else None
        self.cfg = cfg
        bb = cfg.BACKBONE
        self.n_candidates = cfg.VOTE.NUM_POINTS
        self.vote_range = tuple(float(r) for r in cfg.VOTE.XYZ_RANGE)
        cin = 1 if cfg.USE_INTENSITY else 0
        self.backbone = nn.Module()
        for k in range(len(bb.MLPS)):
            sa = SetAbstractionMSG(
                cin, sampler_spec(bb.FPS_MODS[k], bb.NPOINTS[k], bb.FPS_RANGES[k]),
                bb.RADIUS[k], bb.NSAMPLE[k], bb.MLPS[k], use_xyz=True, bn=True, dtype=dt,
                query_method="exact", gen=gen, aggregation=bb.AGGREGATION[k],
                mlp_opts={"eps": bb.BN_EPS, "any_table": True})
            sa.aggregation.eps = bb.AGGREGATION_BN_EPS
            self.backbone.add_module(f"SetAbstractionMSG_{k}", sa)
            cin = bb.AGGREGATION[k]
        self.vote_conv = SharedMLP(cin, list(cfg.VOTE.CONV), bn=True, dtype=dt, gen=gen,
                                   eps=cfg.VOTE.BN_EPS)
        self.vote_out = PointLinear(cfg.VOTE.CONV[-1], 3, dt, gen)
        agg = cfg.VOTE_AGGREGATION
        self.vote_aggregation = SetAbstractionMSG(
            cin, None, agg.RADIUS, agg.NSAMPLE, agg.MLPS, use_xyz=True, bn=True, dtype=dt,
            query_method="exact", gen=gen,
            mlp_opts={"eps": agg.BN_EPS, "any_table": True, "conv_bias": True})
        head = cfg.HEAD
        width = sum(m[-1] for m in agg.MLPS)
        opts = {"bn": True, "dtype": dt, "gen": gen, "conv_bias": True, "eps": head.BN_EPS}
        self.shared = SharedMLP(width, list(head.SHARED), **opts)
        self.cls_conv = SharedMLP(head.SHARED[-1], list(head.CLS), **opts)
        self.reg_conv = SharedMLP(head.SHARED[-1], list(head.REG), **opts)
        self.cls_out = PointLinear(head.CLS[-1], 1, dt, gen)
        self.reg_out = PointLinear(head.REG[-1], 6 + 2 * head.NUM_DIR_BINS, dt, gen)

    def forward(self, pts: torch.Tensor) -> dict:
        """-> ``sa{k}_xyz``, ``sa{k}_features``, ``sa{k}_sample_idx`` and
        ``sa{k}_query_idx`` (a list, one a scale) for k = 1..3; ``seeds``
        (the candidates' xyz), ``votes``; ``agg_features``,
        ``agg_query_idx``; ``cls`` (B, S, 1) and ``reg`` (B, S, 30), f32."""
        xyz = pts[..., 0:3].contiguous()
        feats = pts[..., 3:].contiguous() if pts.shape[-1] > 3 else None
        out = {}
        for k, span in enumerate(SA_SPANS):
            with trace.span(span):
                r = getattr(self.backbone, f"SetAbstractionMSG_{k}").run(xyz, feats)
            xyz, feats = r["xyz"], r["features"]
            out.update({f"sa{k + 1}_xyz": xyz, f"sa{k + 1}_features": feats,
                        f"sa{k + 1}_sample_idx": r["sample_idx"],
                        f"sa{k + 1}_query_idx": r["query_idx"]})
        with trace.span("ssd3d.vote"):
            seeds = xyz[:, :self.n_candidates]
            votes = vote_shift(seeds, self.vote_out(self.vote_conv(feats[:, :self.n_candidates])),
                               self.vote_range)
        with trace.span("ssd3d.vote_aggregation"):
            r = self.vote_aggregation.run(xyz, feats, target_xyz=votes)
        with trace.span("ssd3d.head"):
            h = self.shared(r["features"])
            cls = self.cls_out(self.cls_conv(h))
            reg = self.reg_out(self.reg_conv(h))
        out.update(seeds=seeds, votes=votes, agg_features=r["features"],
                   agg_query_idx=r["query_idx"], cls=cls, reg=reg)
        return out


def vote_shift(seeds: torch.Tensor, offset: torch.Tensor, vote_range) -> torch.Tensor:
    """Each offset clamped to +-``vote_range[axis]`` by axis, added to its
    seed (f32)."""
    offset = offset.to(torch.float32)
    return seeds + torch.stack([offset[..., a].clamp(-r, r) for a, r in enumerate(vote_range)],
                               dim=-1)


def decode_boxes(cfg, votes: torch.Tensor, reg: torch.Tensor) -> torch.Tensor:
    """``AnchorFreeBBoxCoder.decode`` in the rect frame: (B, S, 3) votes and
    (B, S, 6 + 2 nb) regression -> (B, S, 7) KITTI camera boxes (x, y, z of
    the bottom centre, h, w, l, ry), f32.  The heading is bin ``argmax``'s
    centre plus its residual times pi / nb, wrapped above pi."""
    nb = cfg.HEAD.NUM_DIR_BINS
    reg = reg.to(torch.float32)
    center = votes + reg[..., 0:3]
    size = torch.clamp(reg[..., 3:6] * 2.0, min=cfg.HEAD.MIN_SIZE)  # l, h, w
    bins = torch.argmax(reg[..., 6:6 + nb], dim=-1)
    res = torch.gather(reg[..., 6 + nb:6 + 2 * nb], -1, bins[..., None])[..., 0]
    angle = bins.to(torch.float32) * (2.0 * math.pi / nb) + res * (math.pi / nb)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    l, h, w = size[..., 0], size[..., 1], size[..., 2]
    return torch.stack([center[..., 0], center[..., 1] + h * 0.5, center[..., 2],
                        h, w, l, angle], dim=-1)


def bev_extent(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) camera boxes -> (..., 5) ``[x1, z1, x2, z2, 0]``: the min and
    max of each box's four BEV corners (x, z), the box ``SSD3DHead``'s NMS
    takes."""
    x, z, w, l, ry = boxes[..., 0], boxes[..., 2], boxes[..., 4], boxes[..., 5], boxes[..., 6]
    c, s = torch.cos(ry), torch.sin(ry)
    hl, hw = l * 0.5, w * 0.5
    dxs = (hl * c + hw * s, hl * c - hw * s, -hl * c + hw * s, -hl * c - hw * s)
    dzs = (-hl * s + hw * c, -hl * s - hw * c, hl * s + hw * c, hl * s - hw * c)
    xs = torch.stack([x + d for d in dxs], dim=-1)
    zs = torch.stack([z + d for d in dzs], dim=-1)
    return torch.stack([xs.amin(-1), zs.amin(-1), xs.amax(-1), zs.amax(-1),
                        torch.zeros_like(x)], dim=-1)


def postprocess(cfg, out: dict, gt_boxes3d=None, gt_valid=None) -> dict:
    """The test-time step after the forward: ``scores`` (B, S) sigmoid,
    ``pred_boxes3d`` (B, S, 7), ``sel_idx`` / ``sel_valid`` (B,
    ``TEST.MAX_OUTPUT``): the NMS survivors in score order, the score
    threshold applied after; with ``gt_boxes3d`` ``gt_max_iou``, each gt
    box's best 3D IoU over the survivors."""
    with trace.span("ssd3d.decode"):
        scores = torch.sigmoid(out["cls"][..., 0].to(torch.float32))
        boxes = decode_boxes(cfg, out["votes"], out["reg"])
        bev = bev_extent(boxes)
    S = scores.shape[-1]
    idx, keep = nms_bev(bev, scores, cfg.TEST.NMS_THRESH, S, cfg.TEST.MAX_OUTPUT)
    keep = keep & (torch.gather(scores, -1, idx) >= cfg.TEST.SCORE_THRESH)
    result = {"scores": scores, "pred_boxes3d": boxes, "sel_idx": idx, "sel_valid": keep}
    if gt_boxes3d is not None:
        sel = torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 7))
        iou = boxes_iou3d(gt_boxes3d, sel)
        result["gt_max_iou"] = torch.where(keep[:, None, :], iou, 0.0).max(dim=2).values
    return result
