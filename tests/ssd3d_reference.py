"""3DSSD's eval forward, decode and NMS in plain PyTorch f32: the reference
the port (``pointrcnn_tpu_torch/models/ssd3d.py``) is held to.

It imports neither JAX nor the port.  It takes the port's parameter names
(a state dict, the weights both sides load) and a config as a plain nested
dict (:func:`plain`); every matmul is f32 with TF32 off for matmul and
cudnn (:func:`f32_matmuls`).  Each stage is a function of its inputs, so a
caller can hold the port stage by stage, feeding each stage the port's own
inputs to it.

Departures from mmdetection3d (``configs/3dssd/3dssd_4x4_kitti-3d-car.py``
over ``configs/_base_/models/3dssd.py``), the port's as well:

- F-FPS takes the direct distance, summed over the 3 + C values in
  dimension order (``(((x0 - q0)^2 + (x1 - q1)^2) + (x2 - q2)^2) + ...``);
  mmdetection3d first builds the N x N matrix of the expanded form
  ``|a|^2 + |b|^2 - 2 a.b``, which rounds otherwise.  D-FPS is the same
  chain over xyz.  Both start at the range's first row, from a running
  minimum of 1e10, and take the lowest index on ties.
- The frame is the rect camera frame (x right, y down, z forward), not the
  LiDAR frame: ``vote_xyz_range`` (3, 3, 2) on LiDAR (x, y, z) is (3, 2, 3)
  here, a decoded box is KITTI's camera box (x, y, z of its bottom centre,
  h, w, l, ry) whose sizes are the extents along its length, height and
  width, and the NMS box is the min and max of its four corners in x and z.
- The intensity channel is the fourth input value, taken as it is read.
- NMS ties in score keep the lower index first.
"""

from __future__ import annotations

import math

import torch


def plain(node):
    """A config tree (any mapping with ``items()``) as nested dicts."""
    if hasattr(node, "items"):
        return {k: plain(v) for k, v in node.items()}
    if hasattr(node, "tolist"):
        return node.tolist()
    return node


def f32_matmuls() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------- sampling


def fps(rows: torch.Tensor, npoint: int, start: int = 0, end: int | None = None):
    """FPS over (B, N, D) rows in [start, end), the squared distance summed
    over the D values in order -> (B, npoint) int64 indices into N."""
    x = rows[:, start:end].to(torch.float32)
    B, n, D = x.shape
    mind = torch.full((B, n), 1e10, dtype=torch.float32, device=x.device)
    picks = torch.zeros((B, npoint), dtype=torch.int64, device=x.device)
    cur = torch.zeros(B, dtype=torch.int64, device=x.device)
    rows_b = torch.arange(B, device=x.device)
    for i in range(1, npoint):
        q = x[rows_b, cur]  # (B, D)
        d2 = None
        for k in range(D):
            dk = x[..., k] - q[:, None, k]
            d2 = dk * dk if d2 is None else d2 + dk * dk
        mind = torch.minimum(mind, d2)
        best = mind.max(dim=1, keepdim=True).values
        # the lowest index among the maxima
        cur = torch.argmax((mind == best).to(torch.int8), dim=1)
        picks[:, i] = cur
    return picks + start


def sample(xyz, feats, modes, npoints, ends):
    """mmdetection3d's ``Points_Sampler``: each sampler over the rows from
    the previous one's end to its own (-1: the last row); ``FS`` is F-FPS
    then D-FPS over the same rows -> (B, S) int64."""
    N = xyz.shape[1]
    out, start = [], 0
    for mode, npoint, end in zip(modes, npoints, ends):
        end = N if end == -1 else end
        if mode in ("F-FPS", "FS"):
            out.append(fps(torch.cat([xyz, feats], dim=-1), npoint, start, end))
        if mode in ("D-FPS", "FS"):
            out.append(fps(xyz, npoint, start, end))
        start = end
    return torch.cat(out, dim=1)


def gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) rows at (B, ...) indices -> (B, ..., C)."""
    B = t.shape[0]
    flat = idx.reshape(B, -1).long()
    return torch.stack([t[b, flat[b]] for b in range(B)]).reshape(*idx.shape, t.shape[-1])


# ---------------------------------------------------------------- ball query


def ball_query(xyz, centres, radius: float, nsample: int, chunk_cells: int = 1 << 23):
    """mmcv's ball query: the first ``nsample`` points with ``d2 < r^2`` (r^2
    in f32) in point order, slots past the hit count the first hit, no hit
    all zeros -> (B, S, nsample) int64."""
    B, N, _ = xyz.shape
    r = torch.tensor(radius, dtype=torch.float32)
    r2 = float(r * r)
    step = max(1, chunk_cells // max(B * N, 1))
    outs = []
    for c in centres.split(step, dim=1):
        d = c[:, :, None, :] - xyz[:, None, :, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        hit = d2 < r2
        first = torch.sort((~hit).to(torch.int8), dim=-1, stable=True).indices[..., :nsample]
        count = hit.sum(dim=-1, keepdim=True)
        slot = torch.arange(first.shape[-1], device=xyz.device)
        idx = torch.where(slot < count, first, first[..., :1])
        idx = torch.where(count > 0, idx, 0)
        if idx.shape[-1] < nsample:
            pad = idx[..., :1].expand(*idx.shape[:-1], nsample - idx.shape[-1])
            idx = torch.cat([idx, pad], -1)
        outs.append(idx)
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------- layers


def conv_bn_relu(x, p: dict, prefix: str, i: int, eps: float, bias: bool):
    """Layer ``i`` of a SharedMLP stack: x @ w (+ b), batch norm with the
    running statistics, ReLU, all f32."""
    y = x @ p[f"{prefix}.w{i}"].to(torch.float32)
    if bias:
        y = y + p[f"{prefix}.b{i}"]
    y = (y - p[f"{prefix}.bn{i}_mean"]) / torch.sqrt(p[f"{prefix}.bn{i}_var"] + eps)
    return torch.relu(y * p[f"{prefix}.bn{i}_scale"] + p[f"{prefix}.bn{i}_bias"])


def stack(x, p: dict, prefix: str, depth: int, eps: float, bias: bool):
    for i in range(depth):
        x = conv_bn_relu(x, p, prefix, i, eps, bias)
    return x


def linear(x, p: dict, prefix: str):
    return x @ p[f"{prefix}.weight"].to(torch.float32).t() + p[f"{prefix}.bias"]


def group_mlp_max(xyz, feats, centres, idx, p, prefix, depth, eps, bias):
    """Grouped neighbourhoods [xyz - centre, features] through a stack, the
    max over each neighbourhood -> (B, S, Cout)."""
    g = torch.cat([gather(xyz, idx) - centres[:, :, None, :], gather(feats, idx)], dim=-1)
    return stack(g, p, prefix, depth, eps, bias).max(dim=2).values


# ---------------------------------------------------------------- stages


def sa_features(p, cfg, k, xyz, feats, centres, query_idx):
    """SA stage ``k``'s features (the scales' stacks, concatenated, then the
    aggregation conv) on given centres and neighbourhoods."""
    bb = cfg["BACKBONE"]
    pre = f"backbone.SetAbstractionMSG_{k}"
    outs = [group_mlp_max(xyz, feats, centres, idx, p, f"{pre}.SharedMLP_{i}",
                          len(bb["MLPS"][k][i]), bb["BN_EPS"], False)
            for i, idx in enumerate(query_idx)]
    return conv_bn_relu(torch.cat(outs, dim=-1), p, f"{pre}.aggregation", 0,
                        bb["AGGREGATION_BN_EPS"], True)


def sa_sample(cfg, k, xyz, feats):
    bb = cfg["BACKBONE"]
    return sample(xyz, feats, bb["FPS_MODS"][k], bb["NPOINTS"][k], bb["FPS_RANGES"][k])


def sa_query(cfg, k, xyz, centres):
    bb = cfg["BACKBONE"]
    return [ball_query(xyz, centres, r, ns) for r, ns in zip(bb["RADIUS"][k], bb["NSAMPLE"][k])]


def votes(p, cfg, seeds, seed_feats):
    """The vote module: Conv1d-BN-ReLU, a Conv1d to 3 offsets, each clamped
    to +-``VOTE.XYZ_RANGE`` by axis, added to its seed."""
    v = cfg["VOTE"]
    h = stack(seed_feats, p, "vote_conv", len(v["CONV"]), v["BN_EPS"], False)
    off = linear(h, p, "vote_out")
    lim = torch.tensor(v["XYZ_RANGE"], dtype=torch.float32, device=off.device)
    return seeds + torch.clamp(off, min=-lim, max=lim)


def agg_query(cfg, xyz, vote_xyz):
    a = cfg["VOTE_AGGREGATION"]
    return [ball_query(xyz, vote_xyz, r, ns) for r, ns in zip(a["RADIUS"], a["NSAMPLE"])]


def agg_features(p, cfg, xyz, feats, vote_xyz, query_idx):
    a = cfg["VOTE_AGGREGATION"]
    return torch.cat([group_mlp_max(xyz, feats, vote_xyz, idx, p,
                                    f"vote_aggregation.SharedMLP_{i}", len(a["MLPS"][i]),
                                    a["BN_EPS"], True)
                      for i, idx in enumerate(query_idx)], dim=-1)


def head(p, cfg, feats):
    """-> (cls (B, S, 1), reg (B, S, 6 + 2 nb))."""
    h = cfg["HEAD"]
    x = stack(feats, p, "shared", len(h["SHARED"]), h["BN_EPS"], True)
    cls = linear(stack(x, p, "cls_conv", len(h["CLS"]), h["BN_EPS"], True), p, "cls_out")
    reg = linear(stack(x, p, "reg_conv", len(h["REG"]), h["BN_EPS"], True), p, "reg_out")
    return cls, reg


def forward(p, cfg, pts) -> dict:
    """The whole forward on (B, N, 3 + C) points, every stage on the
    reference's own inputs."""
    xyz, feats = pts[..., :3], pts[..., 3:]
    out = {}
    for k in range(3):
        idx = sa_sample(cfg, k, xyz, feats)
        centres = gather(xyz, idx)
        q = sa_query(cfg, k, xyz, centres)
        feats = sa_features(p, cfg, k, xyz, feats, centres, q)
        xyz = centres
        out.update({f"sa{k + 1}_sample_idx": idx, f"sa{k + 1}_query_idx": q,
                    f"sa{k + 1}_xyz": xyz, f"sa{k + 1}_features": feats})
    n = cfg["VOTE"]["NUM_POINTS"]
    v = votes(p, cfg, xyz[:, :n], feats[:, :n])
    q = agg_query(cfg, xyz, v)
    a = agg_features(p, cfg, xyz, feats, v, q)
    cls, reg = head(p, cfg, a)
    out.update(votes=v, agg_query_idx=q, agg_features=a, cls=cls, reg=reg)
    return out


# ---------------------------------------------------------------- test time


def decode(cfg, vote_xyz, reg):
    """``AnchorFreeBBoxCoder.decode`` -> (B, S, 7) camera boxes."""
    nb = cfg["HEAD"]["NUM_DIR_BINS"]
    center = vote_xyz + reg[..., 0:3]
    size = torch.clamp(reg[..., 3:6] * 2.0, min=cfg["HEAD"]["MIN_SIZE"])
    bins = torch.argmax(reg[..., 6:6 + nb], dim=-1)
    res = torch.gather(reg[..., 6 + nb:6 + 2 * nb], -1, bins[..., None])[..., 0]
    angle = bins.to(torch.float32) * (2.0 * math.pi / nb) + res * (math.pi / nb)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    l, h, w = size[..., 0], size[..., 1], size[..., 2]
    return torch.stack([center[..., 0], center[..., 1] + h * 0.5, center[..., 2], h, w, l, angle],
                       dim=-1)


def bev_minmax(boxes):
    """(..., 7) camera boxes -> (..., 4) [x1, z1, x2, z2] of the corners."""
    x, z, w, l, ry = boxes[..., 0], boxes[..., 2], boxes[..., 4], boxes[..., 5], boxes[..., 6]
    c, s = torch.cos(ry), torch.sin(ry)
    hl, hw = l * 0.5, w * 0.5
    xs = torch.stack([x + (hl * c + hw * s), x + (hl * c - hw * s),
                      x + (-hl * c + hw * s), x + (-hl * c - hw * s)], -1)
    zs = torch.stack([z + (-hl * s + hw * c), z + (-hl * s - hw * c),
                      z + (hl * s + hw * c), z + (hl * s - hw * c)], -1)
    return torch.stack([xs.min(-1).values, zs.min(-1).values, xs.max(-1).values,
                        zs.max(-1).values], -1)


def nms(bev, scores, thresh: float, max_out: int):
    """Greedy NMS of one frame over axis-aligned boxes (mmcv ``nms``,
    offset 0): the score order (ties: lower index first), a box kept unless
    a kept box before it overlaps it by IoU > ``thresh`` -> the first
    ``max_out`` kept indices, in that order (int64)."""
    order = torch.sort(scores, descending=True, stable=True).indices
    b = bev[order]
    area = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    iw = torch.clamp(torch.minimum(b[:, None, 2], b[None, :, 2])
                     - torch.maximum(b[:, None, 0], b[None, :, 0]), min=0.0)
    ih = torch.clamp(torch.minimum(b[:, None, 3], b[None, :, 3])
                     - torch.maximum(b[:, None, 1], b[None, :, 1]), min=0.0)
    inter = iw * ih
    over = (inter / (area[:, None] + area[None, :] - inter) > thresh).tolist()
    kept = []
    for i in range(len(over)):
        if not any(over[j][i] for j in kept):
            kept.append(i)
    return order[kept[:max_out]]


def post(cfg, vote_xyz, cls, reg):
    """The test-time step on one batch -> (scores (B, S), boxes (B, S, 7),
    [kept indices of each frame, the score threshold applied after])."""
    t = cfg["TEST"]
    scores = torch.sigmoid(cls[..., 0])
    boxes = decode(cfg, vote_xyz, reg)
    bev = bev_minmax(boxes).cpu()
    sc = scores.cpu()
    kept = []
    for f in range(boxes.shape[0]):
        k = nms(bev[f], sc[f], t["NMS_THRESH"], t["MAX_OUTPUT"])
        kept.append(k[sc[f][k] >= t["SCORE_THRESH"]])
    return scores, boxes, kept
