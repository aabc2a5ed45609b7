# Frozen copy of pointrcnn_tpu/utils/flops.py (the arithmetic and
# box_coder.reg_channel_count, without JAX and without its table of TPU
# peaks): the benchmark's operation counts; the peaks are in roofline.py.
"""Analytic FLOP counts for the PointRCNN forward / train steps.

XLA's ``compiled.cost_analysis()['flops']`` cannot serve as the MFU
numerator here: the hot per-group MLPs run as opaque Pallas custom calls
(0 reported flops), while the one-hot MXU gathers *inflate* the count with
data-movement matmuls that are not model math.  So the MFU numerator is
computed analytically from the config, mirroring the module structure
(models/pointnet2.py, models/rpn.py, models/rcnn.py).

Two buckets per stage:

- ``mlp``      — matmul FLOPs of the learned Dense stacks (the classic MFU
                 numerator; 2*M*K*N per layer).
- ``geometry`` — algorithmic FLOPs of the non-learned kernels (FPS distance
                 sweeps, ball-query / 3-NN pairwise distances, roipool
                 inside-tests).  Estimates, flagged as such; excluded from
                 the headline MFU.

"""

from __future__ import annotations

from dataclasses import dataclass, field


def reg_channel_count(loc_scope: float, loc_bin_size: float, num_head_bin: int,
                      get_xz_fine: bool, get_y_by_bin: bool = False,
                      loc_y_scope: float = 0.5, loc_y_bin_size: float = 0.25) -> int:
    """Width of the regression output vector."""
    per_loc_bin_num = int(loc_scope / loc_bin_size) * 2
    loc_y_bin_num = int(loc_y_scope / loc_y_bin_size) * 2
    c = per_loc_bin_num * (4 if get_xz_fine else 2)
    c += loc_y_bin_num * 2 if get_y_by_bin else 1
    c += num_head_bin * 2 + 3
    return c


# flops per pairwise 3-D squared distance: 3 sub + 3 mul + 2 add
_DIST3 = 8


@dataclass
class FlopCount:
    """FLOPs per single frame (batch element).

    ``layers`` records every counted Dense layer as ``(bucket, cin, cout)``
    so tests can cross-check the channel-flow simulation against the real
    model's parameter shapes (tests/test_flops.py).
    """

    buckets: dict = field(default_factory=dict)
    layers: list = field(default_factory=list)

    def add(self, bucket: str, flops: float) -> None:
        self.buckets[bucket] = self.buckets.get(bucket, 0.0) + float(flops)

    def add_chain(self, bucket: str, n_points: float, cin: int, features) -> None:
        for cout in features:
            self.add(bucket, 2.0 * n_points * cin * cout)
            self.layers.append((bucket, int(cin), int(cout)))
            cin = cout

    @property
    def mlp(self) -> float:
        return sum(v for k, v in self.buckets.items() if k.endswith(":mlp"))

    @property
    def geometry(self) -> float:
        return sum(v for k, v in self.buckets.items() if k.endswith(":geom"))

    @property
    def total(self) -> float:
        return sum(self.buckets.values())


def _mlp_chain(n_points: float, cin: int, features) -> float:
    """2*M*K*N matmul FLOPs of a Dense chain applied at ``n_points`` sites."""
    f = 0.0
    for cout in features:
        f += 2.0 * n_points * cin * cout
        cin = cout
    return f


def rpn_forward_flops(cfg) -> FlopCount:
    """Per-frame FLOPs of the RPN forward (backbone + heads).

    Mirrors Pointnet2MSG (models/pointnet2.py:146-189) channel flow exactly.
    """
    fc = FlopCount()
    r = cfg.RPN
    n0 = r.NUM_POINTS
    use_intensity = bool(r.USE_INTENSITY)

    # ---- SA stages (MSG) ----
    counts = [n0]  # points per level
    chans = [1 if use_intensity else 0]  # feature channels per level (pre-xyz)
    for k, npoint in enumerate(r.SA_CONFIG.NPOINTS):
        n_in = counts[-1]
        c_in = chans[-1]
        # FPS: npoint rounds, each a distance sweep over n_in points
        fc.add("rpn.fps:geom", (_DIST3 + 1) * n_in * npoint)
        out_c = 0
        for j, mlp in enumerate(r.SA_CONFIG.MLPS[k]):
            nsample = r.SA_CONFIG.NSAMPLE[k][j]
            # ball query: pairwise distances centroids x points
            fc.add("rpn.ballquery:geom", _DIST3 * npoint * n_in)
            cin = c_in + 3  # use_xyz=True throughout (pointnet2_msg.py:26-45)
            fc.add_chain("rpn.sa:mlp", npoint * nsample, cin, mlp)
            out_c += mlp[-1]
        counts.append(npoint)
        chans.append(out_c)

    # ---- FP stages ----
    n_fp = len(r.FP_MLPS)
    # channel flow identical to Pointnet2MSG.__call__ (updates in place)
    for i in range(-1, -(n_fp + 1), -1):
        unknown_n = counts[i - 1]
        known_n = counts[i]
        known_c = chans[i]
        unknown_c = chans[i - 1]
        # 3-NN pairwise distances + inverse-distance weights
        fc.add("rpn.threenn:geom", _DIST3 * unknown_n * known_n)
        # interpolation: 3 weighted gathers per channel
        fc.add("rpn.threenn:geom", 6.0 * unknown_n * known_c)
        cin = known_c + unknown_c
        fc.add_chain("rpn.fp:mlp", unknown_n, cin, r.FP_MLPS[i])
        chans[i - 1] = r.FP_MLPS[i][-1]

    # ---- heads (per point) ----
    feat_c = chans[0]
    fc.add_chain("rpn.head:mlp", n0, feat_c, list(r.CLS_FC) + [1])
    reg_ch = reg_channel_count(
        r.LOC_SCOPE, r.LOC_BIN_SIZE, r.NUM_HEAD_BIN, get_xz_fine=r.LOC_XZ_FINE
    )
    fc.add_chain("rpn.head:mlp", n0, feat_c, list(r.REG_FC) + [reg_ch])
    return fc


def rcnn_forward_flops(cfg, num_rois: int, num_classes: int = 2) -> FlopCount:
    """Per-frame FLOPs of the RCNN stage over ``num_rois`` rois
    (models/rcnn.py:29-90)."""
    fc = FlopCount()
    c = cfg.RCNN
    npts = c.NUM_POINTS
    R = num_rois

    # roipool: per (roi, point) inside-test: rotate (6 mul/add) + extent (6)
    fc.add("rcnn.roipool:geom", 12.0 * R * cfg.RPN.NUM_POINTS)

    feat_c = 0
    if c.USE_RPN_FEATURES:
        in_ch = 3 + int(c.USE_INTENSITY) + int(c.USE_MASK) + int(c.USE_DEPTH)
        fc.add_chain("rcnn.xyzup:mlp", R * npts, in_ch, c.XYZ_UP_LAYER)
        rpn_c = cfg.RPN.FP_MLPS[0][-1]
        fc.add_chain("rcnn.merge:mlp", R * npts, c.XYZ_UP_LAYER[-1] + rpn_c, [c.XYZ_UP_LAYER[-1]])
        feat_c = c.XYZ_UP_LAYER[-1]

    n_in = npts
    for k, npoint in enumerate(c.SA_CONFIG.NPOINTS):
        mlp = c.SA_CONFIG.MLPS[k]
        if npoint == -1:  # group-all
            fc.add_chain("rcnn.sa:mlp", R * n_in, feat_c + 3, mlp)
            n_in = 1
        else:
            nsample = c.SA_CONFIG.NSAMPLE[k]
            fc.add("rcnn.fps:geom", (_DIST3 + 1) * R * n_in * npoint)
            fc.add("rcnn.ballquery:geom", _DIST3 * R * npoint * n_in)
            fc.add_chain("rcnn.sa:mlp", R * npoint * nsample, feat_c + 3, mlp)
            n_in = npoint
        feat_c = mlp[-1]

    cls_channel = 1 if num_classes == 2 else num_classes
    fc.add_chain("rcnn.head:mlp", R, feat_c, list(c.CLS_FC) + [cls_channel])
    reg_ch = reg_channel_count(
        c.LOC_SCOPE, c.LOC_BIN_SIZE, c.NUM_HEAD_BIN, get_xz_fine=True,
        get_y_by_bin=c.LOC_Y_BY_BIN, loc_y_scope=c.LOC_Y_SCOPE,
        loc_y_bin_size=c.LOC_Y_BIN_SIZE,
    )
    fc.add_chain("rcnn.head:mlp", R, feat_c, list(c.REG_FC) + [reg_ch])
    return fc


def eval_forward_flops(cfg, mode: str = "TEST", num_classes: int = 2) -> FlopCount:
    """Per-frame FLOPs of the full two-stage eval forward (the bench.py
    workload: RPN + proposal decode/NMS + roipool + RCNN refinement)."""
    fc = rpn_forward_flops(cfg)
    num_rois = cfg[mode].RPN_POST_NMS_TOP_N
    if cfg.RCNN.ENABLED:
        for k, v in rcnn_forward_flops(cfg, num_rois, num_classes).buckets.items():
            fc.add(k, v)
    # proposal layer: decode (~200 flops/pt) + NMS pairwise BEV overlap
    fc.add("proposal.decode:geom", 200.0 * cfg.RPN.NUM_POINTS)
    ncand = getattr(cfg.RPN, "NMS_MAX_CANDIDATES", 2048)
    # rotated polygon clip ~ 300 flops/pair (corners, 4x4 edge clips, area)
    fc.add("proposal.nms:geom", 300.0 * ncand * ncand)
    return fc


def train_step_flops(cfg, train_mode: str, batch_size: int,
                     num_classes: int = 2) -> FlopCount:
    """Per-STEP (not per-frame) FLOPs of one optimizer step.

    Matmul fwd+bwd = 3x forward (dL/dW and dL/dx each cost one forward's
    matmul FLOPs); stop-gradient stages (FIXED RPN under rcnn mode) count 1x.
    """
    fc = FlopCount()
    rpn = rpn_forward_flops(cfg)
    rpn_mult = 1.0 if (train_mode != "rpn" and cfg.RPN.FIXED) else 3.0
    if train_mode == "rcnn_offline":
        rpn_mult = 0.0
    for k, v in rpn.buckets.items():
        fc.add(k, v * (rpn_mult if k.endswith(":mlp") else min(rpn_mult, 1.0)) * batch_size)
    if train_mode in ("rcnn", "rcnn_offline", "joint") and cfg.RCNN.ENABLED:
        rois = cfg.RCNN.ROI_PER_IMAGE
        rc = rcnn_forward_flops(cfg, rois, num_classes)
        for k, v in rc.buckets.items():
            fc.add(k, v * (3.0 if k.endswith(":mlp") else 1.0) * batch_size)
    return fc
