"""PointNet++ set abstraction and feature propagation (counterpart of
``pointrcnn_tpu/models/pointnet2.py``).  Training follows ``module.training``
inside the shared MLPs; the sampling and grouping are the same in both."""

from __future__ import annotations

import torch
from torch import nn

from pointrcnn_tpu_torch import trace
from pointrcnn_tpu_torch.models.layers import SharedMLP
from pointrcnn_tpu_torch.ops import cuda_ballquery
from pointrcnn_tpu_torch.ops.common import gather_points
from pointrcnn_tpu_torch.ops.grouping import (
    ball_query,
    ball_query_multi,
    fps_group_banded,
    fps_group_banded_supported,
    three_interpolate,
    three_nn,
)
from pointrcnn_tpu_torch.ops.sampling import furthest_point_sample


class SetAbstractionMSG(nn.Module):
    """Multi-scale grouping: FPS centroids, per-radius ball query + shared
    MLP + max over the neighbourhood, concatenated over scales."""

    def __init__(self, cin, npoint, radii, nsamples, mlps, use_xyz=True, bn=True,
                 dtype=None, query_method="exact", fps_method="exact", gen=None):
        super().__init__()
        self.npoint, self.use_xyz = npoint, use_xyz
        self.specs = list(zip(radii, nsamples))
        self.query_method, self.fps_method, self.dtype = query_method, fps_method, dtype
        for i, mlp in enumerate(mlps):
            self.add_module(f"SharedMLP_{i}", SharedMLP(
                cin + (3 if use_xyz else 0), mlp, bn=bn, dtype=dtype, gen=gen))

    def forward(self, xyz, features):
        if features is None and self.use_xyz and self.query_method == "approx":
            new_xyz, rels = self._xyz_only(xyz)
            if rels is not None:
                dt = self.dtype or xyz.dtype
                outs = [getattr(self, f"SharedMLP_{i}")(rel.to(dt), reduce_max=True)
                        for i, rel in enumerate(rels)]
                return new_xyz, torch.cat(outs, dim=-1)
        fps_idx = furthest_point_sample(xyz, self.npoint, method=self.fps_method)
        new_xyz = gather_points(xyz, fps_idx)
        idx_list = ball_query_multi(xyz, new_xyz, self.specs, method=self.query_method)
        outs = [getattr(self, f"SharedMLP_{i}")(
                    None, group_args=(xyz, features, new_xyz, idx, self.use_xyz))
                for i, idx in enumerate(idx_list)]
        return new_xyz, torch.cat(outs, dim=-1)

    def _xyz_only(self, xyz):
        """An xyz-only stage: the selection kernels emit the neighbourhoods'
        relative xyz directly, banded after blockwise FPS where the shapes
        allow, else after FPS by the full scan -> (new_xyz, rels), or
        (None, None) when neither applies."""
        N = xyz.shape[1]
        nsamples = [ns for _, ns in self.specs]
        if self.fps_method == "blockwise" and fps_group_banded_supported(N, self.npoint, nsamples):
            return fps_group_banded(xyz, self.npoint, self.specs)
        if cuda_ballquery.ball_query_supported(N, self.npoint, max(nsamples)):
            new_xyz = gather_points(xyz, furthest_point_sample(xyz, self.npoint, method=self.fps_method))
            return new_xyz, cuda_ballquery.ball_query_multi_grouped(xyz, new_xyz, self.specs)
        return None, None


class SetAbstraction(nn.Module):
    """Single-scale SA; ``npoint=None`` is group-all (global pooling)."""

    def __init__(self, cin, npoint, radius, nsample, mlp, use_xyz=True, bn=True,
                 dtype=None, query_method="exact", fps_method="exact",
                 fold_geometry=False, gen=None):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.use_xyz = npoint, radius, nsample, use_xyz
        self.query_method, self.fps_method = query_method, fps_method
        self.SharedMLP_0 = SharedMLP(cin + (3 if use_xyz else 0), mlp, bn=bn, dtype=dtype,
                                     fold_geometry=fold_geometry, gen=gen)

    def forward(self, xyz, features):
        if self.npoint is not None:
            fps_idx = furthest_point_sample(xyz, self.npoint, method=self.fps_method)
            new_xyz = gather_points(xyz, fps_idx)
            idx = ball_query(xyz, new_xyz, self.radius, self.nsample, method=self.query_method)
            feat = self.SharedMLP_0(None, group_args=(xyz, features, new_xyz, idx, self.use_xyz))
            return new_xyz, feat
        new_xyz = torch.zeros((xyz.shape[0], 1, 3), dtype=xyz.dtype, device=xyz.device)
        g = xyz[:, None]
        if features is not None:
            g = torch.cat([g, features[:, None]], dim=-1) if self.use_xyz else features[:, None]
        return new_xyz, self.SharedMLP_0(g, reduce_max=True)


class FeaturePropagation(nn.Module):
    """Inverse-distance 3-NN interpolation + unit MLP."""

    def __init__(self, cin, mlp, bn=True, dtype=None, gen=None):
        super().__init__()
        self.SharedMLP_0 = SharedMLP(cin, mlp, bn=bn, dtype=dtype, gen=gen)

    def forward(self, unknown_xyz, known_xyz, unknown_feats, known_feats):
        dist, idx = three_nn(unknown_xyz, known_xyz)
        interp = three_interpolate(known_feats, idx, dist)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.SharedMLP_0(interp)


class Pointnet2MSG(nn.Module):
    """The RPN backbone: MSG SA stages down, FP stages back up.  Input
    (B, N, 3 + C), output (xyz (B, N, 3), features (B, N, fp_mlps[0][-1]))."""

    def __init__(self, in_features, npoints, radii, nsamples, mlps, fp_mlps,
                 use_xyz=True, bn=True, dtype=None, query_method="exact",
                 fps_method="exact", gen=None):
        super().__init__()
        self.n_sa, self.n_fp = len(npoints), len(fp_mlps)
        ch = [in_features]
        for k in range(self.n_sa):
            self.add_module(f"SetAbstractionMSG_{k}", SetAbstractionMSG(
                ch[k], npoints[k], radii[k], nsamples[k], mlps[k], use_xyz=use_xyz,
                bn=bn, dtype=dtype, query_method=query_method,
                fps_method=fps_method, gen=gen))
            ch.append(sum(m[-1] for m in mlps[k]))
        for j, i in enumerate(range(-1, -(self.n_fp + 1), -1)):
            self.add_module(f"FeaturePropagation_{j}", FeaturePropagation(
                ch[i] + ch[i - 1], fp_mlps[i], bn=bn, dtype=dtype, gen=gen))
            ch[i - 1] = fp_mlps[i][-1]

    def forward(self, pointcloud):
        xyz = pointcloud[..., 0:3].contiguous()
        features = pointcloud[..., 3:] if pointcloud.shape[-1] > 3 else None
        l_xyz, l_features = [xyz], [features]
        for k in range(self.n_sa):
            with trace.span(f"pointnet2.SA{k + 1}"):
                li_xyz, li_feat = getattr(self, f"SetAbstractionMSG_{k}")(l_xyz[k],
                                                                          l_features[k])
            l_xyz.append(li_xyz)
            l_features.append(li_feat)
        for j, i in enumerate(range(-1, -(self.n_fp + 1), -1)):
            with trace.span(f"pointnet2.FP{j + 1}"):
                l_features[i - 1] = getattr(self, f"FeaturePropagation_{j}")(
                    l_xyz[i - 1], l_xyz[i], l_features[i - 1], l_features[i])
        return l_xyz[0], l_features[0]
