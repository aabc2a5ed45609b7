"""The SA stages' grouped MLP + max against its roofline, in %: over every
``SharedMLP`` call on a neighbourhood (``group_args``, or a (B, S, K, C)
input with the max over K), the sum of each call's least time over the sum
of its device spans (CUDA events around the call).  It is timed at the
model layer's call, not by kernel name, so it reads the same work whatever
implements it (K2, the fused gather + MLP + max, today).

A call's least time (``harness/roofline.py``): its bytes over 3.35 TB/s or
its operations over bf16's 989 TF/s, whichever is longer.  Bytes: each
input read once (xyz, features, centroids and indices, or the grouped
input; the weights and biases) and the (B, S, Cout) f32 output written
once.  Operations: 2 x rows x Cin x Cout a layer at the B x S x K
neighbourhood rows, except layer 0's feature half, which needs only
min(B x N, B x S x K) rows (it commutes with the gather)."""

import torch

from benchmark.harness import roofline
from pointrcnn_tpu_torch.models.layers import SharedMLP


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor))


def _bound_s(mod, x, group_args):
    widths = [getattr(mod, f"w{i}").shape for i in range(mod.n)]
    params = [p for p in mod.parameters()]
    cout = widths[-1][1]
    if group_args is not None:
        xyz, feats, new_xyz, idx, use_xyz = group_args
        B, S, K = idx.shape
        N = xyz.shape[1]
        rows = B * S * K
        c_feat = feats.shape[-1] if feats is not None else 0
        c_xyz = widths[0][0] - c_feat
        ops = 2.0 * widths[0][1] * (rows * c_xyz + min(B * N, rows) * c_feat)
        n_bytes = _nbytes(xyz, feats, new_xyz, idx, *params) + B * S * cout * 4
    else:
        B, S, K = x.shape[:3]
        rows = B * S * K
        ops = 2.0 * rows * widths[0][0] * widths[0][1]
        n_bytes = _nbytes(x, *params) + B * S * cout * 4
    for cin, c in widths[1:]:
        ops += 2.0 * rows * cin * c
    return roofline.bound_s(n_bytes, ops)[0]


def install(d):
    spans = d.spans

    def pre(mod, args, kwargs):
        x = args[0] if args else kwargs.get("x")
        group_args = kwargs.get("group_args")
        grouped = group_args is not None or (
            kwargs.get("reduce_max", False) and x is not None and x.dim() == 4)
        mod._bench_open = grouped
        if grouped:
            mod._bench_bound = _bound_s(mod, x, group_args)
            spans.enter("sa_group_mlp")

    def post(mod, args, kwargs, out):
        if mod._bench_open:
            start, end = spans.exit()
            spans.calls["sa_group_mlp"].append((start, end, mod._bench_bound))

    for m in d.model.modules():
        if isinstance(m, SharedMLP):
            m.register_forward_pre_hook(pre, with_kwargs=True)
            m.register_forward_hook(post, with_kwargs=True)


def read(d):
    calls = d.window_calls.get("sa_group_mlp")
    if not calls:
        return None
    torch.cuda.synchronize()
    span_s = sum(s.elapsed_time(e) for s, e, _ in calls) * 1e-3
    return 100.0 * sum(b for _, _, b in calls) / span_s
