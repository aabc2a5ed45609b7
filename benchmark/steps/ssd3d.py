"""3DSSD's eval step (``evaluator.build_ssd3d_eval_step``), a family of its
own under the step contract of ``harness/spec.py``.

- ``load_config``: the port's ``ssd3d_config.load_config``;
- ``Driver``: the eval step in a closed loop, as the eval CLI runs it at
  its batch: each host batch uploaded, the step's outputs the CLI reads
  (boxes, scores, the NMS survivors, the recall IoUs) fetched back before
  the next batch goes in.  Frames are the scene generator's (xyz) with an
  intensity channel drawn uniform in [0, 1) from the seed
  (:func:`with_intensity`); weights are :func:`seeded_state`'s;
- ``check``: the reference (``benchmark/reference/ssd3d.py``, plain
  PyTorch f32, which imports nothing of the program) follows three window
  batches drawn from the seed stage by stage, each stage given the
  program's own inputs to it:

  - ``sample_mismatch``: indices of the D-FPS, F-FPS and fusion index sets
    of SA1-SA3 that differ (the reference's sampling on the program's xyz
    and features);
  - ``query_mismatch``: ball-query indices that differ, every scale of
    every SA stage and of the vote aggregation (on the program's centres
    and votes);
  - ``backbone_rel``: each SA stage's features on the program's
    neighbourhoods, the worst relative max-norm gap (the largest gap over
    the reference's largest magnitude);
  - ``vote_rel``: the clamped vote offsets (votes less candidates) on the
    program's SA3 output, the largest gap over the output layer's largest
    sum of absolute products (``|h| |W| + |b|``, the reference's hidden
    ``h``), the scale that bounds that layer's rounding error: the
    offsets' own largest magnitude falls 2-17x below it with the seed, so
    a gap over the offsets' magnitude spread sound runs into the fp8
    control's range;
  - ``head_rel``: the head's outputs, ``cls`` and ``reg`` side by side (31
    values a vote), of the vote aggregation and the head on the program's
    votes and neighbourhoods: one tensor, so the gap is over the head's
    output scale (``cls`` alone is one logit a vote whose largest magnitude
    moves 1.2-3.4 with the seed while its rounding error stays 0.02-0.03);
  - ``post_box_rel`` and ``post_sel_mismatch``: the decoded boxes and the
    NMS survivors' slots that differ, on the program's ``cls``, ``reg`` and
    votes;

- ``control_numbers``: the reference in the program's place on a cell's
  inputs from a seed: ``fp8`` (the nearest precision below the config's
  bf16: every matmul operand rounded to fp8 e4m3, one scale a tensor) or
  ``half`` (a fault: each batch's second half of frames given the first
  half's outputs).
"""

from __future__ import annotations

import contextlib
import gc
import math

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from benchmark.harness import check as checks
from benchmark.harness import drivers, scenes, ssd3d_cost
from benchmark.reference import ssd3d as ref

PROFILED_STEPS = 20
# gt-box slots a frame (the scenes' 2-8 cars)
MAX_GT = 16
# the car's half sizes (l, h, w) the regression's size channels start at
CAR_HALF_LHW = (1.94, 0.76, 0.81)
FETCH = ("pred_boxes3d", "scores", "sel_idx", "sel_valid", "gt_max_iou")
KEEP = ("sa1_xyz", "sa2_xyz", "sa3_xyz", "sa1_features", "sa2_features", "sa3_features",
        "sa1_sample_idx", "sa2_sample_idx", "sa3_sample_idx", "sa1_query_idx",
        "sa2_query_idx", "sa3_query_idx", "votes", "agg_query_idx", "cls", "reg")


def load_config(path: str, overrides: list):
    from pointrcnn_tpu_torch.ssd3d_config import load_config as load

    return load(path, list(overrides))


def with_intensity(pool: list, seed: int) -> list:
    """Each batch's ``pts_input`` with a fourth value a point, its intensity,
    uniform in [0, 1) from ``seed``."""
    rng = np.random.RandomState((seed ^ 0x1A7E) % 2 ** 32)
    out = []
    for b in pool:
        pts = b["pts_input"]
        inten = rng.rand(*pts.shape[:2], 1).astype(np.float32)
        out.append({**b, "pts_input": np.concatenate([pts, inten], axis=-1)})
    return out


def _scaled(name: str, shape, u: torch.Tensor) -> torch.Tensor:
    """``u`` in [0, 1) -> the leaf ``name`` of ``shape``: a SharedMLP weight
    ``w{i}`` (in, out) U(+-sqrt(6 / fan_in)); an output layer's ``weight``
    (out, in) U(+-sqrt(3 / fan_in)), the regression's scaled by 0.1; the
    regression's size biases at a car's half sizes; BN scales U(0.9, 1.1),
    variances U(0.8, 1.2); every other bias and mean U(+-0.05)."""
    s = 2 * u - 1
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 2:
        if leaf == "weight":
            lim = math.sqrt(3.0 / shape[1]) * (0.1 if name.startswith("reg_out") else 1.0)
        else:
            lim = math.sqrt(6.0 / shape[0])
        return s * lim
    if leaf.endswith("scale"):
        return 1.0 + 0.1 * s
    if leaf.endswith("var"):
        return 1.0 + 0.2 * s
    out = 0.05 * s
    if name == "reg_out.bias":
        out[3:6] += torch.tensor(CAR_HALF_LHW, device=out.device)
    return out


def seeded_state(model: torch.nn.Module, seed: int, device) -> dict:
    """Every float leaf of ``model`` from one uniform draw of ``seed`` on
    ``device``, scaled to its kind (:func:`_scaled`)."""
    leaves = [(k, v) for k, v in model.state_dict().items() if v.is_floating_point()]
    total = sum(v.numel() for _, v in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for k, v in leaves:
        n = v.numel()
        out[k] = _scaled(k, tuple(v.shape), u[off:off + n].view(v.shape)).contiguous()
        off += n
    return out


def _shape_model(cfg):
    from pointrcnn_tpu_torch.models.ssd3d import SSD3D

    return SSD3D(cfg, generator=torch.Generator().manual_seed(0))


def _upload(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _host(v):
    if isinstance(v, (list, tuple)):
        return [drivers.host(t) for t in v]
    return drivers.host(v)


class Driver(drivers.Driver):
    """3DSSD's eval step in a closed loop."""

    def __init__(self, cell, cfg, seed: int, device):
        super().__init__(cell, cfg, seed, device)
        self.pool = with_intensity(self.pool, self.seeds["scenes"])

    def pool_sizes(self) -> tuple[int, int]:
        return self.cfg.NUM_POINTS, MAX_GT

    def setup(self, warm: int = 2) -> None:
        from pointrcnn_tpu_torch.eval.evaluator import build_ssd3d_eval_step

        self.model = _shape_model(self.cfg).to(self.device).eval()
        self.state = seeded_state(self.model, self.seeds["weights"], self.device)
        self.model.load_state_dict(self.state)
        self.step = build_ssd3d_eval_step(self.model, self.cfg, with_gt=True)
        self._last = {}
        self.model.register_forward_hook(lambda m, a, o: self._last.__setitem__("out", o))
        rng = np.random.RandomState(self.seeds["scenes"] % 2 ** 32 ^ 0x5EED)
        self.samples = set(rng.choice(drivers.EVAL_SAMPLE_RANGE, drivers.EVAL_SAMPLES,
                                      replace=False).tolist())
        self.evidence = []
        for _ in range(warm):
            self.one(None)
        self._sync()

    def one(self, i) -> bool:
        b = self.pool[self.next % len(self.pool)]
        self.next += 1
        try:
            dev = _upload(b, self.device)
            out = self.step(dev["pts_input"], dev["gt_boxes3d"], dev["gt_valid"])
            got = {k: drivers.host(out[k]) for k in FETCH}
        except RuntimeError as e:
            print(f"eval batch {i}: {type(e).__name__}: {e}", flush=True)
            return False
        self._out = got
        return all(bool(torch.isfinite(v.float()).all()) for v in got.values())

    def after(self, i: int) -> None:
        if i in self.samples:
            rec = {"window_index": i, "batch": self.pool[(self.next - 1) % len(self.pool)]}
            rec.update({k: _host(v) for k, v in self._last["out"].items() if k in KEEP})
            rec["post"] = self._out
            self.evidence.append(rec)

    def flops_per_step(self) -> float:
        return ssd3d_cost.step_flops(self.cfg, self.batch)

    def release(self) -> None:
        for name in ("model", "step", "_last", "_out"):
            self.__dict__.pop(name, None)


# ---------------------------------------------------------------- the check


def _mismatch(a, b) -> int:
    a, b = a.long().cpu(), b.long().cpu()
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    return int((a != b).sum())


def _gap_over(p: torch.Tensor, r: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest gap between ``p`` and ``r`` over ``scale``'s largest
    value (inf where ``p`` is not finite)."""
    p, r = p.to(torch.float32), r.to(torch.float32)
    if p.shape != r.shape or not bool(torch.isfinite(p).all()):
        return float("inf")
    return float((p - r).abs().max() / scale.to(torch.float32).max().clamp(min=1e-30))


def _kept(sel_idx, sel_valid, width: int) -> torch.Tensor:
    """A frame's survivors as ``width`` slots, -1 past them."""
    out = torch.full((width,), -1, dtype=torch.int64)
    k = sel_idx[sel_valid].long()[:width]
    out[:len(k)] = k
    return out


def compare(p: dict, cfg: dict, rec: dict, device) -> dict:
    """The numbers of one batch's evidence ``rec`` (the program's, or the
    control's in its place), the reference given each stage's inputs."""
    dev = lambda t: t.to(device)  # noqa: E731
    pts = dev(torch.from_numpy(rec["batch"]["pts_input"]))
    xyz, feats = pts[..., :3], pts[..., 3:]
    out = {"sample_mismatch": 0, "query_mismatch": 0, "backbone_rel": 0.0}
    with torch.inference_mode():
        for k in range(3):
            s = f"sa{k + 1}"
            idx = ref.sa_sample(cfg, k, xyz, feats)
            out["sample_mismatch"] += _mismatch(idx, rec[f"{s}_sample_idx"])
            centres = dev(rec[f"{s}_xyz"])
            q = ref.sa_query(cfg, k, xyz, centres)
            out["query_mismatch"] += sum(_mismatch(a, b) for a, b in zip(q, rec[f"{s}_query_idx"]))
            f = ref.sa_features(p, cfg, k, xyz, feats, centres,
                                [dev(t) for t in rec[f"{s}_query_idx"]])
            out["backbone_rel"] = max(out["backbone_rel"],
                                      checks.rel_gap(rec[f"{s}_features"], f.cpu()))
            xyz, feats = centres, dev(rec[f"{s}_features"])
        vc = cfg["VOTE"]
        n = vc["NUM_POINTS"]
        seeds, f = xyz[:, :n], feats[:, :n]
        off = ref.votes(p, cfg, seeds, f) - seeds
        h = ref.stack(f, p, "vote_conv", len(vc["CONV"]), vc["BN_EPS"], False)
        scale = h.abs() @ p["vote_out.weight"].abs().t() + p["vote_out.bias"].abs()
        out["vote_rel"] = _gap_over(rec["votes"] - seeds.cpu(), off.cpu(), scale.cpu())
        votes = dev(rec["votes"])
        q = ref.agg_query(cfg, xyz, votes)
        out["query_mismatch"] += sum(_mismatch(a, b) for a, b in zip(q, rec["agg_query_idx"]))
        a = ref.agg_features(p, cfg, xyz, feats, votes, [dev(t) for t in rec["agg_query_idx"]])
        cls, reg = ref.head(p, cfg, a)
        out["head_rel"] = checks.rel_gap(torch.cat([rec["cls"], rec["reg"]], -1),
                                         torch.cat([cls, reg], -1).cpu())
        _, boxes, kept = ref.post(cfg, votes, dev(rec["cls"]), dev(rec["reg"]))
        out["post_box_rel"] = checks.rel_gap(rec["post"]["pred_boxes3d"], boxes.cpu())
        width = cfg["TEST"]["MAX_OUTPUT"]
        post = rec["post"]
        out["post_sel_mismatch"] = sum(
            _mismatch(_kept(post["sel_idx"][f], post["sel_valid"][f], width),
                      _kept(kept[f], torch.ones(len(kept[f]), dtype=torch.bool), width))
            for f in range(len(kept)))
    return out


def _reference_setup(cfg_node, state: dict, device):
    ref.f32_matmuls()
    return {k: v.to(device, torch.float32) for k, v in state.items()}, ref.plain(cfg_node)


def check(d, cell, overrides) -> dict:
    device = d.device
    evidence, state, cfg_node = d.evidence, d.state, d.cfg
    d.release()
    gc.collect()
    torch.cuda.empty_cache()
    p, cfg = _reference_setup(cfg_node, state, device)
    return checks.worst([compare(p, cfg, rec, device) for rec in evidence])


# ---------------------------------------------------------------- the control


class Fp8Matmul(TorchFunctionMode):
    """Every matmul's operands rounded to fp8 e4m3, one scale a tensor
    (``check._fp8``): the reference a precision below the config's bf16."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__) and len(args) == 2:
            args = tuple(checks._fp8(a) if a.is_floating_point() else a for a in args)
        return func(*args, **kwargs)


def _control_record(p, cfg, batch: dict, device, control: str) -> dict:
    """The reference's eval step in the program's place on one host batch,
    in the evidence's layout."""
    pts = torch.from_numpy(batch["pts_input"]).to(device)
    if control == "half":
        h = (pts.shape[0] + 1) // 2
        pts = torch.cat([pts[:h], pts[:pts.shape[0] - h]])
    with torch.inference_mode(), (Fp8Matmul() if control == "fp8" else contextlib.nullcontext()):
        o = ref.forward(p, cfg, pts)
        _, boxes, kept = ref.post(cfg, o["votes"], o["cls"], o["reg"])
    width = cfg["TEST"]["MAX_OUTPUT"]
    rec = {k: _host(v) for k, v in o.items() if k in KEEP}
    sel = torch.stack([_kept(k_, torch.ones(len(k_), dtype=torch.bool), width) for k_ in kept])
    rec["post"] = {"pred_boxes3d": boxes.cpu(), "sel_idx": sel.clamp(min=0),
                   "sel_valid": sel >= 0}
    rec["batch"] = batch
    return rec


def control_numbers(cell, seed: int, control: str, device) -> dict:
    cfg_node = load_config(str(cell.config_path), list(cell.traffic.get("overrides", [])))
    seeds, t = drivers.sub_seeds(seed), cell.traffic
    pool = scenes.pool(seeds["scenes"], int(t["pool_batches"]), int(t["batch"]),
                       cfg_node.NUM_POINTS, float(t["points_scale"]), tuple(t["cars"]), MAX_GT)
    pool = with_intensity(pool, seeds["scenes"])
    state = seeded_state(_shape_model(cfg_node), seeds["weights"], device)
    p, cfg = _reference_setup(cfg_node, state, device)
    rng = np.random.RandomState(seeds["scenes"] % 2 ** 32 ^ 0x5EED)
    picks = rng.choice(drivers.EVAL_SAMPLE_RANGE, drivers.EVAL_SAMPLES, replace=False)
    # the window's batch i follows the set-up's two warm-up batches
    rows = [compare(p, cfg, _control_record(p, cfg, pool[(int(i) + 2) % len(pool)], device,
                                            control), device)
            for i in picks]
    return checks.worst(rows)
