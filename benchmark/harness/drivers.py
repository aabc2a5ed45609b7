"""The drivers of the steps a traffic mix feeds, through the program's
public entry points.

``step`` in ``traffic/<mix>.json`` picks the step (``spec.load_step``): a
built-in step's driver is one of these two (``harness/builtin.py``), a
step module's (``steps/<step>.py``) is its own ``Driver``, as a rule a
subclass of ``Driver`` below, which holds the cell, its seeds, the scene
pool and the window's counts.  The built-in steps:

- ``"eval"``: ``eval.evaluator.build_joint_eval_step(model, cfg,
  with_gt=True)``, the two-stage forward then ``joint_postprocess``, in a
  closed loop: each batch is uploaded from host memory, and the outputs
  the eval CLI fetches (boxes, scores, selections, recall IoUs) come back
  to the host before the next batch goes in;
- ``"train"``: ``train.state.make_train_step`` with the optimizer of
  ``train/optimizer.py`` (``adam_onecycle`` over 200 epochs of the KITTI
  train split, BN momentum of epoch 0, as ``entry.train_entry`` sets
  them), each step's batch uploaded from host memory and its loss read
  back, as the train CLI logs it.

A driver's ``setup`` builds the program once from the seed and runs the
first steps (which build and warm every kernel of the cell's shapes);
``window`` drives the same objects for the measured seconds; ``extra``
runs steps past the window for the profiler; ``evidence`` is what the
output check compares.  The whole interface is the contract in
``spec.py``'s docstring.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import flops, scenes, weights

# the KITTI train split and the CLI's default epochs size the schedules
KITTI_TRAIN_FRAMES = 3712
TRAIN_EPOCHS = 200
# the eval CLI's fetch of a joint batch's outputs (evaluator.eval_one_epoch_joint)
EVAL_FETCH = ("pred_boxes3d", "raw_scores", "norm_scores", "sel_idx", "sel_valid",
              "gt_max_iou", "roi_gt_max_iou")
# the model outputs the check compares, beside the post-processed ones
EVAL_KEEP = ("rpn_cls", "rpn_reg", "backbone_xyz", "backbone_features", "rois",
             "roi_scores_raw", "roi_valid", "seg_result", "rcnn_cls", "rcnn_reg")
# eval batches whose outputs the check compares: this many, drawn from the seed
# among the first EVAL_SAMPLE_RANGE of the window
EVAL_SAMPLES, EVAL_SAMPLE_RANGE = 3, 48
# train steps the reference follows (run at set-up through the window's call)
CHECK_STEPS = 3


def sub_seeds(seed: int) -> dict:
    """Independent seeds for the weights, the scenes and the program's
    step stream, derived from ``--seed``."""
    ss = np.random.SeedSequence(seed).generate_state(3, dtype=np.uint32)
    return {"weights": int(ss[0]), "scenes": int(ss[1]), "step": int(ss[2]) % 2 ** 31}


def _upload(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu")


class Driver:
    """State shared by every driver: the cell, its config and seeds, the
    host pool, and the window's counts."""

    def __init__(self, cell, cfg, seed: int, device):
        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, torch.device(device)
        self.traffic = cell.traffic
        self.seeds = sub_seeds(seed)
        self.batch = int(self.traffic["batch"])
        num_points, max_gt = self.pool_sizes()
        self.pool = scenes.pool(self.seeds["scenes"], int(self.traffic["pool_batches"]),
                                self.batch, num_points, float(self.traffic["points_scale"]),
                                tuple(self.traffic["cars"]), max_gt)
        self.step_s: list[float] = []
        self.attempted = self.failed = 0
        self.frames = 0
        self.window_s = 0.0
        self.next = 0  # the pool batch the next step takes

    def pool_sizes(self) -> tuple[int, int]:
        """The points and the gt-box slots of a frame of the scene pool, by
        the config's names; a driver whose config names them otherwise
        overrides this."""
        return self.cfg.RPN.NUM_POINTS, self.cfg.RCNN.MAX_GT_BOXES

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float) -> None:
        """Steps until ``seconds`` have passed; the last one ends synchronised."""
        self._sync()
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            ts = time.perf_counter()
            ok = self.one(i)
            te = time.perf_counter()
            self.step_s.append(te - ts)
            self.attempted += 1
            self.failed += 0 if ok else 1
            self.frames += self.batch
            self.after(i)
            i += 1
            if te >= deadline:
                break
        self.window_s = te - t0

    def extra(self, steps: int) -> None:
        for _ in range(steps):
            self.one(None)
        self._sync()

    def after(self, i: int) -> None:
        """Work after step ``i`` of the window, outside its timing."""


class EvalDriver(Driver):
    """The joint eval step in a closed loop."""

    def setup(self, warm: int = 2) -> None:
        from pointrcnn_tpu_torch.eval.evaluator import build_joint_eval_step
        from pointrcnn_tpu_torch.models.point_rcnn import PointRCNN

        cfg = self.cfg
        model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0))
        self.model = model.to(self.device).eval()
        self.state = weights.seeded_state(self.model, cfg, self.seeds["weights"], self.device)
        weights.load(self.model, self.state)
        self.step = build_joint_eval_step(self.model, cfg, with_gt=True)
        self._last = {}
        self.model.register_forward_hook(lambda m, a, o: self._last.__setitem__("out", o))
        rng = np.random.RandomState(self.seeds["scenes"] % 2 ** 32 ^ 0x5EED)
        self.samples = set(rng.choice(EVAL_SAMPLE_RANGE, EVAL_SAMPLES, replace=False).tolist())
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
            got = {k: host(out[k]) for k in EVAL_FETCH}
        except RuntimeError as e:
            print(f"eval batch {i}: {type(e).__name__}: {e}", flush=True)
            return False
        self._out = out
        return all(bool(torch.isfinite(v.float()).all()) for v in got.values())

    def after(self, i: int) -> None:
        if i in self.samples:
            b = self.pool[(self.next - 1) % len(self.pool)]
            rec = {"window_index": i, "batch": b}
            rec.update({k: host(v) for k, v in self._last["out"].items() if k in EVAL_KEEP})
            rec["post"] = {k: host(v) for k, v in self._out.items()
                           if k in EVAL_FETCH or k == "pred_cls"}
            self.evidence.append(rec)

    def flops_per_step(self) -> float:
        return flops.eval_forward_flops(self.cfg).mlp * self.batch

    def release(self) -> None:
        for name in ("model", "step", "_last", "_out"):
            self.__dict__.pop(name, None)


def gt_on_proposals(model, cfg, batch: dict, device, proposal_layer=None) -> dict:
    """The rcnn stage's scenes: each frame's valid gt boxes moved onto its
    first valid TRAIN proposals of the fixed RPN (as many as it has boxes,
    fewer if it has fewer proposals), ``entry.gt_on_proposals``' rule.
    Behind an RPN of random weights no proposal overlaps a planted box, and
    the stage would sample no foreground roi; behind a trained RPN it
    samples up to ``FG_RATIO`` of them, which this restores.  The boxes are
    part of the host batch that both the program and the reference get.
    ``proposal_layer`` defaults to the program's."""
    if proposal_layer is None:
        from pointrcnn_tpu_torch.models.proposal import proposal_layer

    with torch.no_grad():
        out = model.rpn(torch.from_numpy(batch["pts_input"]).to(device))
        rois, _, valid = proposal_layer(cfg, "TRAIN", out["rpn_cls"][..., 0], out["rpn_reg"],
                                        out["backbone_xyz"])
    rois, valid = rois.cpu().numpy(), valid.cpu().numpy()
    boxes = np.zeros_like(batch["gt_boxes3d"])
    keep = np.zeros_like(batch["gt_valid"])
    for b in range(boxes.shape[0]):
        sel = np.nonzero(valid[b])[0][: int(batch["gt_valid"][b].sum())]
        boxes[b, :len(sel)] = rois[b, sel]
        keep[b, :len(sel)] = True
    return {**batch, "gt_boxes3d": boxes, "gt_valid": keep}


class Capture:
    """While open, what the proposal and target layers of ``module`` (the
    program's ``models.point_rcnn`` by default) take and give in each step,
    on the host: the output check follows the program from them.  Nothing
    is captured in a stage without proposals."""

    def __init__(self, active: bool, module=None):
        self.active, self.steps, self._mod = active, [], module

    def __enter__(self):
        if not self.active:
            return self
        if self._mod is None:
            from pointrcnn_tpu_torch.models import point_rcnn

            self._mod = point_rcnn
        point_rcnn = self._mod
        self.originals = (point_rcnn.proposal_layer, point_rcnn.proposal_target_layer)
        prop, target = self.originals

        def proposal_layer(cfg, mode, scores, reg, xyz):
            out = prop(cfg, mode, scores, reg, xyz)
            self.steps.append({"rpn_scores": host(scores), "rpn_reg": host(reg),
                               "xyz": host(xyz), "proposals": tuple(host(o) for o in out)})
            return out

        def proposal_target_layer(*a, **kw):
            out = target(*a, **kw)
            self.steps[-1]["target"] = {k: host(out[k]) for k in ("roi_boxes3d", "cls_label",
                                                                  "reg_valid_mask")}
            return out

        point_rcnn.proposal_layer, point_rcnn.proposal_target_layer = proposal_layer, \
            proposal_target_layer
        return self

    def __exit__(self, *exc):
        if self.active:
            self._mod.proposal_layer, self._mod.proposal_target_layer = self.originals


class TrainDriver(Driver):
    """The ``make_train_step`` step of the stage the traffic's overrides set."""

    def setup(self) -> None:
        from pointrcnn_tpu_torch.train.optimizer import (
            bn_momentum_for_epoch,
            build_optimizer,
            steps_for,
        )
        from pointrcnn_tpu_torch.train.state import create_train_state, make_train_step

        cfg = self.cfg
        self.tx = build_optimizer(cfg, *steps_for(KITTI_TRAIN_FRAMES, self.batch, TRAIN_EPOCHS))
        self.state = create_train_state(cfg, self.tx, seed=0, device=self.device)
        self.model = self.state.model
        seeded = weights.seeded_state(self.model, cfg, self.seeds["weights"], self.device)
        weights.load(self.model, seeded)
        del seeded
        if self.traffic.get("gt_on_proposals"):
            self.pool = [gt_on_proposals(self.model, cfg, b, self.device) for b in self.pool]
        self.theta0 = {k: host(v).clone() for k, v in self.model.state_dict().items()}
        self.step = make_train_step(cfg, self.tx, self.seeds["step"])
        self.momentum = bn_momentum_for_epoch(cfg, 0)
        # the first steps, through the window's own call, on distinct batches;
        # in a stage with proposals, what the proposal and target layers gave
        self.losses, self.stages = [], []
        with Capture(cfg.RCNN.ENABLED) as cap:
            for k in range(CHECK_STEPS):
                self.one(None)
                self.losses.append(self._loss)
                if k == 0:
                    self.mu1 = {n: host(v).clone() for n, v in self.state.opt_state["mu"].items()}
        self.stages = cap.steps
        self.theta3 = {k: host(v).clone() for k, v in self.model.named_parameters()}
        self._sync()

    def one(self, i) -> bool:
        b = self.pool[self.next % len(self.pool)]
        self.next += 1
        try:
            dev = _upload(b, self.device)
            self.state, tb = self.step(self.state, dev, self.momentum)
            self._loss = float(tb["loss"])
        except RuntimeError as e:
            print(f"train step {i}: {type(e).__name__}: {e}", flush=True)
            self._loss = float("nan")
            return False
        return bool(np.isfinite(self._loss))

    def stage(self) -> str:
        return "rpn" if not self.cfg.RCNN.ENABLED else ("rcnn" if self.cfg.RPN.FIXED
                                                        else "joint")

    def flops_per_step(self) -> float:
        return flops.train_step_flops(self.cfg, self.stage(), self.batch).mlp

    def evidence_record(self) -> dict:
        return {"theta0": self.theta0, "mu1": self.mu1, "theta3": self.theta3,
                "losses": self.losses, "batches": self.pool[:CHECK_STEPS],
                "step_seed": self.seeds["step"], "stages": self.stages}

    def release(self) -> None:
        del self.state, self.model, self.step


# the built-in steps' drivers (harness/builtin.py; trace_audit.py)
DRIVERS = {"eval": EvalDriver, "train": TrainDriver}
