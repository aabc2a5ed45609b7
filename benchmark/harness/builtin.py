"""The built-in steps, ``"eval"`` and ``"train"``, under the step contract of
``spec.py``: PointRCNN's configs through the port's ``config.load_config``,
the drivers of ``drivers.py``, and the output check and control of
``check.py`` over the PointRCNN reference (``benchmark/reference``).

- ``check``: once the window has closed, the program's state is freed and
  the reference reruns what the driver kept (eval: the window batches
  drawn from the seed, stage by stage; training: the first steps from the
  same weights, batches and step seed);
- ``control_numbers``: the reference in the program's place on a cell's
  inputs from a seed (the same weights, scene pool, sampled batches and
  first training steps as a run): ``fp8``, the reference a precision
  lower (eval always so), or ``half``, a training step over half of the
  batch.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, drivers, scenes, weights
from pointrcnn_tpu_torch.config import load_config


def _free(d) -> None:
    """The program's state released before the reference runs."""
    d.release()
    gc.collect()
    torch.cuda.empty_cache()


def _control_pool(cell, cfg, seed: int):
    seeds = drivers.sub_seeds(seed)
    t = cell.traffic
    pool = scenes.pool(seeds["scenes"], int(t["pool_batches"]), int(t["batch"]),
                       cfg.RPN.NUM_POINTS, float(t["points_scale"]), tuple(t["cars"]),
                       cfg.RCNN.MAX_GT_BOXES)
    return seeds, pool


def check_eval(d, cell, overrides) -> dict:
    device = d.device
    evidence, state = d.evidence, d.state
    _free(d)
    cfg = check.ref_config(cell.config_path, overrides)
    model = check.ref_eval_model(cfg, state, device)
    return check.worst([check.compare_eval(model, cfg, rec, device) for rec in evidence])


def check_train(d, cell, overrides) -> dict:
    device = d.device
    evidence = d.evidence_record()
    _free(d)
    cfg = check.ref_config(cell.config_path, overrides)
    ref = check.ref_train(cfg, cell.traffic, evidence, device)
    return check.compare_train(evidence, ref)


def control_eval(cell, seed: int, control: str, device) -> dict:
    from benchmark.reference.models.point_rcnn import PointRCNN

    cfg = check.ref_config(cell.config_path, list(cell.traffic.get("overrides", [])))
    seeds, pool = _control_pool(cell, cfg, seed)
    shape_model = PointRCNN(cfg, mode="TEST", generator=torch.Generator().manual_seed(0))
    state = weights.seeded_state(shape_model, cfg, seeds["weights"], device)
    model = check.ref_eval_model(cfg, state, device)
    rng = np.random.RandomState(seeds["scenes"] % 2 ** 32 ^ 0x5EED)
    picks = rng.choice(drivers.EVAL_SAMPLE_RANGE, drivers.EVAL_SAMPLES, replace=False)
    rows = []
    for i in picks:
        # the window's batch i follows the set-up's warm-up batches
        b = pool[(int(i) + 2) % len(pool)]
        rec = check.eval_outputs(model, cfg, b, device, lower=True)
        rows.append(check.compare_eval(model, cfg, rec, device))
    return check.worst(rows)


def control_train(cell, seed: int, control: str, device) -> dict:
    from benchmark.reference.models.point_rcnn import PointRCNN

    cfg = check.ref_config(cell.config_path, list(cell.traffic.get("overrides", [])))
    t = cell.traffic
    seeds, pool = _control_pool(cell, cfg, seed)
    shape_model = PointRCNN(cfg, mode="TRAIN", generator=torch.Generator().manual_seed(0))
    state = weights.seeded_state(shape_model, cfg, seeds["weights"], device)
    if t.get("gt_on_proposals"):
        from benchmark.reference.models.proposal import proposal_layer

        placer = shape_model.to(device)
        weights.load(placer, state)
        pool = [drivers.gt_on_proposals(placer, cfg, b, device, proposal_layer)
                for b in pool[:drivers.CHECK_STEPS]]
        shape_model = placer.to("cpu")
    theta0 = {k: v.to("cpu") for k, v in state.items()}
    for k, v in shape_model.state_dict().items():
        theta0.setdefault(k, v)
    evidence = {"theta0": theta0, "batches": pool[:drivers.CHECK_STEPS],
                "step_seed": seeds["step"]}
    got = check.ref_train(cfg, t, evidence, device, fault=None if control == "fp8" else control,
                          capture=True, lower=control == "fp8")
    # the truth follows the control's proposals, except past a fault that
    # changes the batch's frames
    stages = got.get("stages") if control == "fp8" else None
    ref = check.ref_train(cfg, t, {**evidence, "stages": stages}, device)
    return check.compare_train({**evidence, **got}, ref)


STEPS = {
    "eval": SimpleNamespace(load_config=load_config, Driver=drivers.DRIVERS["eval"],
                            PROFILED_STEPS=20, check=check_eval, control_numbers=control_eval),
    "train": SimpleNamespace(load_config=load_config, Driver=drivers.DRIVERS["train"],
                             PROFILED_STEPS=4, check=check_train, control_numbers=control_train),
}
