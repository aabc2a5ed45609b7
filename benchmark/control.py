"""The output check's control and planted faults, at a cell's own size.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--control fp8|half]

Puts the reference in the program's place on a cell's inputs from each
seed (the same weights, scene pool, sampled batches and first training
steps as ``run.py``), computed as the control asks, and prints, per seed,
the numbers ``run.py`` compares against their limits:

- ``fp8`` (the default): the reference in the nearest precision below the
  configuration's: its bf16 MLPs in fp8 e4m3 (every bf16 rounding first
  rounds to fp8, ``check.LowerPrecision``), its f32 stages (proposal layer,
  target layer, post-process) on bf16-rounded inputs;
- ``half`` (training cells): a step that leaves out half of the batch and
  takes its mean over the rest.

A limit must lie above what the program reads over a dozen seeds and below
what the control (and, for a training cell, each fault) reads here.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def control_numbers(cell, seed: int, control: str, device) -> dict:
    import numpy as np
    import torch

    from benchmark.harness import check, drivers, scenes, weights
    from benchmark.reference.models.point_rcnn import PointRCNN

    overrides = list(cell.traffic.get("overrides", []))
    cfg = check.ref_config(cell.config_path, overrides)
    t = cell.traffic
    seeds = drivers.sub_seeds(seed)
    batch = int(t["batch"])
    pool = scenes.pool(seeds["scenes"], int(t["pool_batches"]), batch, cfg.RPN.NUM_POINTS,
                       float(t["points_scale"]), tuple(t["cars"]), cfg.RCNN.MAX_GT_BOXES)
    if t["step"] == "eval":
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default="fp8", choices=("fp8", "half"))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import spec

    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        nums = control_numbers(cell, seed, args.control, "cuda")
        print(json.dumps({"workload": args.workload, "control": args.control, "seed": seed,
                          "numbers": nums, "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
