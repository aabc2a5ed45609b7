"""The output check's control and planted faults, at a cell's own size.

    python benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--control fp8|half]

Puts the reference in the program's place on a cell's inputs from each
seed, computed as the control asks, and prints, per seed, the numbers
``run.py`` compares against their limits.  The cell's step supplies them
(its ``control_numbers``: a built-in step's in ``harness/builtin.py``, a
step module's in ``steps/<step>.py``; ``harness/spec.py``).  The built-in
steps take the same weights, scene pool, sampled batches and first
training steps as ``run.py``, and:

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
    """The numbers of ``cell``'s output check with its step's control."""
    from benchmark.harness import spec

    step = spec.load_step(cell.traffic["step"], cell.bench)
    return step.control_numbers(cell, seed, control, device)


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
