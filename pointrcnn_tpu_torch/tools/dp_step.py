"""Data-parallel steps of the port's rpn train stage under torchrun, on the
card unless ``--device`` says otherwise:

    torchrun --standalone --nproc_per_node N -m pointrcnn_tpu_torch.tools.dp_step \\
        --out DIR [--batch 16] [--steps 3] [--device cuda] [--dist_backend nccl] \\
        [--set KEY VALUE ...]

Every rank builds ``entry.train_entry``'s rpn state and synthetic batch of
``--batch`` frames (the global batch; weights from seed 0, then broadcast
from rank 0), keeps its slice (``parallel.mesh.shard_batch``) and runs
``--steps`` data-parallel steps (``entry.rpn_config`` with the ``--set``
overrides).  ``--device cuda`` puts
rank r on ``cuda:r`` (``nccl``); ``--device cuda:0 --dist_backend gloo`` puts every
rank on one card (NCCL refuses two ranks on one card).  Each rank writes
``DIR/rank<r>.json``: every step's loss and gradient norm (the global
batch's), its wall ms (the step ends in a synchronise), the peak memory,
and the kernels' launches over the steps; rank 0 also writes the
parameters and BN statistics after the first step (``DIR/state1.pt``) and
after the last (``DIR/state.pt``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="data-parallel rpn train steps of the port")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--batch", type=int, default=16, help="the global batch")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dist_backend", type=str, default=None)
    p.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from pointrcnn_tpu_torch.entry import rpn_config, train_entry
    from pointrcnn_tpu_torch.ops import counts
    from pointrcnn_tpu_torch.parallel import mesh

    with mesh.process_group(args.device, args.dist_backend) as device:
        step, (state, batch) = train_entry(args.batch, device, 0, rpn_config(args.set_cfgs))
        mesh.replicate(state.model)
        local = mesh.shard_batch(batch)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        counts.reset()
        record = {"rank": mesh.rank(), "world": mesh.world(), "backend": mesh.backend(),
                  "device": str(device), "frames": int(local["pts_input"].shape[0]),
                  "loss": [], "grad_norm": [], "ms": []}
        os.makedirs(args.out, exist_ok=True)

        def save(name):
            if mesh.rank() == 0:
                torch.save({k: v.detach().cpu() for k, v in state.model.state_dict().items()},
                           os.path.join(args.out, name))

        for i in range(args.steps):
            t0 = time.perf_counter()
            state, tb = step(state, local)
            if cuda:
                torch.cuda.synchronize(device)
            record["ms"].append(1000 * (time.perf_counter() - t0))
            record["loss"].append(float(tb["loss"]))
            record["grad_norm"].append(float(tb["grad_norm"]))
            if i == 0:
                save("state1.pt")
        record["launches"] = counts.read()
        record["peak_bytes"] = torch.cuda.max_memory_allocated(device) if cuda else None
        with open(os.path.join(args.out, f"rank{mesh.rank()}.json"), "w") as f:
            json.dump(record, f)
        save("state.pt")
        mesh.barrier()
        return record


if __name__ == "__main__":
    main(sys.argv[1:])
