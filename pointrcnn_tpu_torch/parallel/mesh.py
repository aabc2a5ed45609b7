"""Data parallel over ``torch.distributed`` (counterpart of
``pointrcnn_tpu/parallel/mesh.py``).

JAX jits one program over a batch-sharded mesh: parameters replicated, the
batch's axis 0 split over the ``data`` axis, and the partitioner inserts
the reductions, so the program computes what one device computes on the
global batch.  The port writes that program out over a process group of
``world()`` ranks, each holding the contiguous slice of axis 0 that
``P("data")`` gives it (:func:`shard_batch`):

- every statistic of the global batch (the batch norms' sums of y and y^2,
  each loss's normaliser, the metrics' counts) is summed across ranks by
  :func:`all_reduce_sum`, whose backward sums the cotangent too, so a
  rank's loss is its rows' share of the global loss;
- random draws are made for the global batch from the step's generator,
  seeded alike on every rank, and each rank keeps its rows
  (:func:`local_rows`);
- after backward the gradients are summed across ranks
  (:func:`all_reduce_grads`), so every rank applies the same update.

Without a process group (or in a group of one) every function here is the
identity, and the port computes what it computes on one device.  Every
training rank must hold the same number of rows: the batch norms take the
global row count as ``world()`` times their own.
"""

from __future__ import annotations

import contextlib
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# the gradient all-reduce's bucket: flat f32 buffers of at most this many
# bytes, one collective each
GRAD_BUCKET_BYTES = 32 << 20


def active() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world() -> int:
    return dist.get_world_size() if active() else 1


def backend() -> str | None:
    return dist.get_backend() if active() else None


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, rank_: int | None = None) -> torch.device:
    """``device`` for this rank: ``cuda`` without an index is
    ``cuda:<LOCAL_RANK>`` (an error past the card count), anything else
    stays."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and (active() or rank_ is not None):
        local = int(os.environ.get("LOCAL_RANK", rank() if rank_ is None else rank_))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card: "
                               f"{torch.cuda.device_count()} visible")
        dev = torch.device("cuda", local)
    return dev


def init_group(rank_: int, world_size: int, device, backend: str | None = None,
               init_method: str = "env://", timeout_s: float = 600.0) -> torch.device:
    """Join a process group of ``world_size`` ranks as ``rank_`` -> this
    rank's device.  ``device`` ``cuda`` means ``cuda:<LOCAL_RANK>`` (an error
    past the card count); a device with an index pins every rank to it (two
    ranks on one card need ``gloo``: NCCL refuses that).  The backend is
    ``nccl`` on a card, ``gloo`` on the CPU, unless ``backend`` names one.
    A failure to start the group raises: no rank runs alone."""
    dev = rank_device(device, rank_)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method=init_method,
                            rank=rank_, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


@contextlib.contextmanager
def process_group(device, backend: str | None = None):
    """Within: the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT``) -> this rank's device; the group is destroyed on the
    way out.  Outside torchrun (no ``RANK``) there is no group and
    ``device`` is yielded as it is; in a group the caller started, the
    rank's device (:func:`rank_device`), and the group stays."""
    if active() or "RANK" not in os.environ:
        yield rank_device(device)
        return
    dev = init_group(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), device, backend)
    try:
        yield dev
    finally:
        teardown()


def teardown() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def shard_bounds(n: int, rank_: int | None = None, world_: int | None = None,
                 even: bool = True) -> tuple[int, int]:
    """The rows [lo, hi) of axis 0 that rank ``rank_`` of ``world_`` holds:
    contiguous equal slices, as ``P("data")`` lays out.  ``even`` (training:
    every collective assumes equal shards) makes a batch that the world does
    not divide an error; without it (eval, whose forward reduces nothing
    across ranks) the slices differ by one row at most."""
    rank_ = rank() if rank_ is None else rank_
    world_ = world() if world_ is None else world_
    if even and n % world_:
        raise ValueError(f"a batch of {n} frames does not divide over a world of "
                         f"{world_} ranks")
    return n * rank_ // world_, n * (rank_ + 1) // world_


def shard_batch(batch: dict, rank_: int | None = None, world_: int | None = None,
                even: bool = True, n: int | None = None) -> dict:
    """The rank's contiguous slice of axis 0 of every array (numpy or
    tensor) in ``batch`` whose leading size is the batch's, ``n`` (default
    ``pts_input``'s leading size); other values pass as they are."""
    world_ = world() if world_ is None else world_
    if world_ == 1:
        return batch
    n = batch["pts_input"].shape[0] if n is None else n
    lo, hi = shard_bounds(n, rank_, world_, even)
    return {k: v[lo:hi] if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim > 0
            and v.shape[0] == n else v for k, v in batch.items()}


def local_rows(t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``t``, a draw made for the global batch: axis 0
    is ``world()`` times the rank's."""
    w = world()
    if w == 1:
        return t
    n = t.shape[0] // w
    return t[rank() * n:(rank() + 1) * n]


def global_shape(shape) -> tuple:
    """``shape`` of the rank's rows -> the global batch's (axis 0 times
    ``world()``)."""
    return (shape[0] * world(), *shape[1:])


class _AllReduceSum(torch.autograd.Function):
    """Sum across ranks; the backward sums the cotangent across ranks too
    (each rank's loss is a share of the global loss, and every share
    depends on the sum)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed across ranks, differentiably; ``x`` itself in a world
    of one."""
    if world() == 1:
        return x
    return _AllReduceSum.apply(x)


def all_reduce_grads(grads: list[torch.Tensor],
                     bucket_bytes: int = GRAD_BUCKET_BYTES) -> list[torch.Tensor]:
    """Gradients summed across ranks: packed into flat buffers of at most
    ``bucket_bytes`` (a larger gradient takes one of its own), one
    all-reduce each, nothing read back to the host.  ``grads`` itself in a
    world of one."""
    if world() == 1:
        return grads
    out = list(grads)
    bucket, size = [], 0

    def flush():
        if not bucket:
            return
        flat = torch.cat([grads[i].reshape(-1) for i in bucket])
        dist.all_reduce(flat)
        offset = 0
        for i in bucket:
            n = grads[i].numel()
            out[i] = flat[offset:offset + n].view_as(grads[i])
            offset += n
        bucket.clear()

    for i, g in enumerate(grads):
        nbytes = g.numel() * g.element_size()
        if bucket and (size + nbytes > bucket_bytes or g.dtype != grads[bucket[0]].dtype):
            flush()
            size = 0
        bucket.append(i)
        size += nbytes
    flush()
    return out


def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``model`` broadcast from rank 0 (in
    place), so all ranks start from rank 0's state."""
    if active():
        with torch.no_grad():
            for t in [*model.parameters(), *model.buffers()]:
                dist.broadcast(t.data, 0)
    return model


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, 0)
    return box[0]


def gather_to_rank0(obj) -> list | None:
    """Every rank's ``obj`` (picklable), in rank order, on rank 0; ``None``
    on the others.  ``[obj]`` without a group."""
    if not active():
        return [obj]
    out = [None] * world() if rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
