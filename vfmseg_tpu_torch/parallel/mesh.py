"""The data axis over ``torch.distributed``, and the global-batch reductions.

Port of vfmseg_tpu/parallel/mesh.py:22-40. The JAX package builds a
``data`` x ``model`` device mesh and runs one SPMD step over the global
batch: gradients are the global mean, BatchNorm moments are over the global
batch ("SyncBN equivalence") and so is every other batch-wide reduction.
Here each process (rank) holds one card (or, with ``--device cpu``, the
CPU through gloo) and its rows of the global batch; the step reaches the
same numbers by reducing each of those quantities over the group:

* :func:`all_reduce_sum` / :func:`all_reduce_mean` with autograd (the
  BatchNorm moments, ``models/common.py``) and without (the set loss's
  normalisers, DACS's pseudo-weight and the mean of the mixed weight that
  scales a MaskFormerSegmentor's mixed set losses, the accuracy's counts);
* :func:`average_gradients`: every trainable gradient in one flat fp32
  bucket, one ``all_reduce``, divided by the world size; no
  ``DistributedDataParallel`` wrapper, whose ``module.`` prefix would rename
  every parameter and the checkpoint layout with them;
* :func:`average_losses`: the logged loss entries.

The model axis must be 1: the JAX CLIs only ever build ``model=1``, and
its tensor-parallel rules (mesh.py:43-75) are not ported.

Launch (the port's ``tools/dist_train.sh``)::

    torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.train <config> \
        --distributed
    torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.test <config> \
        <checkpoint> --data-parallel N

:func:`init_distributed` reads torchrun's ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``: NCCL with each rank on
``cuda:LOCAL_RANK``, or gloo with ``--device cpu``. Nothing falls back from
one to the other.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Iterable, Mapping, Optional

import torch
import torch.distributed as dist

LAUNCH = ("torchrun --nproc-per-node N -m vfmseg_tpu_torch.tools.train "
          "<config> --distributed")
TIMEOUT_S = 600.0
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis: ``data`` processes, this one ``rank``, on
    ``device``."""

    data: int
    rank: int
    local_rank: int
    device: torch.device


def world_size() -> int:
    """The data group's size: 1 without an initialised process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device: str) -> torch.device:
    """This rank's device for a ``--device`` value: ``cuda:LOCAL_RANK`` for
    the card (torchrun's variable, 0 without it), else the device itself."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def make_mesh(data: int = -1, model: int = 1, device: str = "cuda",
              launch: str = LAUNCH) -> Mesh:
    """The data axis over the initialised process group (one process
    without one), this rank on ``rank_device(device)``. ``data`` -1 takes
    the world size; any other value must equal it (the error names the
    launch command ``launch``); ``model`` must be 1."""
    if model != 1:
        raise NotImplementedError("the model axis (tensor parallelism) is "
                                  "not ported: model must be 1")
    world = world_size()
    if data == -1:
        data = world
    if data != world:
        raise ValueError(f"a data axis of {data} over {world} processes: "
                         f"launch {data} (``{launch}``)")
    local = int(os.environ.get("LOCAL_RANK", 0))
    return Mesh(data, rank(), local, rank_device(device))


def init_distributed(device: str = "cuda", timeout_s: float = TIMEOUT_S,
                     launch: str = LAUNCH) -> Mesh:
    """Join the process group that torchrun's environment describes: NCCL
    with this rank on ``cuda:LOCAL_RANK`` when ``device`` is the card,
    gloo when it is ``cpu``. Raises, naming the launch command ``launch``,
    without that environment."""
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"data parallelism needs torchrun's environment "
                           f"(missing {', '.join(missing)}): launch with "
                           f"``{launch}``")
    rank_, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method="env://", world_size=world, rank=rank_,
            timeout=datetime.timedelta(seconds=timeout_s))
    return make_mesh(device=device, launch=launch)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_rows(n: int, rank_: Optional[int] = None,
               world: Optional[int] = None) -> slice:
    """Rank ``rank_``'s rows of a global batch of ``n`` (``batch_sharding``):
    the ``rank_``-th of ``world`` equal blocks, by default this process's
    in the initialised group."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{world} processes")
    m = n // world
    return slice(rank_ * m, (rank_ + 1) * m)


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (``replicate``)."""
    if world_size() > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)
    return module


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the incoming gradients over
    the group too (every rank's loss reads the sum), as
    ``torch.distributed.nn.functional.all_reduce`` does, which PyTorch
    deprecates."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the data group, with autograd (the gradient is
    summed back over the group); ``x`` itself on one process."""
    if world_size() == 1:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x)
    out = x.clone()
    dist.all_reduce(out)
    return out


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    return all_reduce_sum(x) / world_size()


@torch.no_grad()
def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace every ``.grad`` by its mean over the data group: one flat
    fp32 bucket, one ``all_reduce``. Runs whenever a process group is
    initialised, one process included."""
    if not dist.is_initialized():
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    i = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[i:i + n].view_as(g))
        i += n


@torch.no_grad()
def average_losses(metrics: Mapping[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """The entries whose key holds ``"loss"`` averaged over the data group
    (one ``all_reduce``); the others are global where they are made."""
    out = dict(metrics)
    if not dist.is_initialized():
        return out
    keys = [k for k in out if "loss" in k]
    if keys:
        flat = torch.stack([out[k].float() for k in keys])
        dist.all_reduce(flat)
        flat /= dist.get_world_size()
        for k, v in zip(keys, flat):
            out[k] = v
    return out
