"""Named random streams for the training forward, flax's ``make_rng``.

The JAX package's training forward draws from four named streams: ``crop``
(the HR crop box), ``mask`` (the decoder's mask tokens), ``dropout`` and
``augment`` (the strong augmentations of DomainGeneral and DACS: jitter
factors, coins, blur sigma, ClassMix scores, the block-mask grid). Here
the train step installs one ``torch.Generator`` per name with :func:`streams`
for the length of the forward, and the modules draw through the functions
below, so no draw touches PyTorch's global generator and a step's draws
depend only on its seed (see ``train/step.py``).

The bits differ from JAX's from the same seed; the tests feed both sides the
same numbers by patching :func:`uniform` and :func:`randint` here and their
``jax.random`` counterparts there.

Data parallelism. The JAX step draws batch-shaped numbers (dropout and
drop-path masks, the decoder's mask tokens, ClassMix scores, the block-mask
grid, the set loss's point pools) for the global batch, whichever device
holds a row. Here every rank seeds its streams as a single process does
(``streams(..., rank=, world=)``) and a per-sample draw (a
:class:`PerSample` shape, and every :func:`dropout`) takes the
global shape, ``world`` times the local leading dim, and keeps this rank's
rows. The leading dim may concatenate ``k`` batches (MsVFM's one ViT call
over the LR views and the HR crops, DACS's source and mixed images in one
pass): the caller says so with :func:`batch_blocks`, and the rank's rows are
then its slice of each of the ``k`` global blocks, as JAX's concatenation of
two global arrays orders them. Scalar and other shared draws (crop boxes,
jitter coins, the matching points) are the same on every rank. So a world-N
step draws what the world-1 step draws on the same global batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (
    ContextManager,
    Dict,
    Iterator,
    Mapping,
    Optional,
    Sequence,
    Tuple,
)

import torch

_local = threading.local()


@dataclasses.dataclass(frozen=True)
class _Context:
    generators: Dict[str, torch.Generator]
    rank: int = 0
    world: int = 1
    blocks: int = 1


def _context() -> Optional[_Context]:
    return getattr(_local, "context", None)


@contextlib.contextmanager
def _installed(ctx: Optional[_Context]) -> Iterator[None]:
    prev = _context()
    _local.context = ctx
    try:
        yield
    finally:
        _local.context = prev


def streams(generators: Mapping[str, torch.Generator], rank: int = 0,
            world: int = 1) -> ContextManager[None]:
    """Install ``generators`` (name -> Generator) for the enclosed calls,
    for rank ``rank`` of a data-parallel group of ``world`` processes."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return _installed(_Context(dict(generators), rank, world))


@contextlib.contextmanager
def batch_blocks(k: int) -> Iterator[None]:
    """Inside, the leading dim of per-sample draws concatenates ``k`` local
    batches of one size (see the module docstring)."""
    ctx = _context()
    if ctx is None:
        yield
        return
    with _installed(dataclasses.replace(ctx, blocks=k)):
        yield


def snapshot() -> Optional[Tuple[_Context, Dict[str, torch.Tensor]]]:
    """The installed context and each stream's generator state, for
    :func:`replay`; None outside :func:`streams`."""
    ctx = _context()
    if ctx is None:
        return None
    return ctx, {n: g.get_state() for n, g in ctx.generators.items()}


def replay(saved) -> ContextManager[None]:
    """Install fresh generators at the states :func:`snapshot` saved, with
    its rank, world and blocks, so the enclosed calls draw again what the
    calls after the snapshot drew (a recomputation under activation
    checkpointing)."""
    if saved is None:
        return contextlib.nullcontext()
    ctx, states = saved
    gens = {}
    for name, g in ctx.generators.items():
        gens[name] = torch.Generator(device=g.device)
        gens[name].set_state(states[name])
    return _installed(dataclasses.replace(ctx, generators=gens))


def _generator(name: str) -> Tuple[torch.Generator, _Context]:
    ctx = _context()
    if ctx is None or name not in ctx.generators:
        raise RuntimeError(f"no {name!r} random stream: run the training "
                           f"forward inside rng.streams(...)")
    return ctx.generators[name], ctx


class PerSample(tuple):
    """A draw's shape whose leading dim is this rank's rows of the batch (of
    ``batch_blocks`` batches); a plain tuple to everything else."""


def uniform(name: str, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` from stream ``name``, on ``device``. A
    :class:`PerSample` shape on a rank of several takes the global shape's
    draw and keeps this rank's rows."""
    g, ctx = _generator(name)
    per_rank = isinstance(shape, PerSample)
    shape = tuple(shape)
    if not per_rank or ctx.world == 1:
        return torch.rand(shape, generator=g, device=g.device).to(device)
    k = ctx.blocks
    if shape[0] % k:
        raise ValueError(f"a leading dim of {shape[0]} does not split into "
                         f"{k} batches")
    m = shape[0] // k
    full = torch.rand((shape[0] * ctx.world,) + shape[1:], generator=g,
                      device=g.device)
    rows = (torch.arange(k)[:, None] * (m * ctx.world) + ctx.rank * m
            + torch.arange(m)[None]).reshape(-1)
    return full[rows.to(full.device)].to(device)


def randint(name: str, high: int) -> int:
    """One integer in [0, high) from stream ``name``, as a host int, the
    same on every rank."""
    g, _ = _generator(name)
    return int(torch.randint(0, high, (1,), generator=g, device=g.device))


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale kept
    values by 1 / (1 - rate); the identity outside training. ``x``'s
    leading dim is the batch (a per-sample draw)."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = uniform("dropout", PerSample(x.shape), x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
