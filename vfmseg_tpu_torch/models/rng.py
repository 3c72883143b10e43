"""Named random streams for the training forward, flax's ``make_rng``.

The JAX package's training forward draws from three named streams: ``crop``
(the HR crop box), ``mask`` (the decoder's mask tokens) and ``dropout``. Here
the train step installs one ``torch.Generator`` per name with :func:`streams`
for the length of the forward, and the modules draw through the functions
below, so no draw touches PyTorch's global generator and a step's draws
depend only on its seed (see ``train/step.py``).

The bits differ from JAX's from the same seed; the tests feed both sides the
same numbers by patching :func:`uniform` and :func:`randint` here and their
``jax.random`` counterparts there.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Mapping, Sequence

import torch

_local = threading.local()


@contextlib.contextmanager
def streams(generators: Mapping[str, torch.Generator]) -> Iterator[None]:
    """Install ``generators`` (name -> Generator) for the enclosed calls."""
    prev = getattr(_local, "generators", None)
    _local.generators = dict(generators)
    try:
        yield
    finally:
        _local.generators = prev


def _generator(name: str) -> torch.Generator:
    gens = getattr(_local, "generators", None)
    if not gens or name not in gens:
        raise RuntimeError(f"no {name!r} random stream: run the training "
                           f"forward inside rng.streams(...)")
    return gens[name]


def uniform(name: str, shape: Sequence[int],
            device: torch.device) -> torch.Tensor:
    """U[0, 1) fp32 of ``shape`` from stream ``name``, on ``device``."""
    g = _generator(name)
    return torch.rand(tuple(shape), generator=g, device=g.device).to(device)


def randint(name: str, high: int) -> int:
    """One integer in [0, high) from stream ``name``, as a host int."""
    g = _generator(name)
    return int(torch.randint(0, high, (1,), generator=g, device=g.device))


def dropout(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale kept
    values by 1 / (1 - rate); the identity outside training."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = uniform("dropout", x.shape, x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))
