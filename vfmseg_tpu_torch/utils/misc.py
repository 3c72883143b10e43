"""Small helpers shared across the port.

Port of vfmseg_tpu/utils/misc.py:10-12. The other helpers of that file walk
JAX trees; the port names its parameters through ``named_parameters``
instead (``train/optim.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping


def add_prefix(inputs: Mapping[str, Any], prefix: str) -> Dict[str, Any]:
    """Prefix every key of a loss or metric dict with ``prefix.``
    (reference rein/utils/misc.py:4-20)."""
    return {f"{prefix}.{k}": v for k, v in inputs.items()}
