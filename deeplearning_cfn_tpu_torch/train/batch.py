"""``Batch``, the input pair every stream yields, in a module of its own
that imports no ``torch``: the record converters (``train/datasets.py``,
``cli convert``) use it, and a converter's process need not load torch."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class Batch:
    x: Any  # numpy arrays on the host, tensors once placed; y may be a dict of them
    y: Any
