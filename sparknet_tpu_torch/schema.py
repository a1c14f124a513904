"""Schema types: the interchange contract between data layer and nets.

The reference used Spark SQL `StructType` rows as the universal interchange
format (reference `libs/CaffeNet.scala:45-49` builds per-column converters
from the schema; `apps/CifarApp.scala:60-66` declares it). Here the
interchange is a batch dict {field: numpy array}, and `Schema` carries the
per-field dtype + element shape so preprocessors and nets can validate and
convert without inspecting data.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Field:
    name: str
    dtype: str  # numpy dtype string: "float32", "int32", "uint8", ...
    shape: Tuple[int, ...]  # per-example element shape, () for scalars


class Schema:
    def __init__(self, *fields: Field):
        self.fields: Tuple[Field, ...] = tuple(fields)
        self._by_name: Dict[str, Field] = {f.name: f for f in fields}

    def __getitem__(self, name: str) -> Field:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def names(self):
        return [f.name for f in self.fields]

    def validate_batch(self, batch: Dict[str, np.ndarray]) -> None:
        for f in self.fields:
            if f.name not in batch:
                raise ValueError(f"batch missing field {f.name!r}")
            arr = batch[f.name]
            if tuple(arr.shape[1:]) != f.shape:
                raise ValueError(
                    f"field {f.name!r}: element shape {tuple(arr.shape[1:])} "
                    f"!= schema {f.shape}")

    def __repr__(self):
        inner = ", ".join(f"{f.name}:{f.dtype}{list(f.shape)}"
                          for f in self.fields)
        return f"Schema({inner})"
