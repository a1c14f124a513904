"""UCI Adult/Census CSV loader (tabular).

Parity with the reference's adult path (`src/test/scala/apps/LoadAdultDataSpec.scala`
+ `models/adult/adult.prototxt`): CSV rows -> numeric feature columns C0..Cn
plus a binary label from the income field. Categorical columns are
dictionary-encoded to float indices (the reference fed spark-csv columns
straight to the net; numeric semantics preserved here).

A copy of `sparknet_tpu/data/adult.py` (pure Python): the port imports
nothing of the JAX package.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Standard UCI adult.data column order.
COLUMNS = ["age", "workclass", "fnlwgt", "education", "education_num",
           "marital_status", "occupation", "relationship", "race", "sex",
           "capital_gain", "capital_loss", "hours_per_week", "native_country",
           "income"]
NUMERIC = {"age", "fnlwgt", "education_num", "capital_gain", "capital_loss",
           "hours_per_week"}


class AdultLoader:
    def __init__(self, path: str, feature_columns: Optional[Sequence[str]] = None,
                 normalize: bool = True):
        if not os.path.exists(path):
            raise FileNotFoundError(f"adult CSV missing: {path}")
        self.feature_columns = list(feature_columns or
                                    [c for c in COLUMNS if c != "income"])
        rows: List[List[str]] = []
        with open(path, newline="") as f:
            for row in csv.reader(f):
                if len(row) != len(COLUMNS):
                    continue  # blank/short lines in the raw UCI file
                rows.append([c.strip() for c in row])
        if not rows:
            raise ValueError(f"{path}: no parseable rows")
        self.vocab: Dict[str, Dict[str, int]] = {}
        feats = np.zeros((len(rows), len(self.feature_columns)), np.float32)
        labels = np.zeros((len(rows),), np.int32)
        for j, col in enumerate(self.feature_columns):
            ci = COLUMNS.index(col)
            if col in NUMERIC:
                feats[:, j] = [float(r[ci]) for r in rows]
            else:
                vocab = self.vocab.setdefault(col, {})
                for i, r in enumerate(rows):
                    feats[i, j] = vocab.setdefault(r[ci], len(vocab))
        for i, r in enumerate(rows):
            labels[i] = 1 if r[-1].startswith(">50K") else 0
        if normalize:
            mu, sd = feats.mean(0), feats.std(0)
            sd[sd == 0] = 1.0
            feats = (feats - mu) / sd
        self.features = feats
        self.labels = labels

    def batch_dict(self) -> Dict[str, np.ndarray]:
        """Net inputs: 'C0' = feature matrix (N, n_features), 'label'."""
        return {"C0": self.features, "label": self.labels[:, None]}


def write_synthetic(path: str, n: int = 200, seed: int = 0) -> None:
    """Tiny synthetic adult.data in the exact CSV shape (for tests)."""
    r = np.random.default_rng(seed)
    workclasses = ["Private", "Self-emp", "Federal-gov"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        for _ in range(n):
            age = int(r.integers(17, 90))
            row = [str(age), workclasses[int(r.integers(0, 3))], "77516",
                   "Bachelors", "13", "Never-married", "Adm-clerical",
                   "Not-in-family", "White", "Male",
                   str(int(r.integers(0, 5000))), "0",
                   str(int(r.integers(1, 99))), "United-States",
                   ">50K" if r.random() < 0.25 else "<=50K"]
            w.writerow(row)
