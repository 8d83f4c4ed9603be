"""ArUco marker dictionaries: bit patterns and the all-rotations table.

The benchmark's frozen copy of the port's counterpart of
aruco_slam_tpu/ops/dictionary.py, with the one table the configurations
use, ``data/dict_5x5_50.npy`` (a byte-equal copy of the port's). `load`
expands each code into its 4 rotations as ±1 rows, so decode matches
every candidate against every code and rotation with one matmul.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

DICT_5X5_50 = "dict_5x5_50"


def names() -> list[str]:
    return sorted(p.stem for p in DATA.glob("*.npy"))


class Dictionary(NamedTuple):
    name: str
    bits: np.ndarray        # (N, n, n) uint8 payload bits
    table: np.ndarray       # (N*4, n*n) float32 in {-1, +1}
    table_ids: np.ndarray   # (N*4,) marker id per table row
    table_rot: np.ndarray   # (N*4,) rotation count per table row

    @property
    def num_markers(self) -> int:
        return self.bits.shape[0]

    @property
    def marker_bits(self) -> int:
        return self.bits.shape[1]


@functools.lru_cache(maxsize=8)
def load(name: str = DICT_5X5_50) -> Dictionary:
    path = DATA / f"{name}.npy"
    if not path.is_file():
        raise ValueError(f"unknown dictionary {name!r} (known: "
                         f"{', '.join(names())})")
    bits = np.load(path)
    n = bits.shape[0]
    rows, ids, rots = [], [], []
    for r in range(4):
        rows.append(np.rot90(bits, k=-r, axes=(1, 2)).reshape(n, -1))
        ids.append(np.arange(n))
        rots.append(np.full(n, r))
    table = np.concatenate(rows, 0).astype(np.float32) * 2.0 - 1.0
    return Dictionary(name=name, bits=bits, table=table,
                      table_ids=np.concatenate(ids).astype(np.int32),
                      table_rot=np.concatenate(rots).astype(np.int32))
