"""ArUco marker dictionaries: bit patterns and the all-rotations table.

Counterpart of aruco_slam_tpu/ops/dictionary.py. The bit patterns are
the baked ``.npy`` tables of every cv2 predefined dictionary, shipped
with this package in ``ops/data/`` (byte-equal copies of the JAX
package's, held so by tests/test_torch_core.py). `load` expands each
code into its 4 rotations as ±1 rows, so decode matches every
candidate against every code and rotation with one matmul.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import NamedTuple

import numpy as np

DATA = Path(__file__).resolve().parent / "data"

DICT_5X5_50 = "dict_5x5_50"
DICT_4X4_50 = "dict_4x4_50"
DICT_6X6_50 = "dict_6x6_50"
DICT_7X7_50 = "dict_7x7_50"
DICT_ARUCO_ORIGINAL = "aruco_original"
DICT_APRILTAG_36H11 = "apriltag_36h11"


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


def marker_image(d: Dictionary, marker_id: int,
                 cell_px: int = 16) -> np.ndarray:
    """Rasterize marker `marker_id` with its 1-cell black border:
    ((n+2)·cell_px)² uint8 image, white=255 bits, black border."""
    n = d.marker_bits
    grid = np.zeros((n + 2, n + 2), np.uint8)
    grid[1:-1, 1:-1] = d.bits[marker_id]
    return np.kron(grid * 255, np.ones((cell_px, cell_px), np.uint8))
