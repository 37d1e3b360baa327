"""Bundled element-coordinate tables for the multi-element transducers.

The reference ships each phased array's element coordinates as a
manufacturer data file (CSV/.mat) next to its geometry module
(`TranscranialModeling/H317.py:15-52`, `I12378.py:19-53`, `ATAC.py:19-52`,
`H301.py:19-36`, `IGT64_500.py:19-31`, `R15646.py:19-30`, `R15148.py:19-28`,
`BabelIntegrationDomeTx.py:16-22`, `BabelIntegrationREMOPD.py:28-39`).
We bundle the same physical-device measurements as a single .npz (see
``tools/extract_reference_data.py`` for provenance and the per-device frame
transforms), already converted to this package's convention: meters,
geometric focus at the origin, bowl at negative z.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

#: devices with a bundled element-center table (E, 3)
TABLE_DEVICES = (
    "H317", "I12378", "ATAC", "H301", "IGT64_500", "R15646", "R15148",
    "DomeTx",
)


@functools.lru_cache(maxsize=1)
def _tables():
    return dict(np.load(os.path.join(_DATA, "element_tables.npz")))


def element_table(name: str) -> np.ndarray:
    """Element centers (E, 3) in meters, focus-at-origin frame."""
    t = _tables()
    if name not in t:
        raise KeyError(
            f"no bundled element table for {name!r}; available: {sorted(t)}"
        )
    return np.array(t[name], np.float64)


def dome_element_areas_mm2() -> np.ndarray:
    """Per-element areas (mm^2) of the 1024-element dome array."""
    return np.array(_tables()["DomeTx_area_mm2"], np.float64)


def remopd_positions() -> np.ndarray:
    """REMOPD 256-element measured positions (m) on the z=0 plane
    (`BabelIntegrationREMOPD.py:36-39`; elements sit at z=-1.2 mm)."""
    return np.array(_tables()["REMOPD"], np.float64)
