"""Carry the JAX package's state objects over to the port.

The system has no learned weights: its "parameters" are the material
table, the expanded property volumes, the CPML profiles (all derived from a
``Domain`` and an ``FDTDGrid``) and the positioned transducer. These helpers
read the JAX package's objects by their fields (numpy arrays and plain
values, so nothing here imports either JAX or the JAX package) and build the
port's, so a test can feed the same Step-1 or Step-2 state to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ops.fdtd import FDTDGrid
from .pipeline.domain import Domain
from .tx import Transducer


def grid_from_reference(grid) -> FDTDGrid:
    """The port's ``FDTDGrid`` with the fields of a JAX ``FDTDGrid``."""
    return FDTDGrid(**{f.name: getattr(grid, f.name)
                       for f in dataclasses.fields(FDTDGrid)})


def domain_from_reference(dom) -> Domain:
    """The port's ``Domain`` with copies of a JAX ``Domain``'s arrays."""
    kw = {}
    for f in dataclasses.fields(Domain):
        v = getattr(dom, f.name)
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, dict):
            v = {k: (x.copy() if isinstance(x, np.ndarray) else x)
                 for k, x in v.items()}
        kw[f.name] = v
    return Domain(**kw)


def transducer_from_reference(tx) -> Transducer:
    """The port's ``Transducer`` with copies of a (positioned) JAX
    transducer's arrays."""
    return Transducer(**{
        f.name: (dict(v) if isinstance(v, dict) else np.array(v))
        for f in dataclasses.fields(Transducer)
        for v in (getattr(tx, f.name),)
    })


def indexed_materials_from_reference(mat_idx, mat_table):
    """The port's indexed materials from the JAX ``_build_indexed_materials``.

    The JAX kernels take an int32 index and an (8, 128) table whose first six
    rows are [rho_inv, pi_u, mu_u, c_rp, c_rs, b_r] over the first M lanes
    (materials, then their reflector twins); the lanes past M are padding.
    Every real material has rho_inv > 0, so M is one past the last lane with
    a nonzero rho_inv. Returns ``(idx int32 (N1,N2,N3), table (6, M) f32)``.
    """
    tab = np.asarray(mat_table, np.float32)
    m = int(np.nonzero(tab[0])[0].max()) + 1
    idx = np.ascontiguousarray(np.asarray(mat_idx), np.int32)
    if idx.max() >= m:
        raise ValueError(f"material index {idx.max()} beyond the {m} materials")
    return idx, np.ascontiguousarray(tab[:6, :m])
