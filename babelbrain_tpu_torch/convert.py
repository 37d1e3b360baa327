"""Carry the JAX package's state objects over to the port.

The system has no learned weights: its "parameters" are the material
table, the expanded property volumes, the CPML profiles (all derived from a
``Domain`` and an ``FDTDGrid``) and the positioned transducer. These helpers
take the JAX package's objects (numpy fields only, so nothing here imports
JAX) and build the port's, so a test can feed the same Step-1 or Step-2
state to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from babelbrain_tpu.tx import Transducer

from .ops.fdtd import FDTDGrid
from .pipeline.domain import Domain


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
    """A copy of a (positioned) transducer; both packages share the JAX-free
    ``babelbrain_tpu.tx.Transducer`` class."""
    return Transducer(
        centers=np.array(tx.centers),
        areas=np.array(tx.areas),
        normals=np.array(tx.normals),
        elem_ids=np.array(tx.elem_ids),
        elem_centers=np.array(tx.elem_centers),
        meta=dict(tx.meta),
    )
