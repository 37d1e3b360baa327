"""Numerical operators: fluid and viscoelastic FDTD, Rayleigh integral, BHTE,
imaging.

Submodules are imported explicitly (``from babelbrain_tpu_torch.ops import
fdtd``); this package initializer imports nothing so that importing one
operator never builds or loads another's kernels.
"""
