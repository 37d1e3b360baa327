"""Device meshes and the x decomposition of the FDTD grid (``halo``)."""
