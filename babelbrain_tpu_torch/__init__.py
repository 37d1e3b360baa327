"""PyTorch + CUDA port of babelbrain_tpu for NVIDIA Hopper GPUs.

The JAX package ``babelbrain_tpu`` is the reference; this package keeps its
module layout and names so each counterpart is easy to find. It imports
``torch`` and nothing of ``jax`` or ``babelbrain_tpu``: the host-side modules
it needs (``materials``, ``tx``, the BLOSC codec in ``native``,
``utils.telemetry`` and the numpy parts of ``ops`` / ``pipeline``) are
copies kept here.

Covered today: ``pipeline.runner.run_case`` with a single-target plane
source in CT mode (fluid FDTD) and in label mode (no CT: viscoelastic FDTD
with shear in the skull), from Step 1 mask generation through forward
Rayleigh and the FDTD to the Pennes BHTE. The fluid and viscoelastic FDTD
steps and the BHTE step run as hand-written CUDA kernels (``csrc/``) on a
CUDA device; on CPU tensors they run their plain PyTorch versions.
"""
