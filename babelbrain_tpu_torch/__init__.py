"""PyTorch + CUDA port of babelbrain_tpu for NVIDIA Hopper GPUs.

The JAX package ``babelbrain_tpu`` is the reference; this package keeps its
module layout and names so each counterpart is easy to find. It imports
``torch`` and never ``jax``: the JAX-free subpackages
``babelbrain_tpu.materials``, ``.tx``, ``.native`` and
``babelbrain_tpu.utils.telemetry`` are used directly, and the host-side
numpy modules of ``babelbrain_tpu.ops`` / ``babelbrain_tpu.pipeline`` are
copied here (importing those packages would import JAX).

Covered today: the CT-mode main path of ``pipeline.runner.run_case``
(Step 1 mask generation, forward Rayleigh + fluid FDTD, Pennes BHTE). The
fluid FDTD step and the BHTE step run as hand-written CUDA kernels
(``csrc/``) on a CUDA device; on CPU tensors they run their plain PyTorch
versions.
"""
