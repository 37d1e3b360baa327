"""Headless Step 1 -> Step 2 -> Step 3 pipeline (CT mode and label mode).

Submodules are imported explicitly, e.g.
``from babelbrain_tpu_torch.pipeline.runner import CaseConfig, run_case``.
"""
