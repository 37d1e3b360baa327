"""Structured stage timing (the reference's CTS:L<level>:S<step> spans).

Counterpart of ``babelbrain_tpu.utils.timing``: same label convention and
in-process registry. Where the JAX package annotates spans for
``jax.profiler``, this one opens an NVTX range of the same label while a
CUDA device is present, so ``torch.profiler`` / Nsight timelines carry the
stage vocabulary of the logs.
"""

from __future__ import annotations

import contextlib
import time

import torch

_SPANS: list[tuple[str, float]] = []


@contextlib.contextmanager
def stage_timer(label: str, level: int = 2, step: int | None = None, quiet=False):
    """Context manager emitting ``CTS:L<level>:S<step>: <label>`` timing.

    The span is wall-clock time on the host. Work queued on the GPU inside
    the span is counted only as far as the span's code waits for it (the
    pipeline stages read their results back to the host, which waits).
    """
    tag = f"CTS:L{level}" + (f":S{step}" if step is not None else "") + f": {label}"
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(tag)
    t0 = time.time()
    try:
        yield
    finally:
        dt = time.time() - t0
        if nvtx:
            torch.cuda.nvtx.range_pop()
        _SPANS.append((tag, dt))
        if not quiet:
            print(f"{tag} took {dt:.3f} s")
        try:
            from .telemetry import get_telemetry

            get_telemetry().event(tag, duration_s=dt)
        except Exception:
            pass  # telemetry must never break the pipeline


def recorded_spans():
    return list(_SPANS)


def clear_spans():
    _SPANS.clear()
