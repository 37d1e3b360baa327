"""Structured stage timing (the reference's CTS:L<level>:S<step> spans).

Counterpart of ``babelbrain_tpu.utils.timing``: same label convention and
in-process registry. Each span opens an NVTX range of its label while a
CUDA device is present, so Nsight-style timelines carry the stage
vocabulary of the logs. With ``BBT_PROFILE_DIR=<dir>`` set (the JAX
package's ``jax.profiler`` hook), the outermost span runs a
``torch.profiler`` trace of the host and, with a card, the device, and
writes it into that directory as a Chrome trace when it ends; every span
inside it is a ``record_function`` range of its label there, beside the
per-shard NVTX ranges of a decomposed FDTD loop. Profiling never breaks the
pipeline: a failure to start or write the trace is ignored.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_SPANS: list[tuple[str, float]] = []
_DEPTH = [0]  # spans open now (the outermost one owns the trace)


def _profile(prof_dir: str, tag: str, outermost: bool):
    """The ``BBT_PROFILE_DIR`` context of a span: a ``torch.profiler``
    trace written into ``prof_dir`` (outermost span) and the span's
    ``record_function`` range."""
    ctx = contextlib.ExitStack()
    try:
        from torch.profiler import ProfilerActivity, profile, record_function

        if outermost:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            os.makedirs(prof_dir, exist_ok=True)
            name = f"bbt_trace_{os.getpid()}_{time.time_ns()}.json"

            def export(prof):
                try:
                    prof.export_chrome_trace(os.path.join(prof_dir, name))
                except Exception:
                    pass  # profiling must never break the pipeline

            ctx.enter_context(profile(activities=acts,
                                      on_trace_ready=export))
        ctx.enter_context(record_function(tag))
    except Exception:
        pass  # profiling must never break the pipeline
    return ctx


@contextlib.contextmanager
def stage_timer(label: str, level: int = 2, step: int | None = None, quiet=False):
    """Context manager emitting ``CTS:L<level>:S<step>: <label>`` timing.

    The span is wall-clock time on the host. Work queued on the GPU inside
    the span is counted only as far as the span's code waits for it (the
    pipeline stages read their results back to the host, which waits).
    """
    tag = f"CTS:L{level}" + (f":S{step}" if step is not None else "") + f": {label}"
    prof_dir = os.environ.get("BBT_PROFILE_DIR")
    ctx = (_profile(prof_dir, tag, _DEPTH[0] == 0) if prof_dir
           else contextlib.nullcontext())
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(tag)
    _DEPTH[0] += 1
    t0 = time.time()
    try:
        with ctx:
            yield
    finally:
        dt = time.time() - t0
        _DEPTH[0] -= 1
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
