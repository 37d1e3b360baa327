"""Worker-process orchestration: isolated pipeline steps + queue log streaming.

Counterpart of ``babelbrain_tpu/pipeline/workers.py``. The reference runs
every pipeline step in a forked ``multiprocessing.Process`` with stdout
redirected into a ``Queue`` that the GUI drains, and signals failures with
a stdout sentinel (SURVEY.md sections 2.1/5):

* `CalculateMaskProcess(queue, ...)`   — `BabelBrain/CalculateMaskProcess.py:4-86`
* `CalculateFieldProcess(queue, ...)`  — `BabelBrain/CalculateFieldProcess.py:125-128`
* `CalculateThermalProcess(queue, ...)`— `Babel_Thermal/CalculateThermalProcess.py:54-123`
* error sentinel ``--Babel-Brain-Low-Error`` + traceback, scanned by the
  parent (`BabelBrain.py:1605-1641`)
* stdout-as-log via an ``InOutputWrapper`` (`CalculateFieldProcess.py:10-35`)

The *contract* matters for external driving systems
(`InformationForDrivingSystems.md`): a supervisor must be able to run a step
out-of-process, stream its structured `CTS:` logs live, and detect failure
from the stream. This module keeps that contract with a generic
``run_step_in_process`` plus thin step wrappers over the port's ``step1``
and ``runner``. Children start with ``spawn``: a forked child cannot use
CUDA once the parent has, and a spawned one opens its own CUDA context
beside the parent's (a step's ``device`` argument selects it as in the
parent). Results travel back pickled, so a step returns host (numpy)
data, as ``generate_mask`` and ``run_case``'s file map do.
"""

from __future__ import annotations

import io
import multiprocessing as mp
import sys
import traceback

ERROR_SENTINEL = "--Babel-Brain-Low-Error"
_DONE = "--Babel-Brain-Step-Done"


class QueueWriter(io.TextIOBase):
    """stdout replacement that forwards complete lines into a Queue
    (the reference's InOutputWrapper, `CalculateFieldProcess.py:10-35`)."""

    def __init__(self, queue):
        self._q = queue
        self._buf = ""

    def write(self, s):
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self._q.put(line)
        return len(s)

    def flush(self):
        if self._buf:
            self._q.put(self._buf)
            self._buf = ""


def _child(queue, result_queue, fn, args, kwargs):
    sys.stdout = sys.stderr = QueueWriter(queue)
    try:
        out = fn(*args, **kwargs)
        try:
            result_queue.put(("ok", out))
        except Exception:
            # result not picklable: still report success
            result_queue.put(("ok", None))
        print(_DONE)
    except BaseException:
        print(ERROR_SENTINEL)
        print(traceback.format_exc())
        result_queue.put(("error", traceback.format_exc()))
        try:
            from ..utils.telemetry import get_telemetry

            tel = get_telemetry()
            tel.event("CTS:L0: step error")
            tel.flush()
        except Exception:
            pass
    finally:
        sys.stdout.flush()


def run_step_in_process(fn, *args, on_log=None, timeout=None, **kwargs):
    """Run ``fn(*args, **kwargs)`` in a fresh process, streaming its stdout.

    Returns the function result. Raises ``RuntimeError`` carrying the child
    traceback when the child printed the error sentinel — the parent-side
    scan of `BabelBrain.py:1605-1641`. ``on_log`` receives each log line as
    it is produced (live, not post-hoc).
    """
    ctx = mp.get_context("spawn")
    queue: mp.Queue = ctx.Queue()
    result_queue: mp.Queue = ctx.Queue()
    proc = ctx.Process(
        target=_child, args=(queue, result_queue, fn, args, kwargs)
    )
    proc.start()
    lines = []
    failed = False
    while True:
        try:
            line = queue.get(timeout=0.2)
        except Exception:
            if not proc.is_alive() and queue.empty():
                break
            continue
        if line == _DONE:
            break
        lines.append(line)
        if line.strip() == ERROR_SENTINEL:
            failed = True
        if on_log is not None:
            on_log(line)
    # drain the result BEFORE join: a large payload keeps the child's queue
    # feeder thread (and thus the process) alive until the parent reads it
    status, payload = "error", None
    try:
        status, payload = result_queue.get(timeout=timeout or 60)
    except Exception:
        pass
    proc.join(timeout or 60)
    if proc.is_alive():
        proc.terminate()
        proc.join()
        raise RuntimeError("worker step timed out")
    if failed or status == "error":
        tb = payload if status == "error" else "\n".join(lines)
        raise RuntimeError(f"worker step failed:\n{tb}")
    return payload


# ---------------------------------------------------------------------------
# Step wrappers mirroring the reference worker functions
# ---------------------------------------------------------------------------

def _mask_step(kwargs):
    from .step1 import generate_mask

    return generate_mask(**kwargs)


def calculate_mask_process(on_log=None, **kwargs):
    """Step-1 out-of-process (`CalculateMaskProcess.py:4-86` contract);
    ``kwargs`` are ``generate_mask``'s, ``device`` included."""
    return run_step_in_process(_mask_step, kwargs, on_log=on_log)


def _case_step(cfg_kwargs, case_args):
    from .runner import CaseConfig, run_case

    cfg = CaseConfig(**cfg_kwargs)
    out = run_case(cfg, **case_args)
    return out["files"]


def calculate_field_process(cfg_kwargs: dict, case_args: dict, on_log=None):
    """Steps 1+2(+3) out-of-process, returning the output file map
    (`CalculateFieldProcess.py` contract — results travel through files)."""
    return run_step_in_process(_case_step, cfg_kwargs, case_args,
                               on_log=on_log)
