"""Opt-in usage telemetry, written locally as JSONL.

The reference POSTs anonymous ``CTS:`` stage events to a Google Form with an
install UUID, 15-message batching, consent levels, and an opt-out env var
(`BabelBrain/Telemetry/Telemetry.py:10-109`, consent persistence
`BabelBrain.py:194`). This build keeps the same event vocabulary and
batching semantics but writes to a local JSONL file instead of the network
(zero-egress environments; a deployment can ship the files however it
likes).

Controls:
* env ``BBT_TELEMETRY=0``  — disable entirely (the reference's opt-out).
* env ``BBT_TELEMETRY_DIR`` — where events land (default ``~/.babelbrain_tpu``).
* ``set_level('off'|'minimal'|'full')`` — consent level, persisted.
"""

from __future__ import annotations

import json
import os
import time
import uuid

_BATCH = 15  # the reference batches 15 messages per POST

_LEVELS = ("off", "minimal", "full")


def _base_dir() -> str:
    return os.environ.get(
        "BBT_TELEMETRY_DIR",
        os.path.join(os.path.expanduser("~"), ".babelbrain_tpu"),
    )


class Telemetry:
    """Batched local event recorder with a persistent install UUID."""

    def __init__(self, base_dir: str | None = None):
        self.base_dir = base_dir or _base_dir()
        self._pending: list[dict] = []
        self._id = None
        self._level = None

    @property
    def enabled(self) -> bool:
        if os.environ.get("BBT_TELEMETRY", "1") == "0":
            return False
        return self.level != "off"

    @property
    def install_id(self) -> str:
        """Anonymous install UUID, persisted across sessions
        (`Telemetry.py` UniqueID behavior)."""
        if self._id is None:
            path = os.path.join(self.base_dir, "telemetry_id")
            try:
                with open(path) as f:
                    self._id = f.read().strip()
            except OSError:
                self._id = str(uuid.uuid4())
                os.makedirs(self.base_dir, exist_ok=True)
                with open(path, "w") as f:
                    f.write(self._id)
        return self._id

    @property
    def level(self) -> str:
        if self._level is None:
            path = os.path.join(self.base_dir, "telemetry_level")
            try:
                with open(path) as f:
                    lv = f.read().strip()
                self._level = lv if lv in _LEVELS else "minimal"
            except OSError:
                self._level = "minimal"
        return self._level

    def set_level(self, level: str):
        if level not in _LEVELS:
            raise ValueError(f"level must be one of {_LEVELS}")
        self._level = level
        os.makedirs(self.base_dir, exist_ok=True)
        with open(os.path.join(self.base_dir, "telemetry_level"), "w") as f:
            f.write(level)

    def event(self, label: str, duration_s: float | None = None, **fields):
        """Record one event (the reference's CTS: vocabulary)."""
        if not self.enabled:
            return
        ev = {"ts": time.time(), "id": self.install_id, "label": label}
        if duration_s is not None:
            ev["duration_s"] = round(duration_s, 4)
        if self.level == "full":
            ev.update(fields)
        self._pending.append(ev)
        if len(self._pending) >= _BATCH:
            self.flush()

    def flush(self):
        if not self._pending:
            return
        os.makedirs(self.base_dir, exist_ok=True)
        path = os.path.join(self.base_dir, "events.jsonl")
        with open(path, "a") as f:
            for ev in self._pending:
                f.write(json.dumps(ev) + "\n")
        self._pending.clear()


_GLOBAL: Telemetry | None = None


def get_telemetry() -> Telemetry:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = Telemetry()
    return _GLOBAL
