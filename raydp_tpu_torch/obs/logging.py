"""Structured logging: the port's copy of ``raydp_tpu/obs/logging.py``.

Every line carries a wall timestamp, the process role and the actor id
(``RAYDP_TPU_ACTOR_ID``, when a runtime sets it), so output interleaved
from several processes is attributable. Each line is also noted in the
process's flight-recorder ring (``obs.recorder.note_log``), so a crash
dossier carries the last log lines.

Usage::

    from raydp_tpu_torch import obs
    obs.log.warning("retrying the fit", attempt=1)
"""

from __future__ import annotations

import os
import sys
import time
import traceback

from raydp_tpu_torch.obs.recorder import note_log


class StructuredLogger:
    """Writes ``ts level [role actor] message key=value...`` lines to
    stderr."""

    def __init__(self, role: str = ""):
        self._role = role

    def _emit(self, level: str, message: str, exc_info: bool, fields: dict) -> None:
        from raydp_tpu_torch.obs.tracing import process_role

        role = self._role or process_role()
        actor = os.environ.get("RAYDP_TPU_ACTOR_ID", "")
        note_log(level, role, message, fields)
        ts = time.strftime("%Y-%m-%d %H:%M:%S", time.gmtime())
        parts = [ts, level, f"[{role}" + (f" {actor}" if actor else "") + "]", message]
        if fields:
            parts.append(" ".join(f"{k}={v!r}" for k, v in fields.items()))
        line = " ".join(parts)
        if exc_info:
            line += "\n" + traceback.format_exc().rstrip()
        try:
            sys.stderr.write(line + "\n")
            sys.stderr.flush()
        except (OSError, ValueError):
            pass  # a closed stderr at teardown must never raise

    def info(self, message: str, exc_info: bool = False, **fields) -> None:
        self._emit("INFO", message, exc_info, fields)

    def warning(self, message: str, exc_info: bool = False, **fields) -> None:
        self._emit("WARN", message, exc_info, fields)

    def error(self, message: str, exc_info: bool = False, **fields) -> None:
        self._emit("ERROR", message, exc_info, fields)

    def exception(self, message: str, **fields) -> None:
        self._emit("ERROR", message, True, fields)


log = StructuredLogger()


def get_logger(role: str) -> StructuredLogger:
    return StructuredLogger(role)
