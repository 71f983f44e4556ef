"""Process-wide logging for ray_tpu_torch.

Copy of ray_tpu/utils/logging.py: one stdlib logging tree rooted at
"ray_tpu_torch", per-process log files, env-tunable level.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s\t%(levelname)s %(name)s:%(lineno)d -- %(message)s"
_configured = False


def get_logger(name: str) -> logging.Logger:
    _ensure_configured()
    return logging.getLogger(name)


def _ensure_configured() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    root = logging.getLogger("ray_tpu_torch")
    level = os.environ.get("RAY_TPU_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root.addHandler(handler)
    root.propagate = False


def add_file_handler(path: str) -> None:
    """Attach a per-process log file (e.g. <session_dir>/logs/worker-<pid>.log)."""
    _ensure_configured()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    handler = logging.FileHandler(path)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logging.getLogger("ray_tpu_torch").addHandler(handler)
