"""Process-wide logging setup.

Role-equivalent of the reference's spdlog-backed RAY_LOG (reference
``src/ray/util/logging.h``): every component logs through one configured
logger with a component tag; per-process log files land under the session
directory so the log monitor can tail them back to the driver.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s.%(msecs)03d %(levelname)s %(name)s :: %(message)s"
_DATEFMT = "%H:%M:%S"


def get_logger(component: str) -> logging.Logger:
    return logging.getLogger(f"ray_tpu_torch.{component}")


def setup_process_logging(
    component: str,
    log_dir: str | None = None,
    level: int = logging.INFO,
    to_stderr: bool = True,
) -> logging.Logger:
    """Configure the root ray_tpu_torch logger for this process.

    If ``log_dir`` is given, a per-process file
    ``<log_dir>/<component>-<pid>.log`` is created (tailed by the log
    monitor, see _private/log_monitor.py).
    """
    root = logging.getLogger("ray_tpu_torch")
    root.setLevel(level)
    # Re-configure idempotently (workers may call this after fork/exec).
    for h in list(root.handlers):
        root.removeHandler(h)
    fmt = logging.Formatter(_FORMAT, datefmt=_DATEFMT)
    if to_stderr:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        root.addHandler(h)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{component}-{os.getpid()}.log")
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    root.propagate = False
    return get_logger(component)
