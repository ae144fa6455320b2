"""Logging facade: counterpart of ``gslam_tpu/utils/logging.py``.

Python's stdlib logging under the root logger ``gslam_tpu_torch``, its
level from ``GSLAM_LOGLEVEL`` (default INFO), and ``check``,
``check_eq`` and ``check_near``, which raise where a glog ``CHECK``
would abort.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(levelname).1s%(asctime)s %(name)s] %(message)s"
_configured = False


def get_logger(name: str = "gslam_tpu_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT,
                                               datefmt="%m%d %H:%M:%S"))
        root = logging.getLogger("gslam_tpu_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get("GSLAM_LOGLEVEL", "INFO"))
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


def check(cond: bool, msg: str = "") -> None:
    """``CHECK()`` analog: raise on failure instead of aborting."""
    if not cond:
        raise AssertionError(f"CHECK failed: {msg}")


def check_eq(a, b, msg: str = "") -> None:
    if a != b:
        raise AssertionError(f"CHECK_EQ failed: {a!r} != {b!r} {msg}")


def check_near(a, b, tol: float = 1e-6, msg: str = "") -> None:
    if abs(a - b) > tol:
        raise AssertionError(
            f"CHECK_NEAR failed: |{a!r} - {b!r}| > {tol} {msg}")
