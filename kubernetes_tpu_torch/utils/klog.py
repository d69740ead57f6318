"""Leveled logging: the klog analog.

Reference: vendor/k8s.io/klog — components log through a process-wide
leveled logger; `klog.V(n).Infof(...)` emits only when --v >= n.  Same
shape here on top of the stdlib logging module so host tooling
(pytest -s, journald) interoperates:

    from kubernetes_tpu_torch.utils import klog
    klog.set_verbosity(2)           # the -v/--verbosity flag
    klog.V(2).infof("snapshot generation %d", gen)
    klog.infof("scheduled %s to %s", pod, node)     # V(0): always
    klog.errorf("bind failed: %s", err)
"""

from __future__ import annotations

import logging
import sys
import threading

_logger = logging.getLogger("kubernetes_tpu")
_verbosity = 0
_lock = threading.RLock()  # set_verbosity calls _ensure_handler under it


def _ensure_handler() -> None:
    with _lock:
        if not _logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(
                logging.Formatter("%(levelname).1s%(asctime)s %(message)s",
                                  datefmt="%m%d %H:%M:%S")
            )
            _logger.addHandler(h)
            _logger.setLevel(logging.INFO)
            _logger.propagate = False


def set_verbosity(v: int) -> None:
    """The --v flag (component-base logs.go)."""
    global _verbosity
    with _lock:
        _verbosity = int(v)
        _ensure_handler()


def verbosity() -> int:
    return _verbosity


class _Verbose:
    """klog.V(n): a guarded logger — calls are no-ops below the level."""

    __slots__ = ("enabled",)

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def infof(self, fmt: str, *args) -> None:
        if self.enabled:
            _ensure_handler()
            _logger.info(fmt, *args)


def V(level: int) -> _Verbose:
    return _Verbose(_verbosity >= level)


def infof(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.info(fmt, *args)


def warningf(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.warning(fmt, *args)


def errorf(fmt: str, *args) -> None:
    _ensure_handler()
    _logger.error(fmt, *args)
