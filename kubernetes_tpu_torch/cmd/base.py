"""Shared CLI plumbing for the port's component binaries (component-base
analog: staging/src/k8s.io/component-base cli flags/logs; option pattern of
cmd/kube-scheduler/app/options)."""

from __future__ import annotations

import argparse
import signal
import threading
from typing import Optional


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--config", metavar="FILE",
        help="component configuration file (KubeSchedulerConfiguration JSON)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device the pipeline runs on (default cuda; cpu runs "
        "the kernels' plain versions on the host)",
    )
    p.add_argument("-v", "--verbosity", type=int, default=0,
                   help="log level (klog.V analog)")


def load_component_config(path: Optional[str]):
    from kubernetes_tpu_torch.config.types import KubeSchedulerConfiguration

    if path:
        return KubeSchedulerConfiguration.from_file(path)
    return KubeSchedulerConfiguration()


def wait_for_term(stop_event: Optional[threading.Event] = None) -> None:
    """Block until SIGINT/SIGTERM (the stopCh pattern)."""
    ev = stop_event or threading.Event()

    def handler(signum, frame):
        ev.set()

    signal.signal(signal.SIGINT, handler)
    signal.signal(signal.SIGTERM, handler)
    ev.wait()
