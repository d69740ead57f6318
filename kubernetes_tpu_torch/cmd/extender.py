"""Extender sidecar binary (PyTorch port).

The deployable artifact for hybrid clusters: a stock kube-scheduler offloads
Filter/Prioritize/Preempt/Bind to this process over the extender wire
protocol (pkg/scheduler/core/extender.go; server side in
kubernetes_tpu_torch/extender/server.py), while the card evaluates every
node per request.  Cluster state arrives through the /sync/* endpoints
(NodeCacheCapable contract).

    python -m kubernetes_tpu_torch.cmd.extender --port 10250
    python -m kubernetes_tpu_torch.cmd.extender --device cpu --port 10250
"""

from __future__ import annotations

import argparse
import sys

from kubernetes_tpu_torch.cmd.base import (
    add_common_flags,
    load_component_config,
    wait_for_term,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kubernetes-tpu-torch-extender",
        description="scheduler-extender sidecar on a CUDA card",
    )
    add_common_flags(p)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=10250)
    return p


def build_server(args):
    """The ExtenderServer the parsed flags describe (not started): the
    config file's profile gives the filter config."""
    from kubernetes_tpu_torch.extender.server import ExtenderServer
    from kubernetes_tpu_torch.runtime.cache import SchedulerCache

    profile = load_component_config(args.config).build_profile()
    return ExtenderServer(
        cache=SchedulerCache(),
        host=args.host,
        port=args.port,
        filter_config=profile.filter_config,
        device=args.device,
    )


def main(argv=None) -> int:
    from kubernetes_tpu_torch.utils import klog

    args = build_parser().parse_args(argv)
    klog.set_verbosity(args.verbosity)
    srv = build_server(args)
    srv.start()
    print(f"extender serving on {srv.address[0]}:{srv.address[1]} "
          f"({srv.device})", file=sys.stderr)
    try:
        wait_for_term()
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
