"""Where the extender sidecar's host time goes, on the card, without HTTP.

    python3 tools/sidecar_profile.py [--pods 80] [--top 30]

Builds the port's ExtenderServer on the card with chip_smoke.py phase 18's
mirror (the bench fleet of 5,000 nodes, its 20 spread selectors, 1,000
running pods), then calls its verbs in-process as a stock scheduler would
for each pending pod: filter with every node name, prioritize with the
filter's names, bind to the highest score.  A warmup of 40 pods, then
`--pods` pods timed (ms a pod, the sidecar's /filter split by part) and
`--pods` more under cProfile, whose functions are printed by own time and
by cumulative time.  Host functions that wait on the card absorb the wait
in their own time.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from kubernetes_tpu_torch import loop  # noqa: E402
from kubernetes_tpu_torch.api.serialize import pod_to_dict  # noqa: E402
from kubernetes_tpu_torch.extender.server import ExtenderServer  # noqa: E402
from kubernetes_tpu_torch.runtime.cache import SchedulerCache  # noqa: E402

WARMUP = 40


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pods", type=int, default=80)
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("sidecar_profile: needs a CUDA card")
    nodes = loop.bench_nodes(5000)
    srv = ExtenderServer(cache=SchedulerCache(loop.build_encoder(nodes, 1000)),
                         device="cuda")
    names = [n.name for n in nodes]
    pods = [loop.pending_pod(i) for i in range(WARMUP + 2 * args.pods)]

    def one(pod) -> None:
        wire = pod_to_dict(pod)
        ok = srv.filter({"pod": wire, "nodenames": names})["nodenames"]
        scores = srv.prioritize({"pod": wire, "nodenames": ok})
        best = scores[0]
        for e in scores[1:]:
            if e["score"] > best["score"]:
                best = e
        srv.bind({"PodName": pod.name, "PodNamespace": pod.namespace,
                  "PodUID": pod.metadata.uid, "Node": best["host"]})

    for pod in pods[:WARMUP]:
        one(pod)
    torch.cuda.synchronize()
    split0, n0 = dict(srv.filter_seconds), srv.filter_requests
    t0 = time.perf_counter()
    for pod in pods[WARMUP:WARMUP + args.pods]:
        one(pod)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_f = srv.filter_requests - n0
    split = {k: (v - split0[k]) / n_f * 1e3
             for k, v in srv.filter_seconds.items()}
    print(f"ms a pod (filter + prioritize + bind, no HTTP) "
          f"{dt / args.pods * 1e3:.3f} | a filter's split ms: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items() if k != "json"),
          flush=True)
    prof = cProfile.Profile()
    prof.enable()
    for pod in pods[WARMUP + args.pods:]:
        one(pod)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof)
    stats.sort_stats("tottime").print_stats(args.top)
    stats.sort_stats("cumulative").print_stats(args.top)


if __name__ == "__main__":
    main()
