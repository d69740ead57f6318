"""Time the port's plain batch on the host clock, in one process.

    python3 tools/engine_wall.py [--root TREE] [--reps 20] [--raw 3]
        [--live 3] [--out RESULT.json]

Three numbers of the plain cell (the bench fleet of 5,000 nodes, plain
pending pods, batches of 2,048), all through the speculative engine:

- "call": one warm engine call over the first 2,048 pods, the snapshot
  uploaded once, each call ending in a synchronize: median, min and max ms
  of --reps calls (unprofiled);
- "raw": loop.run_raw's pods/s over 10,000 pods, --raw runs;
- "live": loop.run_live's pods/s over 10,000 pods (chip_smoke.py's
  phase 11 without its checks), --live runs.

With --root the port is imported from that tree (another commit's
checkout), so two versions are compared in one process each on the same
card.  Where the engine builds a CUDA graph a call, the record also holds
the host seconds of its build by part (kernels.GRAPH_STATS).  Prints one
JSON line and writes it to --out too.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--raw", type=int, default=3)
    ap.add_argument("--live", type=int, default=3)
    ap.add_argument("--out", default="")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from kubernetes_tpu_torch import kernels, loop
    from kubernetes_tpu_torch.codec import transfer
    from kubernetes_tpu_torch.models.batched import encode_batch_ports
    from kubernetes_tpu_torch.models.speculative import (
        make_speculative_scheduler)

    if not torch.cuda.is_available():
        sys.exit("engine_wall.py needs a CUDA card")
    nodes = loop.bench_nodes(5000)
    pods = [loop.pending_pod(i) for i in range(10000)]
    enc = loop.build_encoder(nodes)
    fn = make_speculative_scheduler(
        unsched_taint_key=enc.interner.intern(
            "node.kubernetes.io/unschedulable"),
        zone_key_id=enc.getzone_key, device="cuda")
    batch = pods[:2048]
    pb, ports = enc.encode_pods(batch), encode_batch_ports(enc, batch)
    state = transfer.upload_cluster(enc.snapshot(), "cuda")
    for _ in range(3):
        fn(state, pb, ports, 0)
    torch.cuda.synchronize()
    stats = getattr(kernels, "GRAPH_STATS", None)
    before = dict(stats) if stats else None
    walls = []
    for _ in range(a.reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn(state, pb, ports, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    rec = {"root": os.path.abspath(a.root), "card": torch.cuda.get_device_name(0),
           "call_ms": {"median": statistics.median(walls), "min": min(walls),
                       "max": max(walls), "reps": a.reps}}
    if stats:
        n = stats["builds"] - before["builds"]
        rec["graph_build_ms"] = {
            k: (stats[k] - before[k]) / max(n, 1) * 1e3
            for k in stats if k != "builds"}
    rec["raw_pods_per_s"] = [
        loop.run_raw(nodes, pods, 2048, device="cuda")["pods_per_s"]
        for _ in range(a.raw)]
    rec["live_pods_per_s"] = [
        loop.run_live(nodes, 10000, 2048, device="cuda")["pods_per_s"]
        for _ in range(a.live)]
    line = json.dumps(rec)
    print(line, flush=True)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
