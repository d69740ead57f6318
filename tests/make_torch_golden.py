"""Regenerate tests/data/torch_port_golden_plain.npz: the JAX speculative
engine's winners for bench.py's plain workload at full width (5,000 nodes,
10,000 pending pods, batch 2,048), computed on the CPU.

Not a test.  It imports the JAX package; chip_smoke.py only reads the file
and requires the PyTorch port's winners on the card to equal it bit for bit.

    python tests/make_torch_golden.py            # full width, ~minutes
    python tests/make_torch_golden.py --nodes 64 --pods 300 --batch 128 \
        --out /tmp/small.npz                     # a quick small run

The loop mirrors bench.py run()'s timed section: batch k+1 is encoded and
launched before batch k is committed (overlap_commit), the tail batch is
padded to the batch width with its padding marked valid=False, and the
device state is chained between batches.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import time
from types import SimpleNamespace

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

DEFAULT_OUT = os.path.join(_ROOT, "tests", "data",
                           "torch_port_golden_plain.npz")


def jax_chained_hosts(n_nodes: int, n_pods: int, batch: int,
                      workload: str = "plain", node_pods: int = 110):
    """hosts i32[n_pods] from the JAX speculative engine, chained over
    batches exactly as bench.py run() does, plus per-batch (rounds, redo).

    node_pods overrides the fleet's per-node pod cap (bench.py uses 110);
    a small cap makes demand exceed the slots and fires the hybrid redo."""
    import jax

    import bench
    from kubernetes_tpu.api.factory import make_node
    from kubernetes_tpu.models.batched import encode_batch_ports
    from kubernetes_tpu.models.speculative import make_speculative_scheduler

    args = SimpleNamespace(nodes=n_nodes, workload=workload)
    nodes = bench._bench_nodes(args)
    if node_pods != bench._NODE_PODS_CAP:
        nodes = [
            make_node(n.name, cpu="32", mem="256Gi", pods=node_pods,
                      labels=dict(n.labels),
                      taints=[{"key": t.key, "value": t.value,
                               "effect": t.effect} for t in n.spec.taints])
            for n in nodes
        ]
    enc = bench._build_encoder(args, nodes)
    fn = make_speculative_scheduler(
        unsched_taint_key=enc.interner.intern(
            "node.kubernetes.io/unschedulable"),
        zone_key_id=enc.getzone_key,
    )
    row_names = {row: name for name, row in enc.node_rows.items()}
    out = np.full(n_pods, -1, np.int32)
    stats = []

    def commit(start, pods, hosts_dev):
        hosts = np.asarray(hosts_dev)
        committed = []
        for j, pod in enumerate(pods):
            r = int(hosts[j])
            out[start + j] = r
            if r < 0:
                continue
            spec = copy.copy(pod.spec)
            spec.node_name = row_names[r]
            c = copy.copy(pod)
            c.spec = spec
            committed.append(c)
        enc.add_pods(committed)

    state = enc.snapshot()
    last = 0
    in_flight = None
    for start in range(0, n_pods, batch):
        n = min(batch, n_pods - start)
        pods = [bench._pending_pod(args, start + j) for j in range(n)]
        if n < batch:
            pods += [bench._pending_pod(args, start) for _ in range(batch - n)]
        b = enc.encode_pods(pods)
        if n < batch:
            valid = np.array(b.valid, bool)
            valid[n:] = False
            b = dataclasses.replace(b, valid=valid)
        ports = encode_batch_ports(enc, pods)
        hosts, state = fn(state, b, ports, np.int32(last))
        stats.append((int(fn.last_rounds), bool(fn.last_redo)))
        last += n
        if in_flight is not None:
            commit(*in_flight)
        in_flight = (start, pods[:n], hosts)
    commit(*in_flight)
    jax.block_until_ready(state.requested)
    return out, stats


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=5000)
    ap.add_argument("--pods", type=int, default=10000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.monotonic()
    hosts, stats = jax_chained_hosts(args.nodes, args.pods, args.batch)
    dt = time.monotonic() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, hosts=hosts,
        nodes=np.int32(args.nodes), pods=np.int32(args.pods),
        batch=np.int32(args.batch),
    )
    print(f"wrote {args.out}: {int((hosts >= 0).sum())}/{len(hosts)} placed, "
          f"rounds/redo per batch {stats}, {dt:.1f} s on the CPU")


if __name__ == "__main__":
    main()
