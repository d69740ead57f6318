"""Regenerate the golden files tests/data/torch_port_golden_<workload>.npz:
the JAX speculative engine's winners for one of bench.py's workloads at
full width (5,000 nodes, 10,000 pending pods, batch 2,048), computed on the
CPU.

Not a test.  It imports the JAX package; chip_smoke.py only reads the files
and requires the PyTorch port's winners on the card to equal them bit for
bit.

    python tests/make_torch_golden.py                      # plain, ~5 s
    python tests/make_torch_golden.py --workload pod-anti-affinity \
        --existing 1000                                    # ~20-30 s
    python tests/make_torch_golden.py --workload pod-affinity
    python tests/make_torch_golden.py --nodes 64 --pods 300 --batch 128 \
        --out /tmp/small.npz                               # a quick small run

The loop mirrors bench.py run()'s timed section: `existing` running pods
are added first; for the plain and node-affinity workloads batch k+1 is
encoded and launched before batch k is committed (overlap_commit), the pod
(anti-)affinity workloads commit first and pass the in-batch affinity
state; the tail batch is padded to the batch width with its padding marked
valid=False, and the device state is chained between batches.
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

def golden_path(workload: str) -> str:
    """tests/data/torch_port_golden_<workload, dashes as underscores>.npz"""
    return os.path.join(_ROOT, "tests", "data", "torch_port_golden_"
                        f"{workload.replace('-', '_')}.npz")


DEFAULT_OUT = golden_path("plain")
# the full-width goldens: workload -> running pods added before the clock
GOLDENS = {"plain": 0, "pod-anti-affinity": 1000, "pod-affinity": 0}


def jax_chained_hosts(n_nodes: int, n_pods: int, batch: int,
                      workload: str = "plain", node_pods: int = 110,
                      existing: int = 0):
    """hosts i32[n_pods] from the JAX speculative engine, chained over
    batches exactly as bench.py run() does, plus per-batch (rounds, redo).

    node_pods overrides the fleet's per-node pod cap (bench.py uses 110);
    a small cap makes demand exceed the slots and fires the hybrid redo.
    existing running pods are added first, as bench.py's --existing."""
    import jax

    import bench
    from kubernetes_tpu.api.factory import make_node, make_pod
    from kubernetes_tpu.models.batched import (
        batch_has_pod_affinity,
        encode_batch_affinity,
        encode_batch_ports,
    )
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
    for i in range(existing):
        enc.add_pod(make_pod(
            f"existing-{i}", cpu="100m", mem="256Mi",
            labels={"app": f"dep-{i % bench._N_DEPLOY}"},
            node_name=f"node-{i % n_nodes}",
            owner=("ReplicaSet", f"rs-{i % bench._N_DEPLOY}")))
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
    overlap_commit = workload in ("plain", "node-affinity")
    for start in range(0, n_pods, batch):
        n = min(batch, n_pods - start)
        pods = [bench._pending_pod(args, start + j) for j in range(n)]
        if n < batch:
            pods += [bench._pending_pod(args, start) for _ in range(batch - n)]
        if not overlap_commit and in_flight is not None:
            commit(*in_flight)
            in_flight = None
        aff = (encode_batch_affinity(enc, pods)
               if batch_has_pod_affinity(pods) else None)
        b = enc.encode_pods(pods)
        if n < batch:
            valid = np.array(b.valid, bool)
            valid[n:] = False
            b = dataclasses.replace(b, valid=valid)
        ports = encode_batch_ports(enc, pods)
        hosts, state = fn(state, b, ports, np.int32(last), aff_state=aff)
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
    ap.add_argument("--workload", default="plain",
                    choices=("plain", "node-affinity", "pod-affinity",
                             "pod-anti-affinity"))
    ap.add_argument("--existing", type=int, default=0,
                    help="running pods added before the clock")
    ap.add_argument("--node-pods", type=int, default=110,
                    help="pod slots per node")
    ap.add_argument("--out", default=None,
                    help="default: tests/data/torch_port_golden_<workload>"
                         ".npz")
    args = ap.parse_args()
    out = args.out or golden_path(args.workload)

    import jax

    jax.config.update("jax_platforms", "cpu")
    t0 = time.monotonic()
    hosts, stats = jax_chained_hosts(args.nodes, args.pods, args.batch,
                                     args.workload, args.node_pods,
                                     args.existing)
    dt = time.monotonic() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(
        out, hosts=hosts,
        nodes=np.int32(args.nodes), pods=np.int32(args.pods),
        batch=np.int32(args.batch), existing=np.int32(args.existing),
        node_pods=np.int32(args.node_pods),
        rounds=np.array([r for r, _ in stats], np.int32),
        redos=np.int32(sum(int(r) for _, r in stats)),
    )
    print(f"wrote {out}: {int((hosts >= 0).sum())}/{len(hosts)} placed, "
          f"rounds/redo per batch {stats}, {dt:.1f} s on the CPU")


if __name__ == "__main__":
    main()
