"""The port's raw scheduling loop (loop.run_raw) against the JAX package's
speculative engine chained the way bench.py run() chains it, on CPU at a
small size: the winners must be identical pod for pod, for every workload
(the pod (anti-)affinity ones with existing pods and the in-batch affinity
state).  The full-width comparisons run on the card in chip_smoke.py
against the golden files tests/data/torch_port_golden_*.npz.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from kubernetes_tpu_torch import loop

from make_torch_golden import GOLDENS, golden_path, jax_chained_hosts


@pytest.mark.parametrize(
    "workload,n_nodes,n_pods,batch,node_pods,existing", [
        ("plain", 120, 700, 256, 110, 0),
        ("node-affinity", 120, 700, 256, 110, 0),
        # 2 slots per node: demand exceeds the slots, the hybrid check fires
        ("plain", 150, 420, 128, 2, 0),
        ("pod-affinity", 120, 700, 256, 110, 0),
        ("pod-anti-affinity", 120, 700, 256, 110, 0),
        ("pod-anti-affinity", 120, 700, 256, 110, 100),
        # the 2-slot anti-affinity redo: deferred retirement, redone
        # batches through the sequential engine with the affinity carry
        ("pod-anti-affinity", 120, 300, 128, 2, 0),
    ])
def test_run_raw_matches_jax_chain(workload, n_nodes, n_pods, batch,
                                   node_pods, existing):
    want, stats = jax_chained_hosts(n_nodes, n_pods, batch, workload,
                                    node_pods=node_pods, existing=existing)
    res = loop.run_raw(
        loop.bench_nodes(n_nodes, node_pods),
        [loop.pending_pod(i, workload) for i in range(n_pods)],
        batch, device="cpu", existing=existing)
    np.testing.assert_array_equal(want, res["hosts"])
    assert res["rounds"] == [r for r, _ in stats]
    assert res["redos"] == sum(int(r) for _, r in stats)
    if node_pods == 2:
        assert res["redos"] > 0
    else:
        assert res["scheduled"] == n_pods
    assert set(res["phases"]) == {"encode", "launch", "fetch", "commit"}
    assert res["pods_per_s"] > 0


def test_sequential_engine_loop_matches_speculative_split():
    """Both engines through run_raw on the tight fleet: the speculative
    engine's hybrid check keeps the scheduled/unschedulable split of the
    one-at-a-time engine."""
    nodes = loop.bench_nodes(60, 2)
    pods = [loop.pending_pod(i) for i in range(150)]
    spec = loop.run_raw(nodes, pods, 64, device="cpu")
    seq = loop.run_raw(nodes, pods, 64, device="cpu", engine="sequential")
    assert spec["scheduled"] == seq["scheduled"]
    assert seq["rounds"] == [] and seq["redos"] == 0


@pytest.mark.parametrize("workload", sorted(GOLDENS))
def test_golden_file_shape(workload):
    path = golden_path(workload)
    data = np.load(path)
    hosts = data["hosts"]
    assert hosts.dtype == np.int32 and hosts.shape == (10000,)
    assert int(data["nodes"]) == 5000 and int(data["batch"]) == 2048
    assert int(data["existing"]) == GOLDENS[workload]
    assert int(data["node_pods"]) == 110 and int(data["redos"]) == 0
    assert len(data["rounds"]) == 5
    assert (hosts >= 0).all() and hosts.max() < 5000
    assert os.path.getsize(path) < 1 << 20
