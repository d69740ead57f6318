"""The PyTorch port's object factory and encoder against the JAX package's.

Objects built from the same arguments by each package's factory must encode
to identical numpy arrays (same dtype, shape and contents) for every field
of ClusterTensors and PodBatch, and to the same batch port vocabulary; and
the converters must carry the arrays to torch tensors and back unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bench
from kubernetes_tpu.codec import schema as jax_schema
from kubernetes_tpu.models.batched import encode_batch_ports as jax_ports
from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.codec import schema as port_schema
from kubernetes_tpu_torch.models.batched import encode_batch_ports as port_ports

from torch_port_helpers import assert_fields_equal, twin_world


@pytest.mark.parametrize("seed,with_affinity", [
    (1, True), (2, True), (3, False), (4, True),
])
def test_random_world_encodes_identically(seed, with_affinity):
    jenc, penc, jpods, ppods = twin_world(seed, with_affinity=with_affinity)
    assert_fields_equal(jenc.snapshot(), penc.snapshot(),
                        port_schema.ClusterTensors, "cluster")
    for lo, hi in ((0, 32), (32, 48)):
        jb = jenc.encode_pods(jpods[lo:hi])
        pb = penc.encode_pods(ppods[lo:hi])
        assert_fields_equal(jb, pb, port_schema.PodBatch, f"pods[{lo}:{hi}]")
        assert_fields_equal(jax_ports(jenc, jpods[lo:hi]),
                            port_ports(penc, ppods[lo:hi]),
                            type(port_ports(penc, ppods[lo:hi])), "ports")


@pytest.mark.parametrize("workload", ["plain", "node-affinity"])
def test_bench_fleet_copies_match_bench(workload):
    """loop.bench_nodes / pending_pod are the port's copies of bench.py's
    _bench_nodes / _pending_pod: same snapshot, same encoded batches, also
    after committing a batch."""
    from types import SimpleNamespace

    args = SimpleNamespace(nodes=150, workload=workload)
    jenc = bench._build_encoder(args, bench._bench_nodes(args))
    penc = loop.build_encoder(loop.bench_nodes(150))
    assert_fields_equal(jenc.snapshot(), penc.snapshot(),
                        port_schema.ClusterTensors, "cluster")
    jp = [bench._pending_pod(args, i) for i in range(64)]
    pp = [loop.pending_pod(i, workload) for i in range(64)]
    assert_fields_equal(jenc.encode_pods(jp), penc.encode_pods(pp),
                        port_schema.PodBatch, "batch")
    for enc, pods in ((jenc, jp), (penc, pp)):
        for j, p in enumerate(pods[:40]):
            p.spec.node_name = f"node-{(7 * j) % 150}"
        enc.add_pods(pods[:40])
    assert_fields_equal(jenc.snapshot(), penc.snapshot(),
                        port_schema.ClusterTensors, "after commit")
    assert_fields_equal(jenc.encode_pods(jp[40:]), penc.encode_pods(pp[40:]),
                        port_schema.PodBatch, "after commit batch")


def test_schema_tables_match():
    for name in ("PREDICATE_ORDER", "PRIORITY_ORDER", "PRED_INDEX",
                 "PRIO_INDEX", "RES_MILLICPU", "RES_MEMORY", "RES_PODS",
                 "RES_EXT0", "PAD", "WILDCARD", "FIELD_NODE_NAME_ID",
                 "EFFECT_CODES", "TOL_OP_CODES", "SEL_OP_CODES"):
        assert getattr(jax_schema, name) == getattr(port_schema, name), name
    assert np.array_equal(jax_schema.DEFAULT_PRIORITY_WEIGHTS,
                          port_schema.DEFAULT_PRIORITY_WEIGHTS)
    assert jax_schema.PadDims() == jax_schema.PadDims(
        **vars(port_schema.PadDims()))
    assert jax_schema.FilterConfig() == jax_schema.FilterConfig(
        **vars(port_schema.FilterConfig()))


def test_converters_round_trip_jax_dataclasses():
    """cluster_to_torch / pods_to_torch take the JAX encoder's dataclasses
    field for field, keep every dtype, and to_numpy brings them back."""
    jenc, _, jpods, _ = twin_world(5)
    ct = jenc.snapshot()
    pb = jenc.encode_pods(jpods[:32])
    tc = port_schema.cluster_to_torch(ct, "cpu")
    tp = port_schema.pods_to_torch(pb, "cpu")
    dt = {torch.float32: np.float32, torch.int32: np.int32,
          torch.bool: np.bool_}
    for obj, src in ((tc, ct), (tp, pb)):
        for name, val in vars(obj).items():
            assert isinstance(val, torch.Tensor), name
            assert val.device.type == "cpu"
            assert np.dtype(dt[val.dtype]) == np.asarray(getattr(src, name)).dtype
    assert_fields_equal(port_schema.to_numpy(tc), ct,
                        port_schema.ClusterTensors, "cluster")
    assert_fields_equal(port_schema.to_numpy(tp), pb, port_schema.PodBatch,
                        "pods")
    ports = port_schema.ports_to_torch(jax_ports(jenc, jpods[:32]), "cpu")
    assert ports.pod_ports.dtype == torch.bool
