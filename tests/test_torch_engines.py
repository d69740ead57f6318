"""The PyTorch port's sequential and speculative engines against the JAX
package's, on CPU.

Both packages see the same JAX-encoded batches; the port gets them through
pods_to_torch / ports_to_torch.  Over several chained batches, the winners
(hosts) must be identical and the committed requested / nonzero_req columns
equal, for plain pods, node affinity, host ports and a tight cluster where
the speculative engine's hybrid check redoes the batch through the
sequential engine (as tests/test_speculative.py:86 and :490 do for JAX).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubernetes_tpu.codec import SnapshotEncoder
from kubernetes_tpu.models.batched import encode_batch_ports
from kubernetes_tpu.models.batched import make_sequential_scheduler as jax_seq
from kubernetes_tpu.models.speculative import (
    make_speculative_scheduler as jax_spec,
)
from kubernetes_tpu_torch.codec.schema import (
    cluster_to_torch,
    pods_to_torch,
    ports_to_torch,
)
from kubernetes_tpu_torch.models.batched import (
    check_exact_matmul,
    make_sequential_scheduler as port_seq,
)
from kubernetes_tpu_torch.models.speculative import (
    make_speculative_scheduler as port_spec,
)

from fixtures import make_node, make_pod
from torch_port_helpers import engine_keys, twin_world

MAKERS = {"sequential": (jax_seq, port_seq),
          "speculative": (jax_spec, port_spec)}


def _chain(enc, batches, engine, select_impl="kernel"):
    """Run both packages' engines over `batches` (lists of pods), chaining
    each one's own cluster state; compare every batch."""
    jmake, pmake = MAKERS[engine]
    kw = engine_keys(enc)
    jfn = jmake(**kw)
    pfn = pmake(device="cpu", select_impl=select_impl, **kw)
    jstate = enc.snapshot()
    pstate = cluster_to_torch(jstate, "cpu")
    last = 0
    redos = 0
    for pods in batches:
        pb = enc.encode_pods(pods)
        ports = encode_batch_ports(enc, pods)
        jh, jstate = jfn(jstate, pb, ports, np.int32(last))
        th, pstate = pfn(pstate, pods_to_torch(pb, "cpu"),
                         ports_to_torch(ports, "cpu"), last)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        assert th.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(jstate.requested),
                                      pstate.requested.numpy())
        np.testing.assert_array_equal(np.asarray(jstate.nonzero_req),
                                      pstate.nonzero_req.numpy())
        if engine == "speculative":
            assert pfn.last_redo == bool(np.asarray(jfn.last_redo))
            assert pfn.last_rounds == int(jfn.last_rounds)
            redos += int(pfn.last_redo)
        last += len(pods)
    return redos


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
@pytest.mark.parametrize("seed,with_affinity", [(21, True), (22, False)])
def test_random_world_chained_batches(engine, seed, with_affinity):
    """Randomized clusters: node selectors, required/preferred node
    affinity, tolerations, host ports, images, and existing pods'
    inter-pod (anti-)affinity terms."""
    jenc, _, jpods, _ = twin_world(seed, n_pending=96,
                                   with_affinity=with_affinity)
    _chain(jenc, [jpods[0:32], jpods[32:64], jpods[64:96]], engine)


def _tight_encoder():
    enc = SnapshotEncoder()
    for i in range(6):
        enc.add_node(make_node(f"n{i}", cpu="2", mem="8Gi", pods=6,
                               labels={"disk": "ssd" if i % 2 else "hdd"}))
    enc.add_spread_selector("default", {"app": "w"})
    return enc


@pytest.mark.parametrize("select_impl", ["kernel", "plain"])
def test_tight_binpack_redo_soak(select_impl):
    """Near-full bin packing where the proposal order changes the packing:
    the hybrid check must redo batches, and the result must still equal
    the JAX engine's (mirrors test_speculative.py's tight soak)."""
    redos = 0
    for seed in range(8):
        rng = np.random.default_rng(2000 + seed)
        enc = _tight_encoder()
        pods = [
            make_pod(f"p{seed}-{i}", cpu=f"{int(rng.integers(3, 14)) * 100}m",
                     labels={"app": "w"},
                     node_selector={"disk": "ssd"} if i % 4 == 0 else None)
            for i in range(24)
        ]
        redos += _chain(enc, [pods[:12], pods[12:]], "speculative",
                        select_impl)
    assert redos > 0


def test_host_ports_in_batch():
    enc = SnapshotEncoder()
    for i in range(4):
        enc.add_node(make_node(f"n{i}", cpu="4", mem="8Gi"))
    enc.add_pod(make_pod("e0", cpu="100m", node_name="n1",
                         ports=[{"hostPort": 8080, "protocol": "TCP"}]))
    pods = [
        make_pod(f"p{i}", cpu="100m",
                 ports=[{"hostPort": 8080 + (i % 2), "protocol": "TCP",
                         **({"hostIP": "10.0.0.1"} if i % 3 == 0 else {})}])
        for i in range(10)
    ]
    for engine in MAKERS:
        _chain(enc, [pods[:6], pods[6:]], engine)


def test_node_affinity_and_spread_batches():
    enc = SnapshotEncoder()
    for i in range(24):
        enc.add_node(make_node(
            f"n{i}", cpu="8", mem="16Gi",
            labels={"failure-domain.beta.kubernetes.io/zone": f"z{i % 3}",
                    "tier": "a" if i % 3 else "b"}))
    for d in range(4):
        enc.add_spread_selector("default", {"app": f"d{d}"})
    aff = {"nodeAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": {
        "nodeSelectorTerms": [{"matchExpressions": [
            {"key": "tier", "operator": "In", "values": ["a"]}]}]}}}
    pods = [make_pod(f"p{i}", cpu="300m", mem="512Mi",
                     labels={"app": f"d{i % 4}"},
                     affinity=aff if i % 2 else None)
            for i in range(60)]
    for engine in MAKERS:
        _chain(enc, [pods[:20], pods[20:40], pods[40:]], engine)


@pytest.mark.parametrize("pct", [0, 30])
def test_node_sampling_percentage(pct):
    """percentage_of_nodes_to_score < 100 (0 = adaptive): both engines
    confine selection to the first feasible nodes in rotated order."""
    jenc, _, jpods, _ = twin_world(31, n_nodes=160, n_pending=64,
                                   with_affinity=False)
    kw = dict(engine_keys(jenc), percentage_of_nodes_to_score=pct)
    for jmake, pmake in MAKERS.values():
        state_j = jenc.snapshot()
        state_p = cluster_to_torch(state_j, "cpu")
        jfn, pfn = jmake(**kw), pmake(device="cpu", **kw)
        for lo in (0, 32):
            pods = jpods[lo:lo + 32]
            pb = jenc.encode_pods(pods)
            ports = encode_batch_ports(jenc, pods)
            jh, state_j = jfn(state_j, pb, ports, np.int32(2**31 - 40 + lo))
            th, state_p = pfn(state_p, pods_to_torch(pb, "cpu"),
                              ports_to_torch(ports, "cpu"), 2**31 - 40 + lo)
            np.testing.assert_array_equal(np.asarray(jh), th.numpy())


def test_later_slices_raise():
    """Attribution still raises; quality top-k is ported and adds one
    output; nominated pods are ported (slice 4): an all-empty
    NominatedState places like none."""
    from kubernetes_tpu_torch.models.batched import NominatedState

    enc = _tight_encoder()
    kw = engine_keys(enc)
    for make in (port_seq, port_spec):
        fn = make(device="cpu", **kw)
        pods = [make_pod("p", cpu="100m")]
        pb = enc.encode_pods(pods)
        ports = encode_batch_ports(enc, pods)
        empty = NominatedState(node=np.full(8, -1, np.int32),
                               prio=np.zeros(8, np.int32),
                               req=np.ones((8, pb.req.shape[1]), np.float32))
        h0, _ = fn(enc.snapshot(), pb, ports, 0)
        h1, _ = fn(enc.snapshot(), pb, ports, 0, nominated=empty)
        np.testing.assert_array_equal(h0.numpy(), h1.numpy())
    with pytest.raises(NotImplementedError):
        port_seq(device="cpu", attribution=True)
    with pytest.raises(NotImplementedError):
        port_seq(device="cpu", attribution=True, quality_topk=3)
    for make in (port_seq, port_spec):
        fn = make(device="cpu", quality_topk=3, **kw)
        out = fn(enc.snapshot(), pb, ports, 0)
        assert len(out) == 3 and fn.quality_topk == 3
    with pytest.raises(ValueError):
        port_spec(device="cpu", select_impl="fast")


def test_extra_mask_and_score_fold_in():
    enc = _tight_encoder()
    kw = engine_keys(enc)
    pods = [make_pod(f"p{i}", cpu="200m") for i in range(8)]
    pb = enc.encode_pods(pods)
    ports = encode_batch_ports(enc, pods)
    B, N = pb.req.shape[0], enc.snapshot().allocatable.shape[0]
    rng = np.random.default_rng(4)
    emask = rng.random((B, N)) < 0.7
    escore = rng.integers(0, 5, (B, N)).astype(np.float32)
    for jmake, pmake in MAKERS.values():
        jh, _ = jmake(**kw)(enc.snapshot(), pb, ports, np.int32(3),
                            extra_mask=emask, extra_score=escore)
        th, _ = pmake(device="cpu", **kw)(enc.snapshot(), pb, ports, 3,
                                          extra_mask=emask,
                                          extra_score=escore)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())


def test_engines_refuse_tf32_matmuls():
    """The count products must stay exact f32 on the card: with TF32
    matmuls enabled the engines raise instead of running."""
    check_exact_matmul("cuda")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError):
            check_exact_matmul("cuda")
        check_exact_matmul("cpu")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
