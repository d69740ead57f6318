"""The extender slice's oracle: the port's extender seam against the JAX
package's, on the CPU.

K7's plain twin (ops/predicates.py fold_predicates_plain) against the
jitted JAX fold on kernels/k7_cases.py; models/generic.py
schedule_batch_independent against the jitted JAX function on all seven
outputs; the port's ExtenderServer against the JAX one on the same sync
sequence and requests (every verb, both filter wire modes, the error
replies), and loop.drive_extender against both; the port's Scheduler with
extenders (transport stubs, a Policy's extenders, the preempt verb, a real
HTTP round trip to the port's server) against the JAX Scheduler; the port's
HTTPExtender retry discipline; the golden files chip_smoke.py phases 18 and
19 read; the binary's flags.

Tolerance: none.  Every array is bit-identical and every reply body equal
as canonical JSON.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fixtures
from kubernetes_tpu.codec.schema import FilterConfig as JaxFilterConfig
from kubernetes_tpu.config import profile_from_policy as jax_policy
from kubernetes_tpu.extender import client as jclient
from kubernetes_tpu.extender.server import ExtenderServer as JaxServer
from kubernetes_tpu.models.generic import (
    schedule_batch_independent as jax_independent,
)
from kubernetes_tpu.ops.predicates import first_failure as jax_first_failure
from kubernetes_tpu.runtime.cache import SchedulerCache as JaxCache
from kubernetes_tpu.runtime.queue import PriorityQueue as JaxQueue
from kubernetes_tpu.runtime.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.runtime.scheduler import SchedulerConfig as JaxConfig
from kubernetes_tpu_torch import kernels, loop
from kubernetes_tpu_torch.api import factory as port_factory
from kubernetes_tpu_torch.api.serialize import node_to_dict, pod_to_dict
from kubernetes_tpu_torch.codec.schema import (
    NUM_PREDICATES,
    FilterConfig,
    cluster_to_torch,
    pods_to_torch,
)
from kubernetes_tpu_torch.config import profile_from_policy as port_policy
from kubernetes_tpu_torch.extender import client as pclient
from kubernetes_tpu_torch.extender.server import ExtenderServer
from kubernetes_tpu_torch.kernels import k7_cases
from kubernetes_tpu_torch.models.generic import schedule_batch_independent
from kubernetes_tpu_torch.ops.predicates import fold_predicates_plain
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.runtime.queue import PriorityQueue
from kubernetes_tpu_torch.runtime.scheduler import Scheduler, SchedulerConfig

from make_torch_golden import golden_path, jax_extender, jax_live
from torch_port_helpers import (
    UNSCHED_KEY,
    process_state_kept,
    twin_world,
)

CPU_MAX = 1 << 20


# ------------------------------------------------------------------ K7 twin


@jax.jit
def _jax_fold(stack, valid, pod_valid):
    alive = valid[None] & pod_valid[:, None]
    return jnp.all(stack, axis=1) & alive, jax_first_failure(stack)


@functools.lru_cache(maxsize=1)
def _k7_cpu_cases():
    return dict(k7_cases.cases(CPU_MAX))


@pytest.mark.parametrize("name", [n for n, b, nn in k7_cases.shapes()
                                  if b * nn <= CPU_MAX])
def test_k7_twin_matches_jax_fold(name):
    case = _k7_cpu_cases()[name]
    want_mask, want_fail = _jax_fold(case["per_pred"], case["valid"],
                                     case["pod_valid"])
    got_mask, got_fail = fold_predicates_plain(
        *(torch.from_numpy(case[k])
          for k in ("per_pred", "valid", "pod_valid")))
    assert got_fail.dtype == torch.int32
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_fail.numpy(), np.asarray(want_fail))


def test_k7_cases_cover_their_shapes():
    assert k7_cases.K == NUM_PREDICATES
    shapes = k7_cases.shapes()
    assert {b for _, b, _ in shapes} == set(k7_cases.BS)
    assert {n for _, _, n in shapes} == set(k7_cases.NS)
    assert shapes[-2:] == [("extender", 1, 6144),
                           ("attribution", 2048, 6144)]
    c = dict(k7_cases.cases(64))["b7-n5"]
    assert c["per_pred"][0].all() and not c["per_pred"][-1].any()
    assert c["per_pred"][:-1, 5].all() and not c["valid"][3]
    assert not c["pod_valid"][4]


def test_k7_wrapper_refuses_cpu_tensors():
    z = torch.zeros((1, 23, 8), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fold_predicates(z, torch.ones(8, dtype=torch.bool),
                                torch.ones(1, dtype=torch.bool))


@pytest.mark.cuda
def test_k7_matches_plain_twin_on_card():
    """K7 against its twin on every k7_cases case (the list chip_smoke.py
    checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 has no CPU mode")
    for name, case in k7_cases.cases():
        args = [torch.from_numpy(case[k]).cuda()
                for k in ("per_pred", "valid", "pod_valid")]
        got = kernels.fold_predicates(*args)
        want = fold_predicates_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            name


# ------------------------------------------- schedule_batch_independent


def _generic_inputs(seed, n_pending, enabled=None):
    jenc, penc, jpods, ppods = twin_world(seed, n_pending=n_pending)
    jcfg = jenc.adopt_filter_config(JaxFilterConfig(enabled=enabled))
    pcfg = penc.adopt_filter_config(FilterConfig(enabled=enabled))
    jpb = jenc.encode_pods(jpods)
    jct = jenc.snapshot()
    pct = cluster_to_torch(penc.snapshot(), "cpu")
    ppb = pods_to_torch(penc.encode_pods(ppods), "cpu")
    return (jct, jpb, jcfg, jenc), (pct, ppb, pcfg, penc)


@pytest.mark.parametrize("seed,n_pending,disabled", [
    (21, 1, None), (22, 8, None), (23, 8, "PodToleratesNodeTaints"),
])
def test_schedule_batch_independent_matches_jax(seed, n_pending, disabled):
    from kubernetes_tpu_torch.codec.schema import PREDICATE_ORDER

    enabled = (None if disabled is None
               else tuple(p for p in PREDICATE_ORDER if p != disabled))
    (jct, jpb, jcfg, jenc), (pct, ppb, pcfg, penc) = _generic_inputs(
        seed, n_pending, enabled)
    key = jenc.interner.intern(UNSCHED_KEY)
    assert key == penc.interner.intern(UNSCHED_KEY)
    want = jax_independent(jct, jpb, 7, jcfg, key, jenc.getzone_key)
    got = schedule_batch_independent(pct, ppb, 7, pcfg, key, penc.getzone_key)
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert w.dtype == g.dtype and w.shape == g.shape, k
        assert np.array_equal(w, g, equal_nan=w.dtype.kind == "f"), k
    # the fleet fails predicates of many kinds
    fail = got["failure"].numpy()[np.asarray(jpb.valid)][:, np.asarray(
        jct.valid)]
    assert len(set(fail.ravel().tolist())) >= 4


# ------------------------------------------------------- both servers


def _post(addr, path, obj):
    req = urllib.request.Request(
        f"http://{addr[0]}:{addr[1]}{path}",
        data=obj if isinstance(obj, bytes) else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(addr, path):
    try:
        with urllib.request.urlopen(
                f"http://{addr[0]}:{addr[1]}{path}", timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wire_pod(name, cpu=None, labels=None, priority=None):
    spec = {"containers": [{"name": "c", "resources": {"requests": {
        "cpu": cpu}} if cpu else {}}]}
    if priority is not None:
        spec["priority"] = priority
    return {"metadata": {"name": name, "namespace": "default",
                         "labels": labels or {}}, "spec": spec}


def _small_traffic():
    """tests/test_extender.py's fleet and its requests."""
    sync = [("/sync/node", n) for n in (
        {"metadata": {"name": "n1", "labels": {}},
         "status": {"allocatable": {"cpu": "1", "memory": "4Gi",
                                    "pods": 10}}},
        {"metadata": {"name": "n2", "labels": {}},
         "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                    "pods": 10}}},
        {"metadata": {"name": "tainted", "labels": {}},
         "spec": {"taints": [{"key": "dedicated", "value": "x",
                              "effect": "NoSchedule"}]},
         "status": {"allocatable": {"cpu": "4", "memory": "8Gi",
                                    "pods": 10}}})]
    sync.append(("/sync/pod", {
        "metadata": {"name": "existing", "namespace": "default"},
        "spec": {"nodeName": "n1", "containers": [
            {"name": "c", "resources": {"requests": {"cpu": "800m"}}}]}}))
    names = ["n1", "n2", "tainted", "ghost"]
    req = [
        ("/filter", {"pod": _wire_pod("p", "500m"), "nodenames": names}),
        ("/filter", {"Pod": _wire_pod("p", "500m"), "NodeNames": ["n2"]}),
        ("/filter", {"pod": _wire_pod("p", "500m"), "nodes": {"items": [
            {"metadata": {"name": "n2"}}, {"metadata": {"name": "n1"}}]}}),
        ("/filter", {"pod": _wire_pod("q", "100m")}),
        ("/prioritize", {"pod": _wire_pod("p", "100m"),
                         "nodenames": names}),
        ("/prioritize", {"pod": _wire_pod("p", "100m"), "nodes": {
            "items": [{"metadata": {"name": "n2"}}]}}),
        ("/preempt", {"pod": _wire_pod("boss", "900m", priority=100)}),
        ("/preempt", {"pod": _wire_pod("small", "100m", priority=100)}),
        ("/bind", {"PodName": "ghost", "PodNamespace": "default",
                   "PodUID": "u0", "Node": "n2"}),
        ("/filter", {"pod": _wire_pod("bound-pod", "100m"),
                     "nodenames": ["n1", "n2"]}),
        ("/bind", {"PodName": "bound-pod", "PodNamespace": "default",
                   "PodUID": "u1", "Node": "n2"}),
        ("/bind", {"PodName": "bound-pod", "PodNamespace": "default",
                   "PodUID": "u1", "Node": "n2"}),
        ("/filter", {"pod": _wire_pod("p", "3500m"), "nodenames": names}),
        ("/sync/pod/remove", {"namespace": "default", "name": "existing"}),
        ("/filter", {"pod": _wire_pod("p", "500m"), "nodenames": names}),
        ("/sync/node/remove", {"name": "tainted"}),
        ("/prioritize", {"pod": _wire_pod("p", "100m"),
                         "nodenames": names}),
        # error replies
        ("/filter", {"nodenames": names}),
        ("/prioritize", {}),
        ("/preempt", {}),
        ("/filter", b"{not json"),
        ("/nowhere", {}),
        ("/sync/node/remove", {}),
        ("/bind", {"PodName": "never-seen"}),
    ]
    return sync, req


def _seeded_traffic(seed=5):
    """A seeded 64-node fleet of tests/fixtures.py (taints, selectors, host
    ports, volumes, (anti-)affinity) with 96 running pods and 8 spread
    selectors; 12 pending pods through filter, prioritize, preempt and
    bind."""
    rng = np.random.default_rng(seed)
    nodes, existing, services = fixtures.random_cluster(
        rng, n_nodes=64, n_pods=96, with_affinity=True)
    pending = [fixtures.random_pending_pod(rng, i, True) for i in range(12)]
    sync = [("/sync/node", node_to_dict(n)) for n in nodes]
    sync += [("/sync/service", {"namespace": ns, "selector": sel})
             for ns, sel in services]
    sync += [("/sync/pod", pod_to_dict(p)) for p in existing]
    names = [n.name for n in nodes]
    req = []
    for i, p in enumerate(pending):
        wire = pod_to_dict(p)
        req.append(("/filter", {"pod": wire, "nodenames": names}))
        req.append(("/prioritize", {"pod": wire, "nodenames": names[::2]}))
        if i % 3 == 0:
            wire = dict(wire, spec=dict(wire["spec"], priority=1000))
            req.append(("/preempt", {"pod": wire}))
        req.append(("/bind", {"PodName": p.name, "PodNamespace": p.namespace,
                              "PodUID": "", "Node": names[i * 5]}))
    return sync, req


def _replay(server, sync, req):
    server.start()
    try:
        addr = server.address
        out = [_post(addr, path, body) for path, body in sync + req]
        out.append(_get(addr, "/healthz"))
        out.append(_get(addr, "/nowhere")[0])
        assert b"scheduler_" in _get(addr, "/metrics")[1]
        return out
    finally:
        server.stop()


@pytest.mark.parametrize("traffic", ["test_extender-fleet", "seeded-64"])
def test_servers_reply_alike(traffic):
    sync, req = (_small_traffic() if traffic == "test_extender-fleet"
                 else _seeded_traffic())
    want = _replay(JaxServer(), sync, req)
    got = _replay(ExtenderServer(device="cpu"), sync, req)
    for i, (w, g) in enumerate(zip(want, got)):
        if isinstance(w, tuple) and isinstance(w[1], (dict, list)):
            assert w[0] == g[0], (i, w, g)
            assert (json.dumps(w[1], sort_keys=True)
                    == json.dumps(g[1], sort_keys=True)), (i, w, g)
        else:
            assert w == g, (i, w, g)
    assert len(want) == len(got)
    codes = {w[0] for w in want if isinstance(w, tuple)}
    assert codes == ({200, 400, 404, 500} if traffic == "test_extender-fleet"
                     else {200})


def test_server_keeps_the_snapshot_resident():
    """Requests after the first scatter only the rows the mirror changed
    (a bind dirties its node's row), never the whole snapshot."""
    srv = ExtenderServer(device="cpu")
    sync, _ = _seeded_traffic()
    srv.start()
    try:
        addr = srv.address
        for path, body in sync:
            _post(addr, path, body)
        pod = _wire_pod("r0", "100m")
        names = list(srv.cache.encoder.node_rows)
        _post(addr, "/filter", {"pod": pod, "nodenames": names})
        assert srv._dev_snapshot.scatter_rows == []
        _post(addr, "/bind", {"PodName": "r0", "PodNamespace": "default",
                              "PodUID": "", "Node": names[3]})
        _post(addr, "/filter", {"pod": _wire_pod("r1", "100m"),
                                "nodenames": names})
        assert srv._dev_snapshot.scatter_rows == [1]
        assert srv.filter_requests == 2
        assert all(v >= 0 for v in srv.filter_seconds.values())
    finally:
        srv.stop()


def test_packed_upload_equals_field_by_field():
    """The one-copy upload (codec/transfer.py _dc_to, upload_batch) gives
    every field of a PodBatch and a BatchPortState, and the extender's
    mask and score, the dtype, shape and bytes of its own array."""
    from kubernetes_tpu_torch.codec.schema import PodBatch
    from kubernetes_tpu_torch.codec.transfer import _dc_to, upload_batch
    from kubernetes_tpu_torch.models.batched import encode_batch_ports

    _, penc, _, ppods = twin_world(31, n_pending=3)
    batch = penc.encode_pods(ppods)
    ports = encode_batch_ports(penc, ppods)
    got = _dc_to(batch, PodBatch, "cpu")
    pods_t, ports_t, emask, escore = upload_batch(
        batch, ports, "cpu", np.arange(6).reshape(3, 2) % 2,
        np.linspace(0, 1, 6).reshape(3, 2))
    for obj, dev in ((batch, got), (batch, pods_t), (ports, ports_t)):
        for f in type(obj).__dataclass_fields__:
            w = np.asarray(getattr(obj, f))
            g = getattr(dev, f)
            assert g.dtype == torch.from_numpy(w).dtype, f
            assert tuple(g.shape) == w.shape, f
            assert g.numpy().tobytes() == w.tobytes(), f   # NaN too
    assert emask.dtype == torch.bool and emask.tolist() == [
        [False, True]] * 3
    assert escore.dtype == torch.float32
    assert escore.numpy().tobytes() == np.linspace(
        0, 1, 6, dtype=np.float32).reshape(3, 2).tobytes()


def test_cuda_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ExtenderServer()


def test_drive_extender_against_both_servers():
    jm, jp = jax_extender(64, 48, 40, 4)
    # the port's sidecar holds its connections, so its sync is pipelined
    # (the JAX sidecar, HTTP/1.0, gets one request a connection)
    pm, pp = jax_extender(64, 48, 40, 4,
                          server=lambda: ExtenderServer(device="cpu"))
    assert pm["digests"] == jm["digests"]
    assert pm["bound"] == jm["bound"] and all(pm["bound"])
    assert pp["digests"] == jp["digests"]
    assert pp["preempt_replies"] == jp["preempt_replies"]
    # three usable batch nodes (every 20th, node 0 tainted): each reply's
    # victims are deleted, and the freed node needs no preemption again
    assert [bool(r["nodeNameToMetaVictims"])
            for r in pp["preempt_replies"]] == [True, True, True, False]
    assert {len(v) for v in pm["latency"].values() if v} == {48}


# ------------------------------------------------- the Scheduler's chain


class FakeTransport:
    """Records calls; serves canned per-verb responses (or raises)."""

    def __init__(self, responses):
        self.responses = responses
        self.calls = []

    def __call__(self, url, payload, timeout):
        verb = url.rsplit("/", 1)[1]
        self.calls.append((verb, json.loads(json.dumps(payload))))
        r = self.responses[verb]
        if isinstance(r, Exception):
            raise r
        if callable(r):
            return r(payload)
        return r


JAX = SimpleNamespace(
    Scheduler=lambda **kw: JaxScheduler(**kw), SchedulerConfig=JaxConfig,
    SchedulerCache=JaxCache, PriorityQueue=JaxQueue,
    make_node=fixtures.make_node, make_pod=fixtures.make_pod,
    client=jclient, policy=jax_policy)
PORT = SimpleNamespace(
    Scheduler=lambda **kw: Scheduler(device="cpu", **kw),
    SchedulerConfig=SchedulerConfig, SchedulerCache=SchedulerCache,
    PriorityQueue=PriorityQueue, make_node=port_factory.make_node,
    make_pod=port_factory.make_pod, client=pclient, policy=port_policy)


def _ext(pkg, responses, **cfg):
    """(extender, transport) of `pkg` with canned responses; an Exception
    response of the JAX package's ExtenderError class is rebuilt in the
    package's own."""
    resp = {k: (pkg.client.ExtenderError(str(v))
                if isinstance(v, jclient.ExtenderError) else v)
            for k, v in responses.items()}
    t = FakeTransport(resp)
    url = cfg.pop("url_prefix", "http://ext")
    return pkg.client.HTTPExtender(
        pkg.client.ExtenderConfig(url_prefix=url, **cfg), transport=t), t


def _config(pkg, **kw):
    """loop.live_config(8, pipeline=False, ...)'s settings in `pkg`'s
    SchedulerConfig class (the JAX package's takes the same fields)."""
    cfg = loop.live_config(8, pipeline=False, **kw)
    return pkg.SchedulerConfig(**{k: getattr(cfg, k) for k in (
        "batch_size", "batch_window_s", "engine", "disable_preemption",
        "batched_commit", "pipeline_commit", "cpu_fallback", "telemetry",
        "telemetry_interval_cycles", "quality_top_k",
        "quality_interval_cycles", "timeline", "megacycle_batches")})


def _world(pkg, extenders=None, nodes=3, preemption=False, profile=None,
           batched=True):
    cache = pkg.SchedulerCache()
    for i in range(nodes):
        cache.add_node(pkg.make_node(f"n{i}", cpu="4", mem="8Gi"))
    bound, deleted = [], []
    cfg = _config(pkg, preemption=preemption, batched=batched)
    cfg.profile = profile
    s = pkg.Scheduler(cache=cache, queue=pkg.PriorityQueue(),
                      binder=lambda p, n: bound.append((p.name, n)) or True,
                      config=cfg, extenders=extenders)
    s.victim_deleter = lambda v: (deleted.append(v.name),
                                  cache.remove_pod(v))
    return s, bound, deleted


def _outcome(s, bound, deleted, transports):
    return {
        "bound": list(bound),
        "results": [(r.pod.name, r.node) for r in s.results],
        "queued": len(s.queue),
        "preemptions": [(p[0], p[1], list(p[2])) for p in s.preemptions],
        "deleted": list(deleted),
        "calls": [[(v, sorted(p.get("nodenames") or [])
                    + sorted(i["metadata"]["name"] for i in
                             (p.get("nodes") or {}).get("items", [])))
                   for v, p in t.calls] for t in transports],
    }


def _filter_only(ok):
    return {"filter": {"nodenames": ok, "failedNodes": {}, "error": ""}}


def _echo_victims(payload):
    return {"nodeNameToMetaVictims": payload["nodeNameToMetaVictims"]}


# (name, [extender specs: (responses, config)], pods [(name, requests)],
# preemption world)
CHAIN_CASES = [
    ("filter-veto", [(_filter_only(["n1"]), dict(
        filter_verb="filter", node_cache_capable=True))],
     [("p0", {"cpu": "100m"}), ("p1", {"cpu": "100m"})], False),
    ("prioritize-weight", [({"prioritize": [
        {"host": "n0", "score": 0}, {"host": "n1", "score": 1},
        {"host": "n2", "score": 5}]}, dict(
            prioritize_verb="prioritize", weight=10,
            node_cache_capable=True))],
     [("p0", {"cpu": "100m"})], False),
    ("error-requeued-no-preemption", [({"filter": jclient.ExtenderError(
        "boom")}, dict(filter_verb="filter", node_cache_capable=True))],
     [("p0", {"cpu": "100m"})], True),
    ("ignorable-error-skipped", [({"filter": jclient.ExtenderError(
        "down")}, dict(filter_verb="filter", node_cache_capable=True,
                       ignorable=True))],
     [("p0", {"cpu": "100m"})], False),
    ("managed-resources", [(_filter_only([]), dict(
        filter_verb="filter", node_cache_capable=True,
        managed_resources=("example.com/gpu",)))],
     [("plain", {"cpu": "100m"}), ("gpu", {"example.com/gpu": "1"})],
     False),
    ("chaining", [(_filter_only(["n0", "n1"]), dict(
        filter_verb="filter", node_cache_capable=True)),
        (_filter_only(["n1"]), dict(filter_verb="filter",
                                    node_cache_capable=True,
                                    url_prefix="http://ext2"))],
     [("p0", {"cpu": "100m"})], False),
    ("cache-incapable", [({"filter": {"nodes": {"items": [
        {"metadata": {"name": "n0"}}]}, "failedNodes": {}, "error": ""}},
        dict(filter_verb="filter", node_cache_capable=False))],
     [("p0", {"cpu": "100m"})], False),
    ("bind-verb", [({"filter": {"nodenames": ["n0", "n1", "n2"],
                                "failedNodes": {}, "error": ""},
                     "bind": {"error": ""}}, dict(
        filter_verb="filter", bind_verb="bind", node_cache_capable=True))],
     [("p0", {"cpu": "100m"})], False),
    ("preempt-veto", [({"preempt": {"nodeNameToMetaVictims": {}}}, dict(
        preempt_verb="preempt", node_cache_capable=True))], None, True),
    ("preempt-passthrough", [({"preempt": _echo_victims}, dict(
        preempt_verb="preempt", node_cache_capable=True))], None, True),
    ("preempt-error-ignorable", [({"preempt": jclient.ExtenderError(
        "x")}, dict(preempt_verb="preempt", ignorable=True))], None, True),
]


def _run_chain(pkg, specs, pods, preemption, batched=True):
    exts, ts = [], []
    for responses, cfg in specs:
        e, t = _ext(pkg, responses, **dict(cfg))
        exts.append(e)
        ts.append(t)
    if pods is None:
        # one node where `hi` must evict `low`
        cache = pkg.SchedulerCache()
        cache.add_node(pkg.make_node("solo", cpu="2", mem="4Gi"))
        deleted = []
        cfg = _config(pkg, preemption=True)
        s = pkg.Scheduler(cache=cache, queue=pkg.PriorityQueue(),
                          binder=lambda p, n: True, config=cfg)
        s.victim_deleter = lambda v: (deleted.append(v.name),
                                      cache.remove_pod(v))
        s.queue.add(pkg.make_pod("low", cpu="1500m", mem="1Gi"))
        s.run_once(timeout=0.0)
        s.extenders = exts
        hi = pkg.make_pod("hi", cpu="1500m", mem="1Gi", priority=100)
        s.queue.add(hi)
        s.run_once(timeout=0.0)
        out = _outcome(s, [], deleted, ts)
        out["nominated"] = hi.status.nominated_node_name
        return out
    s, bound, deleted = _world(pkg, exts, preemption=preemption,
                               batched=batched)
    for name, req in pods:
        s.queue.add(pkg.make_pod(name, requests=req))
        s.run_once(timeout=0.0)
    return _outcome(s, bound, deleted, ts)


@pytest.mark.parametrize("case", [c[0] for c in CHAIN_CASES])
def test_scheduler_extender_chain_matches_jax(case):
    _, specs, pods, preemption = next(c for c in CHAIN_CASES if c[0] == case)
    with process_state_kept():
        want = _run_chain(JAX, specs, pods, preemption)
        got = _run_chain(PORT, specs, pods, preemption)
    assert got == want
    if case == "error-requeued-no-preemption":
        assert got["results"] == [("p0", None)] and got["queued"] == 1
        assert got["preemptions"] == []
    if case == "preempt-passthrough":
        assert got["deleted"] == ["low"] and got["nominated"] == "solo"
    if case == "preempt-veto":
        assert got["deleted"] == [] and not got["nominated"]


@pytest.mark.parametrize("case", ["filter-veto",
                                  "error-requeued-no-preemption",
                                  "ignorable-error-skipped"])
def test_per_pod_commit_tail_matches_jax(case):
    """The same chains through the per-pod commit tail
    (batched_commit=False)."""
    _, specs, pods, preemption = next(c for c in CHAIN_CASES if c[0] == case)
    with process_state_kept():
        want = _run_chain(JAX, specs, pods, preemption, batched=False)
        got = _run_chain(PORT, specs, pods, preemption, batched=False)
    assert got == want


class _StubHandler(BaseHTTPRequestHandler):
    """An extender that approves only the second of the node names it is
    sent, in sorted order."""

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        out = {"nodenames": [sorted(body["nodenames"])[1]],
               "failedNodes": {}, "error": ""}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


def test_policy_extenders_built_through_the_config_copy():
    srv = HTTPServer(("127.0.0.1", 0), _StubHandler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    policy = {"kind": "Policy", "extenders": [{
        "urlPrefix": f"http://127.0.0.1:{srv.server_port}",
        "filterVerb": "filter", "nodeCacheCapable": True, "weight": 2,
        "httpTimeout": 5_000_000_000}]}
    try:
        out = []
        with process_state_kept():
            for pkg in (JAX, PORT):
                s, bound, _ = _world(pkg, profile=pkg.policy(policy))
                assert [e.config.weight for e in s.extenders] == [2]
                for i in range(3):
                    s.queue.add(pkg.make_pod(f"p{i}", cpu="100m"))
                s.run_once(timeout=0.0)
                out.append(bound)
    finally:
        srv.shutdown()
    assert out[1] == out[0] == [("p0", "n1"), ("p1", "n1"), ("p2", "n1")]


def test_profile_extender_configs_no_longer_refused():
    from kubernetes_tpu_torch.runtime.scheduler import refused_settings

    prof = port_policy({"kind": "Policy", "extenders": [
        {"urlPrefix": "http://x", "filterVerb": "f", "preemptVerb": "p"}]})
    cfg = loop.live_config(8)
    cfg.profile = prof
    assert refused_settings(cfg) == []
    s = Scheduler(config=cfg, device="cpu")
    assert [e.name for e in s.extenders] == ["http://x"]
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        Scheduler(config=loop.live_config(8), framework=object(),
                  device="cpu")


def test_live_extender_port_to_port_matches_jax_pair():
    """A real HTTP round trip: the port's Scheduler with an HTTPExtender
    (filter, prioritize, bind) pointed at the port's ExtenderServer, against
    the JAX pair; bindings and their order equal."""
    with process_state_kept():
        hosts, order, _, _, _ = jax_live(64, 48, 16, pipeline=False,
                                         extender=True)
        nodes = loop.bench_nodes(64)
        with loop.extender_sidecar(nodes, device="cpu") as srv:
            got = loop.run_live(nodes, 48, 16, device="cpu", pipeline=False,
                                sidecar=srv)
    np.testing.assert_array_equal(got["hosts"], hosts)
    np.testing.assert_array_equal(got["bind_order"], order)
    assert (got["hosts"] >= 0).all()
    assert got["extender_seconds"] > 0 and got["filter_requests"] == 48
    assert srv.seen_trace_ids


# ------------------------------------------------ the port's HTTPExtender


class FlakyTransport:
    """Fails the first `n_failures` calls with a connection-level error,
    then serves canned responses."""

    def __init__(self, responses, n_failures, exc=ConnectionRefusedError):
        self.responses = responses
        self.n_failures = n_failures
        self.exc = exc
        self.calls = 0

    def __call__(self, url, payload, timeout):
        self.calls += 1
        if self.calls <= self.n_failures:
            raise self.exc("connection refused")
        return self.responses[url.rsplit("/", 1)[1]]


def _pext(t, **cfg):
    return pclient.HTTPExtender(pclient.ExtenderConfig(**cfg), transport=t)


def _ppod():
    return port_factory.make_pod("p", cpu="100m")


def test_port_client_retries_within_budget():
    t = FlakyTransport({"filter": {"nodenames": ["a", "b"],
                                   "failedNodes": {}, "error": ""}}, 2)
    ext = _pext(t, url_prefix="http://flaky", filter_verb="filter",
                node_cache_capable=True, http_timeout=2.0, max_retries=3,
                retry_backoff_s=0.001)
    assert ext.filter(_ppod(), ["a", "b", "c"]) == (["a", "b"], {})
    assert t.calls == 3


def test_port_client_budget_exhausted_and_capped():
    import time

    t = FlakyTransport({}, 99)
    ext = _pext(t, url_prefix="http://dead", filter_verb="filter",
                node_cache_capable=True, http_timeout=0.2, max_retries=2,
                retry_backoff_s=0.001)
    t0 = time.monotonic()
    with pytest.raises(pclient.ExtenderError, match="attempts"):
        ext.filter(_ppod(), ["a"])
    assert time.monotonic() - t0 < 1.0 and t.calls == 3
    t = FlakyTransport({}, 99)
    ext = _pext(t, url_prefix="http://dead2", filter_verb="filter",
                node_cache_capable=True, http_timeout=0.005,
                max_retries=10, retry_backoff_s=0.5)
    with pytest.raises(pclient.ExtenderError):
        ext.filter(_ppod(), ["a"])
    assert t.calls == 1


def test_port_client_no_retry_for_app_errors_http_status_and_bind():
    import io

    t = FakeTransport({"filter": {"error": "policy says no"}})
    ext = _pext(t, url_prefix="http://app", filter_verb="filter",
                node_cache_capable=True, max_retries=5,
                retry_backoff_s=0.001)
    with pytest.raises(pclient.ExtenderError):
        ext.filter(_ppod(), ["a"])
    assert len(t.calls) == 1
    calls = []

    def status_500(url, payload, timeout):
        calls.append(url)
        raise urllib.error.HTTPError(url, 500, "boom", hdrs=None,
                                     fp=io.BytesIO(b""))

    ext = _pext(status_500, url_prefix="http://err", filter_verb="filter",
                max_retries=5, retry_backoff_s=0.001)
    with pytest.raises(pclient.ExtenderError):
        ext.filter(_ppod(), ["a"])
    assert len(calls) == 1
    t = FlakyTransport({"bind": {}}, 1, exc=TimeoutError)
    ext = _pext(t, url_prefix="http://bindy", bind_verb="bind",
                http_timeout=1.0, max_retries=5, retry_backoff_s=0.001)
    with pytest.raises(pclient.ExtenderError):
        ext.bind("default", "p0", "uid0", "n0")
    assert t.calls == 1


def test_port_client_429_retries_after_the_servers_pause():
    import io

    calls = []

    def shed_once(url, payload, timeout):
        calls.append(url)
        if len(calls) == 1:
            raise urllib.error.HTTPError(url, 429, "shed",
                                         hdrs={"Retry-After": "0.01"},
                                         fp=io.BytesIO(b""))
        return {"nodenames": ["a"], "failedNodes": {}, "error": ""}

    ext = _pext(shed_once, url_prefix="http://busy", filter_verb="filter",
                node_cache_capable=True, http_timeout=2.0, max_retries=2,
                retry_backoff_s=0.001)
    assert ext.filter(_ppod(), ["a", "b"]) == (["a"], {})
    assert len(calls) == 2
    assert pclient.parse_retry_after({"Retry-After": "x"}) == 0.0


def test_ignorable_flaky_extender_skipped_after_bounded_retries():
    t = FlakyTransport({}, 99)
    ext = _pext(t, url_prefix="http://down", filter_verb="filter",
                node_cache_capable=True, ignorable=True, http_timeout=0.1,
                max_retries=1, retry_backoff_s=0.001)
    with process_state_kept():
        s, bound, _ = _world(PORT, [ext])
        res = s.schedule_cycle([port_factory.make_pod("p0", cpu="100m")])
    assert res[0].node is not None and t.calls == 2


# ------------------------------------------------------------- goldens


def test_extender_golden_file():
    """What chip_smoke.py phase 18 reads: 512 pods' filter, prioritize and
    bind digests, their bound nodes, 16 /preempt replies with victims."""
    path = golden_path("extender")
    data = np.load(path)
    assert int(data["nodes"]) == 5000 and int(data["existing"]) == 1000
    assert int(data["pods"]) == 512
    assert data["bound"].shape == (512,) and (data["bound"] >= 0).all()
    for verb in ("filter", "prioritize", "bind"):
        assert data[verb].shape == (512, 32) and data[verb].dtype == np.uint8
    assert data["preempt"].shape == (16, 32)
    replies = [json.loads(r) for r in data["preempt_replies"]]
    assert len(replies) == 16
    assert all(len(r["nodeNameToMetaVictims"]) == 1 for r in replies)
    assert os.path.getsize(path) < 200 << 10


def test_live_extender_golden_file():
    """What chip_smoke.py phase 19 reads: 1,024 timed pods in batches of
    256 after a 64-pod warmup batch, every one bound once, in a recorded
    order."""
    path = golden_path("live_extender")
    data = np.load(path)
    assert int(data["nodes"]) == 5000 and int(data["pods"]) == 1024
    assert int(data["batch"]) == 256 and int(data["warmup"]) == 64
    hosts, order = data["hosts"], data["bind_order"]
    assert hosts.shape == (1088,) and (hosts >= 0).all()
    assert sorted(order.tolist()) == list(range(1088))
    assert os.path.getsize(path) < 200 << 10


# ------------------------------------------------------------- the binary


def test_binary_flags_and_config(tmp_path):
    from kubernetes_tpu_torch.cmd import extender as cmd

    args = cmd.build_parser().parse_args([])
    assert args.device == "cuda" and args.port == 10250
    conf = tmp_path / "sched.json"
    conf.write_text(json.dumps({"algorithmSource": {"policy": {
        "kind": "Policy",
        "predicates": [{"name": "PodFitsResources"},
                       {"name": "PodToleratesNodeTaints"}],
        "priorities": [{"name": "LeastRequestedPriority", "weight": 1}]}}}))
    args = cmd.build_parser().parse_args(
        ["--device", "cpu", "--config", str(conf), "--host", "127.0.0.1",
         "--port", "0"])
    srv = cmd.build_server(args)
    try:
        assert srv.device.type == "cpu"
        want = cmd.load_component_config(str(conf)).build_profile()
        assert srv.cfg.enabled == want.filter_config.enabled
        assert {"PodFitsResources", "PodToleratesNodeTaints"} <= set(
            srv.cfg.enabled)
        assert "MatchInterPodAffinity" not in srv.cfg.enabled
    finally:
        srv._httpd.server_close()
