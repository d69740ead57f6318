"""HTTP scheduler-extender sidecar: the out-of-process seam (PyTorch port).

The counterpart of the JAX package's extender/server.py, with the same
routes and the same reply bodies.  It implements the reference's extender
protocol (pkg/scheduler/core/extender.go; wire types
pkg/scheduler/api/v1/types.go; config api/types.go:203-233) so a STOCK Go
kube-scheduler can offload Filter/Prioritize/Preempt/Bind to the card with
`NodeCacheCapable: true`:

  POST <filterVerb>      ExtenderArgs{Pod, NodeNames}   -> ExtenderFilterResult
  POST <prioritizeVerb>  ExtenderArgs{Pod, NodeNames}   -> HostPriorityList
  POST <preemptVerb>     ExtenderPreemptionArgs          -> ExtenderPreemptionResult
  POST <bindVerb>        ExtenderBindingArgs             -> ExtenderBindingResult

NodeCacheCapable=true means the scheduler sends only node *names* and the
extender mirrors cluster state itself (api/types.go:226-229).  The mirror
is fed by the sync endpoints (the watch-ingest seam):

  POST /sync/node        add/update one Node (JSON)
  POST /sync/node/remove {"name": ...}
  POST /sync/pod         add one (assigned) Pod
  POST /sync/pod/remove  {"namespace": ..., "name": ...}
  POST /sync/service     {"namespace": ..., "selector": {...}}
  GET  /healthz, /metrics (Prometheus text)

Each filter and prioritize request runs models/generic.py
schedule_batch_independent for its one pod on the server's device (the
predicate fold by kernel K7, the selection by K1 on the card); a preempt
request runs the candidate evaluation and the pick of models/preemption.py
(kernel K2).  The snapshot stays resident on the device between requests:
each verb scatters only the rows the mirror changed since the last one
(codec/transfer.py DeviceSnapshotCache), as the live Scheduler does.

Scoring contract: extender Prioritize returns 0..10 per node (weighted by the
extender's configured weight on the scheduler side, extender.go:318-358); we
return the total score rescaled to 0..10, on the host in f32 scalar
arithmetic over the fetched f32 scores, as the reference computes it.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.codec.schema import (
    PREDICATE_ORDER,
    FilterConfig,
    PodBatch,
)
from kubernetes_tpu_torch.codec.transfer import (
    DeviceSnapshotCache,
    _dc_to,
    host_fetch,
)
from kubernetes_tpu_torch.models.generic import schedule_batch_independent
from kubernetes_tpu_torch.models.preemption import (
    make_preempt_eval,
    pick_preemption_node,
    sorted_victim_slots,
)
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
from kubernetes_tpu_torch.utils import metrics as m
from kubernetes_tpu_torch.utils.trace import trace_id_of

_TEN = np.float32(10.0)
# a node's failure reason by its first failing predicate (the last entry:
# none failed, so the node or the pod is not valid)
_REASONS = tuple(PREDICATE_ORDER) + ("Unschedulable",)
# the parts of a /filter request, in seconds, summed over requests
FILTER_PARTS = ("json", "encode", "launch_fetch", "row_to_name")


class ExtenderServer:
    """Threaded HTTP server around a SchedulerCache + the device pipeline.

    device: where the pipeline runs ("cuda" unless the caller passes
    "cpu"); a CUDA server builds the kernel library when it is constructed,
    so a build error raises here, and a CUDA device on a machine without
    one raises."""

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        filter_config: Optional[FilterConfig] = None,
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ExtenderServer(device='cuda') needs a CUDA device; pass "
                    "device='cpu' to run on the host")
            from kubernetes_tpu_torch.kernels._build import library

            library()
        self.cache = cache or SchedulerCache()
        self.cfg = filter_config or FilterConfig()
        enc = self.cache.encoder
        self.cfg = enc.adopt_filter_config(self.cfg)
        self._unsched = enc.interner.intern("node.kubernetes.io/unschedulable")
        self._preempt_eval = make_preempt_eval(self.cfg, self._unsched)
        # the mirror's snapshot, resident on the device between requests
        self._dev_snapshot = DeviceSnapshotCache(self.device)
        # pods seen via /filter, so a later /bind can assume them with their
        # real resource requests; evicted on bind and on /sync pod events,
        # FIFO-capped so never-bound pods cannot leak for the server's life
        self._pending: "OrderedDict[tuple, Pod]" = OrderedDict()
        self._pending_cap = 10000
        # trace ids seen on incoming verb requests (the scheduler's
        # cycle traceparent, utils/trace.py): the extender half of the
        # end-to-end join — bounded, newest last
        self.seen_trace_ids: "deque[str]" = deque(maxlen=256)
        # seconds of the /filter requests by part (FILTER_PARTS): JSON
        # decode + encode of the bodies, the pod encode and snapshot,
        # the device pipeline and its fetch, the row -> name decode
        self.filter_seconds = dict.fromkeys(FILTER_PARTS, 0.0)
        self.filter_requests = 0
        # the handler threads add their JSON seconds outside the cache
        # lock (a reply need not wait out another request's compute)
        self._stats_lock = threading.Lock()
        self._httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle

    @property
    def address(self):
        return self._httpd.server_address

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------ pipeline

    @staticmethod
    def _arg(args: dict, *names):
        """Wire tolerance: the v1 wire format is lowercase ("pod",
        "nodenames" — api/v1/types.go:241-247 json tags) but accept the Go
        field spelling too."""
        for n in names:
            if n in args and args[n] is not None:
                return args[n]
        return None

    def _requested_nodes(self, args: dict, enc):
        names = self._arg(args, "nodenames", "NodeNames")
        if names is None:
            # non-NodeCacheCapable mode: full NodeList objects
            nl = self._arg(args, "nodes", "Nodes") or {}
            items = nl.get("items") if isinstance(nl, dict) else None
            if items:
                names = [n.get("metadata", {}).get("name", "") for n in items]
        return names if names is not None else list(enc.node_rows)

    def _device_inputs(self, pod: Pod):
        """(resident snapshot, one-pod batch) on the device, under the cache
        lock: the pod is encoded BEFORE the snapshot (its terms register
        topology keys with node-pair backfill that the snapshot must
        include), and only the rows changed since the last request
        scatter into the resident snapshot."""
        enc = self.cache.encoder
        batch = enc.encode_pods([pod])
        cluster, _ = self.cache.snapshot()
        dev_cluster = self._dev_snapshot.update(
            cluster, dirty_rows=enc.take_dirty_rows())
        return dev_cluster, _dc_to(batch, PodBatch, self.device, "extender")

    def _schedule_one(self, pod: Pod):
        cluster, batch = self._device_inputs(pod)
        return schedule_batch_independent(
            cluster, batch, 0, self.cfg, self._unsched,
            self.cache.encoder.getzone_key, need_per_prio=False)

    def filter(self, args: dict) -> dict:
        pod_d = self._arg(args, "pod", "Pod")
        if pod_d is None:
            return {"nodenames": [], "failedNodes": {}, "error": "missing pod"}
        pod = Pod.from_dict(pod_d)
        enc = self.cache.encoder
        # hold the cache lock across compute AND row->name decode: a
        # concurrent /sync could recycle rows between the two (_pending is
        # guarded by the same lock against concurrent handler threads)
        with self.cache._lock:
            t0 = time.perf_counter()
            self._pending.pop((pod.namespace, pod.name), None)
            self._pending[(pod.namespace, pod.name)] = pod
            while len(self._pending) > self._pending_cap:
                self._pending.popitem(last=False)
            cluster, batch = self._device_inputs(pod)
            t1 = time.perf_counter()
            out = schedule_batch_independent(
                cluster, batch, 0, self.cfg, self._unsched, enc.getzone_key,
                need_per_prio=False,
            )
            mask = host_fetch(out["mask"][0], tag="extender")
            failure = host_fetch(out["failure"][0], tag="extender")
            t2 = time.perf_counter()
            requested = self._requested_nodes(args, enc)
            rows = self._rows(requested)
            fits = (mask[np.maximum(rows, 0)] & (rows >= 0)).tolist()
            ok = list(itertools.compress(requested, fits))
            # in request order, as the names came: only the nodes that
            # failed (a name the mirror lacks, or its first failing
            # predicate) are walked one by one
            failed = {}
            for i in itertools.compress(range(len(fits)),
                                        (not f for f in fits)):
                row = int(rows[i])
                failed[requested[i]] = (
                    "node not in extender cache" if row < 0
                    else _REASONS[failure[row]])
            t3 = time.perf_counter()
        self._count_filter(encode=t1 - t0, launch_fetch=t2 - t1,
                           row_to_name=t3 - t2)
        return {"nodenames": ok, "failedNodes": failed, "error": ""}

    def _count_filter(self, **parts) -> None:
        """Add seconds to filter_seconds by part; with encode (the part
        every computed /filter has), count the request."""
        with self._stats_lock:
            for k, v in parts.items():
                self.filter_seconds[k] += v
            if "encode" in parts:
                self.filter_requests += 1

    def prioritize(self, args: dict) -> list:
        pod_d = self._arg(args, "pod", "Pod")
        if pod_d is None:
            return []
        pod = Pod.from_dict(pod_d)
        enc = self.cache.encoder
        with self.cache._lock:
            scores = host_fetch(self._schedule_one(pod)["scores"][0],
                                tag="extender")
            requested = self._requested_nodes(args, enc)
            # rescale the weighted total to the extender's 0..10 contract,
            # in f32 as the reference's numpy does it, truncated toward 0
            rows = self._rows(requested)
            known = rows >= 0
            vals = scores[rows[known]]
            mx = vals.max() if vals.size else 0.0
            out = np.zeros(len(rows), np.int64)
            if mx > 0:
                out[known] = (_TEN * vals / mx).astype(np.int64)
        return [{"host": name, "score": v}
                for name, v in zip(requested, out.tolist())]

    def _rows(self, names) -> np.ndarray:
        """i64[len(names)]: each name's node row, -1 for a name the mirror
        does not hold."""
        rows = self.cache.encoder.node_rows
        return np.fromiter(map(rows.get, names, itertools.repeat(-1)),
                           np.int64, len(names))

    def preempt(self, args: dict) -> dict:
        pod_d = self._arg(args, "pod", "Pod")
        if pod_d is None:
            return {"nodeNameToMetaVictims": {}}
        pod = Pod.from_dict(pod_d)
        enc = self.cache.encoder
        with self.cache._lock:
            cluster, batch = self._device_inputs(pod)
            cands = host_fetch(self._preempt_eval(cluster, batch),
                               tag="extender")[0].copy()
            arena = enc.pods_snapshot()
            violating = np.zeros(len(arena.node), bool)  # no PDB feed over the wire
            slots = sorted_victim_slots(
                arena.priority, arena.valid, arena.node, pod.spec.priority,
                violating, arena.start,
            )
            node_row, victim_ms, _, res = pick_preemption_node(
                enc, pod, cands, arena, slots, violating, self.cfg.max_vols,
                device=self.device,
            )
            if node_row < 0:
                return {"nodeNameToMetaVictims": {}}
            node_name = enc.row_name(node_row)
            # the v1.15 scheduler (HTTPExtender.convertPodUIDToPod) matches
            # MetaPod.UID against pod.UID in its NodeInfo — emit the real uid
            victims = [
                {"uid": arena.uids[mi] or f"{arena.keys[mi][0]}/{arena.keys[mi][1]}"}
                for mi in victim_ms
            ]
        return {
            "nodeNameToMetaVictims": {
                node_name: {
                    "pods": victims,
                    "numPDBViolations": int(res.n_pdb_violations),
                }
            }
        }

    def bind(self, args: dict) -> dict:
        # assume into the mirror; the scheduler does the real API bind when
        # BindVerb is configured the extender owns binding (extender.go:360-385)
        name = self._arg(args, "PodName", "podName") or ""
        ns = self._arg(args, "PodNamespace", "podNamespace") or "default"
        node = self._arg(args, "Node", "node") or ""
        with self.cache._lock:
            rec = self.cache.encoder.pods.get((ns, name))
            if rec is not None:
                return {"Error": ""}
            # an unknown pod cannot be assumed with real resource accounting:
            # the NodeCacheCapable contract requires the extender mirror to
            # have seen it via /sync first — surface the miss instead of
            # fabricating an empty pod never charged to the node
            pending = self._pending.pop((ns, name), None)
        if pending is not None:
            self.cache.assume_pod(
                dataclasses.replace(
                    pending, spec=dataclasses.replace(pending.spec, node_name=node)
                )
            )
            return {"Error": ""}
        return {"Error": f"unknown pod {ns}/{name}: not in extender mirror"}

    # ------------------------------------------------------------- handler

    def _make_handler(self):
        outer = self

        class Handler(BaseHTTPRequestHandler):
            # keep-alive: a client that holds its connection (a sync
            # relay, the scheduler's verbs) pays no TCP handshake and no
            # handler thread per request; every reply carries its length,
            # and the reply's two writes (headers, body) leave at once
            # instead of waiting out Nagle against the client's delayed ACK
            protocol_version = "HTTP/1.1"
            disable_nagle_algorithm = True

            def log_message(self, fmt, *args):  # quiet
                pass

            def _send(self, obj, code=200, content_type="application/json"):
                t0 = time.perf_counter()
                body = (
                    obj.encode() if isinstance(obj, str) else json.dumps(obj).encode()
                )
                if self.path == "/filter" and code == 200:
                    outer._count_filter(json=time.perf_counter() - t0)
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send("ok", content_type="text/plain")
                elif self.path == "/metrics":
                    self._send(m.REGISTRY.expose(), content_type="text/plain")
                else:
                    self._send({"error": "not found"}, 404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                tid = trace_id_of(self.headers.get("Traceparent", ""))
                if tid:
                    outer.seen_trace_ids.append(tid)
                raw = self.rfile.read(n)
                t0 = time.perf_counter()
                try:
                    args = json.loads(raw or b"{}")
                except ValueError:
                    self._send({"Error": "bad json"}, 400)
                    return
                if self.path == "/filter":
                    outer._count_filter(json=time.perf_counter() - t0)
                try:
                    if self.path == "/filter":
                        self._send(outer.filter(args))
                    elif self.path == "/prioritize":
                        self._send(outer.prioritize(args))
                    elif self.path == "/preempt":
                        self._send(outer.preempt(args))
                    elif self.path == "/bind":
                        self._send(outer.bind(args))
                    elif self.path == "/sync/node":
                        outer.cache.add_node(Node.from_dict(args))
                        self._send({"ok": True})
                    elif self.path == "/sync/node/remove":
                        outer.cache.remove_node(args["name"])
                        self._send({"ok": True})
                    elif self.path == "/sync/pod":
                        p = Pod.from_dict(args)
                        with outer.cache._lock:
                            outer._pending.pop((p.namespace, p.name), None)
                        outer.cache.add_pod(p)
                        self._send({"ok": True})
                    elif self.path == "/sync/pod/remove":
                        key = (args.get("namespace", "default"), args["name"])
                        with outer.cache._lock:
                            outer._pending.pop(key, None)
                        outer.cache.remove_pod(
                            Pod.from_dict(
                                {"metadata": {"name": key[1], "namespace": key[0]}}
                            )
                        )
                        self._send({"ok": True})
                    elif self.path == "/sync/service":
                        # under the cache lock, unlike the JAX server: a
                        # concurrent /filter encodes and snapshots under it
                        with outer.cache._lock:
                            outer.cache.encoder.add_spread_selector(
                                args.get("namespace", "default"),
                                args.get("selector") or {})
                        self._send({"ok": True})
                    else:
                        self._send({"error": "not found"}, 404)
                except Exception as e:  # surface errors in the reply, not a 500 stack
                    self._send({"Error": f"{type(e).__name__}: {e}"}, 500)

        return Handler
