"""Scheduler-side HTTP extender client (PyTorch port).

The port's copy of the JAX package's extender/client.py (it imports no
device code), with its imports pointed at the port.

The analog of HTTPExtender (ref pkg/scheduler/core/extender.go:42-445): our
scheduler *calls out* to external extenders — filter round-trips narrow the
feasible set, prioritize results weight-merge into the score matrix
(generic_scheduler.go:774-804), and a bind-verb extender replaces the default
binder for pods it manages.  Config spelling mirrors ExtenderConfig
(pkg/scheduler/api/types.go:203-240: urlPrefix/filterVerb/prioritizeVerb/
bindVerb/weight/httpTimeout/nodeCacheCapable/managedResources/ignorable).

Tensor-pipeline integration: the reference chains extenders AFTER its in-tree
predicate scan per pod (generic_scheduler.go:527-554).  Here the device scan
is one launch for the whole batch, so extender verdicts are gathered host-side
FIRST and folded in as an extra feasibility mask / score addend — the same
intersection/addition semantics, reordered (extender approval is never a
union, so filtering before or after the device pass yields the same set).
"""

from __future__ import annotations

import json
import random
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod

# transport-level failures retried for IDEMPOTENT verbs only (refused,
# reset, DNS blip, timeout — URLError wraps most of these from urllib;
# OSError covers raw sockets, ConnectionError/socket.timeout are
# subclasses).  A read timeout can fire AFTER the server executed the
# request, so only verbs that tolerate a duplicate (filter/prioritize/
# preempt re-evaluate the same state) retry; bind never does.
# Application-level failures are NOT transient and surface immediately:
# an HTTP error status (HTTPError — the server spoke), an HTTP 200 with
# an "error" body, or malformed JSON.
_TRANSIENT_HTTP_ERRORS = (urllib.error.URLError, TimeoutError, OSError)


def parse_retry_after(headers) -> float:
    """The Retry-After header as seconds (0.0 when absent/unparseable).
    Only the delta-seconds form is read; HTTP-date is out of scope."""
    try:
        return max(0.0, float(headers.get("Retry-After", "")))
    except (AttributeError, TypeError, ValueError):
        return 0.0


class ExtenderError(Exception):
    """Non-ignorable extender failure: scheduling of the pod fails
    (generic_scheduler.go:533-541)."""


@dataclass(frozen=True)
class ExtenderConfig:
    """ref pkg/scheduler/api/types.go:203-240 (ExtenderConfig)."""

    url_prefix: str
    filter_verb: str = ""
    preempt_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    http_timeout: float = 30.0      # DefaultExtenderTimeout (extender.go:39)
    node_cache_capable: bool = False
    managed_resources: Tuple[str, ...] = ()
    ignorable: bool = False
    # bounded retry for TRANSIENT transport failures (no reference analog —
    # the reference fails the pod on the first round-trip error): up to
    # max_retries re-sends with jittered exponential backoff, the whole
    # attempt train capped by http_timeout as the TOTAL budget, so an
    # ignorable extender's flakiness delays a cycle by at most its
    # configured timeout before the scheduler skips it.
    max_retries: int = 2
    retry_backoff_s: float = 0.02

    @staticmethod
    def from_dict(d: dict) -> "ExtenderConfig":
        """Policy-JSON spelling (v1 Policy "extenders" entries).

        httpTimeout is a Go time.Duration, which marshals to JSON as integer
        NANOSECONDS — a real policy file says 100000000 for 100ms."""
        ns = d.get("httpTimeout")
        return ExtenderConfig(
            url_prefix=d.get("urlPrefix", ""),
            filter_verb=d.get("filterVerb", ""),
            preempt_verb=d.get("preemptVerb", ""),
            prioritize_verb=d.get("prioritizeVerb", ""),
            bind_verb=d.get("bindVerb", ""),
            weight=int(d.get("weight", 1)),
            http_timeout=float(ns) / 1e9 if ns else 30.0,
            node_cache_capable=bool(d.get("nodeCacheCapable", False)),
            managed_resources=tuple(
                r.get("name", "") for r in d.get("managedResources") or ()
            ),
            ignorable=bool(d.get("ignorable", False)),
            max_retries=int(d.get("maxRetries", 2)),
            retry_backoff_s=float(d.get("retryBackoffSeconds", 0.02)),
        )


def pod_to_dict(pod: Pod) -> dict:
    """Wire form of the fields our Pod model carries (ExtenderArgs.Pod)."""
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.metadata.uid,
            "labels": dict(pod.labels),
        },
        "spec": {
            "nodeName": pod.spec.node_name,
            "priority": pod.spec.priority,
            "containers": [_container_to_dict(c) for c in pod.spec.containers],
            "initContainers": [
                _container_to_dict(c) for c in pod.spec.init_containers
            ],
        },
    }


def _container_to_dict(c) -> dict:
    return {
        "name": c.name,
        "image": c.image,
        "resources": {
            "requests": {k: str(q) for k, q in c.requests.items()},
            "limits": {k: str(q) for k, q in c.limits.items()},
        },
        "ports": [
            {
                "hostPort": p.host_port,
                "containerPort": p.container_port,
                "protocol": p.protocol,
                "hostIP": p.host_ip,
            }
            for p in c.ports
        ],
    }


class HTTPExtender:
    """One configured extender endpoint.

    `transport` (tests): callable (url, payload_dict, timeout) -> response
    dict, replacing the urllib POST.
    """

    def __init__(
        self,
        config: ExtenderConfig,
        transport: Optional[Callable[[str, dict, float], dict]] = None,
    ):
        self.config = config
        self._transport = transport or self._http_post
        # deterministic per-endpoint jitter stream (tests stay seeded)
        self._retry_rng = random.Random(config.url_prefix)

    @property
    def name(self) -> str:                       # extender.go:119-122
        return self.config.url_prefix

    @property
    def is_binder(self) -> bool:                 # extender.go:384-387
        return bool(self.config.bind_verb)

    @property
    def is_ignorable(self) -> bool:
        return self.config.ignorable

    def is_interested(self, pod: Pod) -> bool:
        """extender.go:415-436: managed-resources gate — empty set means
        every pod; otherwise any container (incl. init) must request one."""
        managed = set(self.config.managed_resources)
        if not managed:
            return True
        for c in list(pod.spec.containers) + list(pod.spec.init_containers):
            if managed & set(c.requests) or managed & set(c.limits):
                return True
        return False

    @property
    def supports_preemption(self) -> bool:    # extender.go:129-132
        return bool(self.config.preempt_verb)

    # ------------------------------------------------------------- verbs

    def _args(self, pod: Pod, node_names: Sequence[str]) -> dict:
        """ExtenderArgs: names only when nodeCacheCapable, else node
        objects (extender.go:274-291)."""
        args: dict = {"pod": pod_to_dict(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = list(node_names)
        else:
            args["nodes"] = {
                "items": [{"metadata": {"name": n}} for n in node_names]
            }
        return args

    def filter(
        self, pod: Pod, node_names: Sequence[str]
    ) -> Tuple[List[str], Dict[str, str]]:
        """extender.go:258-316 Filter.  Returns (feasible subset, failed
        node -> reason).  Raises ExtenderError on transport/Error result."""
        if not self.config.filter_verb:
            return list(node_names), {}
        result = self._send(self.config.filter_verb, self._args(pod, node_names))
        try:
            if result.get("error"):
                raise ExtenderError(result["error"])
            if self.config.node_cache_capable and result.get("nodenames") is not None:
                ok = list(result["nodenames"])
            elif result.get("nodes") is not None:
                ok = [
                    it.get("metadata", {}).get("name", "")
                    for it in result["nodes"].get("items", [])
                ]
            else:
                ok = []
            return ok, dict(result.get("failedNodes") or {})
        except ExtenderError:
            raise
        except Exception as e:  # malformed 200 response
            raise ExtenderError(
                f"extender {self.name} filter: bad response: {e}"
            ) from e

    def prioritize(
        self, pod: Pod, node_names: Sequence[str]
    ) -> Tuple[Dict[str, float], int]:
        """extender.go:318-358 Prioritize: (host -> score, weight); scores
        merge additively as score*weight (generic_scheduler.go:790-799)."""
        if not self.config.prioritize_verb:
            return {n: 0.0 for n in node_names}, 0
        result = self._send(
            self.config.prioritize_verb, self._args(pod, node_names)
        )
        try:
            scores: Dict[str, float] = {}
            for item in result or []:
                scores[item.get("host", "")] = float(item.get("score", 0))
            return scores, self.config.weight
        except Exception as e:  # malformed 200 response (dict, strings, ...)
            raise ExtenderError(
                f"extender {self.name} prioritize: bad response: {e}"
            ) from e

    def process_preemption(
        self, pod: Pod, node_victims: Dict[str, dict]
    ) -> Dict[str, dict]:
        """extender.go:135-200 ProcessPreemption: candidate node ->
        MetaVictims ({"pods": [{"uid": ...}], "numPDBViolations": n});
        the extender returns the (possibly narrowed) map — a node absent
        from the reply is no longer a preemption candidate."""
        if not self.supports_preemption:
            raise ExtenderError(
                f"preempt verb is not defined for extender {self.name}"
            )
        args = {
            "pod": pod_to_dict(pod),
            "nodeNameToMetaVictims": node_victims,
        }
        result = self._send(self.config.preempt_verb, args)
        try:
            return dict(result.get("nodeNameToMetaVictims") or {})
        except Exception as e:
            raise ExtenderError(
                f"extender {self.name} preempt: bad response: {e}"
            ) from e

    def bind(self, namespace: str, name: str, uid: str, node: str) -> None:
        """extender.go:360-382 Bind; raises ExtenderError on failure."""
        if not self.is_binder:
            raise ExtenderError("unexpected empty bindVerb in extender")
        # ExtenderBindingArgs carries NO json tags in the reference
        # (api/v1/types.go), so the wire spelling is the Go field names
        result = self._send(
            self.config.bind_verb,
            {"PodName": name, "PodNamespace": namespace, "PodUID": uid,
             "Node": node},
            idempotent=False,  # a bind may have executed before the
            #                    transport error surfaced: never re-POST
        )
        if not isinstance(result, dict):
            raise ExtenderError(
                f"extender {self.name} bind: bad response: {result!r}"
            )
        # ExtenderBindingResult also has no json tags -> "Error" on the wire
        err = result.get("Error") or result.get("error")
        if err:
            raise ExtenderError(err)

    # --------------------------------------------------------- transport

    def _send(self, verb: str, args, idempotent: bool = True) -> dict:
        """One verb round-trip with bounded transient retry: up to
        config.max_retries re-sends with jittered exponential backoff for
        connection-level failures, the whole train budgeted by
        config.http_timeout (each attempt's transport timeout is the
        REMAINING budget, so retries can never stretch a cycle past the
        per-extender timeout the operator configured).

        idempotent=False (the bind verb) disables retry entirely: a read
        timeout can fire AFTER the server executed the request, and only
        idempotent verbs (filter/prioritize/preempt re-evaluate the same
        state) tolerate the duplicate."""
        url = self.config.url_prefix.rstrip("/") + "/" + verb
        cfg = self.config
        deadline = time.monotonic() + cfg.http_timeout
        delay = max(cfg.retry_backoff_s, 0.0)
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            try:
                return self._transport(url, args, max(remaining, 0.001))
            except ExtenderError:
                raise
            except urllib.error.HTTPError as e:
                # non-2xx status: the request REACHED the extender — never
                # retried (HTTPError subclasses URLError, so this must be
                # caught before the transient family)... with ONE carve-out:
                # 429 TooManyRequests means the extender shed the request
                # before executing it, so idempotent verbs retry, paced by
                # the server's Retry-After when it sent one
                if e.code != 429 or not idempotent:
                    raise ExtenderError(f"extender {url}: {e}") from e
                attempt += 1
                pause = max(
                    parse_retry_after(e.headers),
                    delay * (1.0 + self._retry_rng.random()),
                )
                if (
                    attempt > cfg.max_retries
                    or time.monotonic() + pause >= deadline
                ):
                    raise ExtenderError(
                        f"extender {url}: {e} (after {attempt} attempts)"
                    ) from e
                time.sleep(pause)
                delay *= 2.0
            except _TRANSIENT_HTTP_ERRORS as e:
                if not idempotent:
                    raise ExtenderError(f"extender {url}: {e}") from e
                attempt += 1
                # jitter spreads synchronized retries across pods' threads
                pause = delay * (1.0 + self._retry_rng.random())
                if (
                    attempt > cfg.max_retries
                    or time.monotonic() + pause >= deadline
                ):
                    raise ExtenderError(
                        f"extender {url}: {e} (after {attempt} attempts)"
                    ) from e
                time.sleep(pause)
                delay *= 2.0
            except Exception as e:  # malformed JSON, protocol errors
                raise ExtenderError(f"extender {url}: {e}") from e

    @staticmethod
    def _http_post(url: str, payload: dict, timeout: float) -> dict:
        headers = {"Content-Type": "application/json"}
        # the scheduler sets the cycle's trace context around the
        # extender fan-out (and the bind tail): every extender
        # round-trip carries the cycle's traceparent so the extender
        # side is joinable to the scheduling decision (utils/trace.py)
        from kubernetes_tpu_torch.utils.trace import (
            TRACEPARENT_HEADER,
            current_traceparent,
        )

        tp = current_traceparent()
        if tp:
            headers[TRACEPARENT_HEADER] = tp
        req = urllib.request.Request(
            url,
            data=json.dumps(payload).encode(),
            headers=headers,
            method="POST",
        )
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read().decode())


def build_extenders(configs: Sequence[dict]) -> List[HTTPExtender]:
    """Policy JSON "extenders" list -> clients (factory.go CreateFromConfig
    path that instantiates HTTPExtender per entry)."""
    return [HTTPExtender(ExtenderConfig.from_dict(c)) for c in configs]
