"""Chip smoke test for the PyTorch/CUDA port (kubernetes_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; it builds
the port's kernels from source (nvcc, sm_90a) at first use.  Phases, each
printing one line of numbers; any failure exits non-zero with no result:

  1. device: torch / CUDA versions and the card's name and power limit;
  2. K1 (select_hosts) against its plain twin on the card, bit for bit, on
     every shape, special row and rotation counter of
     kubernetes_tpu_torch/kernels/k1_cases.py (B in 1, 7, 33, 2048; N from
     1 to 70,000, unaligned widths and rows past the one-read limit
     included); then its times at [2048, N] and [1, N] of the main path
     and at [2048, 1024] (a warp a row), with L2 cold (a 256 MiB buffer
     written between launches, outside the CUDA events) and warm, beside
     an empty launch;
  3. the raw loop at full width (5,000 nodes, 10,000 pending pods, batch
     2,048, speculative engine) on the plain workload: once with the plain
     select, then through K1 with the launch counts reset just before and
     read just after; identical winners, and invariants from a numpy
     recount;
  4. the same for the node-affinity workload (every pod on a tier=a node);
  5. the redo path: a 5,000-node fleet with 2 pod slots per node, where the
     hybrid check must send batches through the sequential engine;
  6. the phase-3 winners against tests/data/torch_port_golden_plain.npz,
     the JAX speculative engine's winners for the same workload;
  7. torch.profiler over one warm speculative round of the plain cell and
     the mean sequential step of the redo cell: the top device ops, K1's
     share of the round, the kernel launches in one step; then one warm
     round of the pod-anti-affinity cell (the share of the affinity
     einsums and matmuls) and one sequential step with the affinity carry;
  8. scheduler_perf's pod-anti-affinity workload at full width with 1,000
     running pods: winners equal to
     tests/data/torch_port_golden_pod_anti_affinity.npz, and a numpy
     recount finds no two pods of one app on a node;
  9. the pod-affinity workload: winners equal to
     tests/data/torch_port_golden_pod_affinity.npz, the golden's rounds
     (the group founders bootstrap in round 1 of the first batch), and
     every pod's zone holds another pod of its app;
 10. the affinity redo: pod-anti-affinity on the 2-slot fleet, where the
     hybrid check redoes batches through the sequential engine with the
     affinity carry: K1 launched once a round at B=2,048 plus once a
     sequential step at B=1, and the anti-affinity recount;
 11. the live cycle: loop.run_live (the port of bench.py run_live) through
     the port's Scheduler at full width, speculative engine, batched and
     pipelined commit: its 12,048 bindings (warmup included) and their
     order equal tests/data/torch_port_golden_live.npz, the JAX
     Scheduler's; a numpy recount; pods/s, the phase split, the full
     collections of Python's cyclic collector inside the clock, overlap
     efficiency, dirty rows scattered and bytes H2D per cycle against a
     full snapshot upload, the dirty-row scatter's time, K1 launches and
     peak GiB;
 12. the live cycle with 256 nominated preemptors (priority 1,000, each
     claiming its node's CPU less 50m, a quarter with a hostname
     anti-affinity term): bindings equal to
     tests/data/torch_port_golden_live_nominated.npz, and a numpy recount
     finds no pod on a node its nomination leaves too little CPU and no
     anti-matched pod on a nominated node;
 13. the live preemption cell: loop.run_preemption through the port's
     Scheduler with preemption on, 5,000 nodes of 4 CPU / 32Gi, 20,500
     running pods (19,500 production at priority 1,000, 1,000 batch at
     priority 0 on every 20th node), 256 preemptors at priority 500 asking
     for 1.5 CPU, with the launch counts reset just before and read just
     after: K2 launched at least once an attempt; the preemptions
     (preemptor, node, victims), the bindings and their order, the
     unschedulable verdicts and the requested CPU per node equal
     tests/data/torch_port_golden_live_preemption.npz, the JAX Scheduler's;
     a numpy recount of CPU per node from the surviving objects; pods/s,
     the phase split with preempt split into its steps, the full
     collections inside the clock, K1 and K2 launches, bytes per cycle
     and per attempt, the dirty rows each
     snapshot update scattered, and one more attempt under torch.profiler
     (device time, idle share, K2's kernel launches and their time);
 2b. (run last, so that nothing it does can change the cells' numbers)
     K2 (preempt_one) against its plain twin on the card, all four
     outputs equal, on every case of
     kubernetes_tpu_torch/kernels/k2_cases.py (small random arenas, PDB,
     host-port and shared-volume columns, a node with over 32 victims, all
     criteria tied, no candidate, nothing possible, an order-sensitive f32
     sum, 110 victims on a node, victims on the edges of row ranges and
     slots outside the segments, an identity's evicted count crossing its
     total, 1,024 slots on 1,024 rows, rows needing no victim with and
     without a pod, and the full shape: 6,144 rows, an arena of 32,768,
     1,024 slots); then its times there with L2 cold and warm, beside its
     plain twin's, its bytes bound, its stream operations in one call
     (kernel launches, memsets and copies, counted by torch.profiler in a
     child process: one k2_ kernel and nothing else, or the phase fails),
     an empty launch's time and the launch floor (the two multiplied).

Then the card's name and power limit, the kernels' JSON record (K1's and
K2's launches in each cell among their keys) and the device line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def golden(workload: str) -> str:
    return os.path.join(ROOT, "tests", "data", "torch_port_golden_"
                        f"{workload.replace('-', '_')}.npz")


NODES, PODS, BATCH = 5000, 10000, 2048
EXISTING_ANTI = 1000   # running pods of the pod-anti-affinity cell
REDO_AFF_PODS = 9800   # the affinity redo cell: the 2-slot fleet's free slots
NOMINATED = 256        # preemptors of the live-with-nominations cell
PREEMPTORS = 256       # pending pods of the live preemption cell


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()} | nvidia-smi: {smi}", flush=True)
    return smi


def phase_k1(main_n: int) -> dict:
    """K1 against its twin, bit for bit, on every shape, special row and
    rotation counter of kernels/k1_cases.py; then its times with L2 cold
    and warm at the main path's [2048, main_n], the sequential step's
    [1, main_n] (beside an empty launch with K1's block shape) and at
    [2048, 1024], where a warp takes each row."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k1_cases
    from kubernetes_tpu_torch.ops.select import select_hosts_batch_plain

    dev = torch.device("cuda")
    t0 = time.monotonic()
    kernels.select_hosts(torch.zeros((1, 1), device=dev),
                         torch.ones((1, 1), dtype=torch.bool, device=dev), 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    cases = 0
    max_err = 0.0
    for B, N in k1_cases.shapes():
        for shift in k1_cases.shifts(B):
            scores, mask = (torch.from_numpy(a).to(dev)
                            for a in k1_cases.rows(B, N, shift))
            for li0 in k1_cases.last_indices(B):
                hk, fk = kernels.select_hosts(scores, mask, li0)
                hp, fp = select_hosts_batch_plain(scores, mask, li0)
                torch.cuda.synchronize()
                max_err = max(max_err, float(
                    (hk.to(torch.float64) - hp.to(torch.float64)).abs().max()))
                bad = torch.nonzero((hk != hp) | (fk != fp)).flatten()
                if bad.numel():
                    r = int(bad[0])
                    fail(f"K1 differs from its twin at B={B} N={N} shift "
                         f"{shift} li0={li0} row {r}: kernel ({int(hk[r])}, "
                         f"{bool(fk[r])}) twin ({int(hp[r])}, {bool(fp[r])})")
                cases += 1
            del scores, mask
    shapes = []
    for B, N in ((BATCH, main_n), (1, main_n), (BATCH, 1024)):
        scores, mask = (torch.from_numpy(a).to(dev)
                        for a in k1_cases.rows(B, N))
        k1 = lambda: kernels.select_hosts(scores, mask, 11)   # noqa: E731
        row = {"shape": [B, N],
               "ms": k1_bench.time_ms(k1, cold=True),
               "ms_warm": k1_bench.time_ms(k1, cold=False),
               "plain_ms": k1_bench.time_ms(
                   lambda: select_hosts_batch_plain(scores, mask, 11)),
               "bound_ms": k1_bench.bound_ms(B, N)}
        if B == 1:
            row["noop_ms"] = k1_bench.time_ms(kernels.noop_launch,
                                              cold=False)
        shapes.append(row)
    print(f"[2 K1] build_s {build_s:.3f} bit-identical cases {cases} "
          f"({len(k1_cases.shapes())} shapes) | "
          + " | ".join(
              f"[{r['shape'][0]},{r['shape'][1]}] cold_ms {r['ms']:.4f} "
              f"warm_ms {r['ms_warm']:.4f} plain_cold_ms {r['plain_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f}"
              + (f" empty_launch_ms {r['noop_ms']:.4f}" if "noop_ms" in r
                 else "")
              for r in shapes), flush=True)
    return {"ms": shapes[0]["ms"], "plain_ms": shapes[0]["plain_ms"],
            "bound_ms": shapes[0]["bound_ms"], "max_abs_err": max_err,
            "shapes": shapes}


# one warm K2 call at the full-width case under torch.profiler, in a
# process of its own; prints {device activity name: count}
_K2_OPS_CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k1_bench, k2_cases
c = k2_cases.full_width_case()
a = [torch.from_numpy(np.ascontiguousarray(c[k])).to(sys.argv[2])
     for k in k2_cases.ARGS]
print(json.dumps(k1_bench.stream_ops(lambda: kernels.preempt_one(*a))))
"""


def k2_stream_ops(device: str = "cuda") -> dict:
    """Every launch, memset and copy that one warm full-width K2 call puts
    on the stream, counted by torch.profiler in a child process: a
    profiler session slows the host's launches for the rest of its
    process, and one run after phase 13 recorded no device activity."""
    res = subprocess.run([sys.executable, "-c", _K2_OPS_CHILD, ROOT, device],
                         capture_output=True, text=True, timeout=300)
    check(res.returncode == 0, f"2b K2: the stream-operation count failed: "
          f"{res.stderr.strip()[-800:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def phase_k2() -> dict:
    """K2 against its twin on every case of kernels/k2_cases.py, all four
    outputs equal; then its times at the full-width case (the live cell's
    shape) with L2 cold and warm, its twin's, its bytes bound, and its
    launch floor: an empty launch's time times K2's stream operations in
    one call (k2_stream_ops), both measured here."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k2_cases
    from kubernetes_tpu_torch.models.preemption import preempt_one_plain

    dev = torch.device("cuda")
    max_err = 0.0
    names = []
    for name, c in k2_cases.cases():
        a = [torch.from_numpy(np.ascontiguousarray(c[k])).to(dev)
             for k in k2_cases.ARGS]
        got = kernels.preempt_one(*a)
        want = preempt_one_plain(*a[:10], tuple(a[10:]))
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("node", "victim_mask",
                                          "n_victims", "n_pdb_violations")):
            max_err = max(max_err, float(
                (g.to(torch.float64) - w.to(torch.float64)).abs().max()))
            if not torch.equal(g, w):
                fail(f"2b K2: {what} differs from the twin on case {name}: "
                     f"kernel {g.cpu().reshape(-1)[:8].tolist()} twin "
                     f"{w.cpu().reshape(-1)[:8].tolist()}")
        names.append(f"{name}:{int(got[0])}/{int(got[2])}")
    check(name == "full-width", "2b K2: the last case is not the full shape")
    k2 = lambda: kernels.preempt_one(*a)                    # noqa: E731
    plain = lambda: preempt_one_plain(*a[:10], tuple(a[10:]))  # noqa: E731
    out = {"ms": k1_bench.time_ms(k2, cold=True),
           "ms_warm": k1_bench.time_ms(k2, cold=False),
           "plain_ms": k1_bench.time_ms(plain),
           "bound_ms": k1_bench.k2_bound_ms(a), "max_abs_err": max_err,
           "empty_launch_ms": k1_bench.time_ms(kernels.noop_launch,
                                               cold=False),
           "shape": {"N": int(a[0].shape[0]), "E": int(a[0].shape[1]),
                     "M": int(a[4].shape[0]), "Kv": int(a[9].shape[0])}}
    ops = k2_stream_ops()
    out["stream_ops"] = sum(ops.values())
    check(out["stream_ops"] == 1 and all("k2_" in n for n in ops),
          f"2b K2: one call put {ops} on the stream, not one k2_ kernel")
    out["launch_floor_ms"] = out["empty_launch_ms"] * out["stream_ops"]
    out["over_floor"] = out["ms"] / out["launch_floor_ms"]
    print(f"[2b K2] equal to the twin on {len(names)} cases "
          f"(case:node/victims {' '.join(names)}) | at {out['shape']}: "
          f"cold_ms {out['ms']:.4f} warm_ms {out['ms_warm']:.4f} "
          f"plain_cold_ms {out['plain_ms']:.4f} bound_ms "
          f"{out['bound_ms']:.5f} | stream_ops {out['stream_ops']} "
          f"empty_launch_ms {out['empty_launch_ms']:.4f} launch_floor_ms "
          f"{out['launch_floor_ms']:.4f} cold_over_floor "
          f"{out['over_floor']:.2f}", flush=True)
    return out


def _placed(nodes, pods, res: dict, existing: int = 0):
    """[(pod, node name)] of the existing pods and the placed pods."""
    from kubernetes_tpu_torch.loop import existing_pod

    names = res["node_names"]
    running = [existing_pod(i, nodes) for i in range(existing)]
    return ([(p, p.spec.node_name) for p in running]
            + [(pods[i], names[int(r)])
               for i, r in enumerate(res["hosts"]) if r >= 0])


def _recount(nodes, pods, res: dict, what: str, existing: int = 0) -> None:
    """Numpy recount from the committed pods, the `existing` running pods
    included: no node over any allocatable column or its pod cap, and no
    pod on a taint it does not tolerate."""
    from kubernetes_tpu_torch.api.types import RESOURCE_CPU

    by_name = {n.name: n for n in nodes}
    cols = sorted({k for n in nodes for k in n.status.allocatable})
    alloc = {n.name: np.array(
        [(n.status.allocatable[k].milli if k == RESOURCE_CPU
          else float(n.status.allocatable[k]))
         if k in n.status.allocatable else 0.0 for k in cols])
        for n in nodes}
    used = {n.name: np.zeros(len(cols)) for n in nodes}
    pod_col = cols.index("pods")
    for i, (pod, name) in enumerate(_placed(nodes, pods, res, existing)):
        node = by_name[name]
        req = pod.resource_request()
        for k, q in req.items():
            if k in cols:
                used[name][cols.index(k)] += (q.milli if k == RESOURCE_CPU
                                              else float(q))
        used[name][pod_col] += 1
        if i < existing:
            continue
        for t in node.spec.taints:
            if t.effect in ("NoSchedule", "NoExecute"):
                check(any(tol.tolerates(t) for tol in pod.spec.tolerations),
                      f"{what}: {pod.name} on {name} despite taint {t.key}")
    for name in used:
        over = used[name] > alloc[name]
        check(not over.any(), f"{what}: node {name} over allocatable in "
              f"{[c for c, o in zip(cols, over) if o]}")


def _anti_recount(nodes, pods, res: dict, what: str, existing: int = 0):
    """Hostname anti-affinity per app: no two pods of one app on a node,
    the existing pods counted."""
    seen = set()
    for pod, name in _placed(nodes, pods, res, existing):
        key = (pod.labels["app"], name)
        check(key not in seen, f"{what}: two pods of {key[0]} on {name}")
        seen.add(key)


def _aff_recount(nodes, pods, res: dict, what: str) -> None:
    """Zone affinity to the pod's own app: every placed pod's zone holds
    another pod of its app (its group's founder bootstrapped the zone)."""
    from kubernetes_tpu_torch.loop import ZONE_KEY

    zone = {n.name: n.labels[ZONE_KEY] for n in nodes}
    count: dict = {}
    placed = _placed(nodes, pods, res)
    for pod, name in placed:
        key = (pod.labels["app"], zone[name])
        count[key] = count.get(key, 0) + 1
    for pod, name in placed:
        check(count[(pod.labels["app"], zone[name])] >= 2,
              f"{what}: {pod.name} alone of its app in {zone[name]}")


def _run_pair(label: str, nodes, pods, require_all: bool, existing=0):
    """run_raw through the plain select, then through K1 with the launch
    counts reset just before and read just after; the winners must agree.
    (The plain run goes first, so the reported K1 run starts warm.)
    Returns (K1 result, launches)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import run_raw

    plain = run_raw(nodes, pods, BATCH, device="cuda", select_impl="plain",
                    existing=existing)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_raw(nodes, pods, BATCH, device="cuda", select_impl="kernel",
                  existing=existing)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(launches["select_hosts"] > 0,
          f"{label}: the main path launched K1 no time")
    diff = np.nonzero(res["hosts"] != plain["hosts"])[0]
    check(diff.size == 0, f"{label}: K1 and plain select disagree on "
          f"{diff.size} pods, first pod {diff[:1].tolist()}")
    if require_all:
        check(res["scheduled"] == len(pods),
              f"{label}: {res['unschedulable']} pods unplaced")
    _recount(nodes, pods, res, label, existing)
    ph = res["phases"]
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} seconds "
          f"{res['seconds']:.3f} encode {ph['encode']:.3f} launch "
          f"{ph['launch']:.3f} fetch {ph['fetch']:.3f} commit "
          f"{ph['commit']:.3f} rounds {res['rounds']} redos {res['redos']} "
          f"scheduled {res['scheduled']} peak_device_GiB {peak_gb:.2f} | "
          f"plain-select pods_per_s "
          f"{plain['pods_per_s']:.1f} | K1 launches {launches['select_hosts']}",
          flush=True)
    return res, launches


def _explain_pod(nodes, pods, i: int, of_nodes, device="cuda") -> str:
    """Pod i's first-round view: replay the loop up to its batch, recording
    the engine's inputs, then filter and score that batch and report the
    pod's two best feasible (node, score) pairs and the scores of of_nodes."""
    from kubernetes_tpu_torch import loop
    from kubernetes_tpu_torch.codec.schema import FilterConfig, pods_to_torch
    from kubernetes_tpu_torch.ops.predicates import filter_batch
    from kubernetes_tpu_torch.ops.priorities import score_batch

    make = loop.make_speculative_scheduler
    seen = []

    def recording(**kw):
        fn = make(**kw)

        def wrapped(state, pb, ports, last, **extra):
            seen.append((state, pb, kw))
            out = fn(state, pb, ports, last, **extra)
            wrapped.last_rounds, wrapped.last_redo = fn.last_rounds, fn.last_redo
            return out
        return wrapped

    k, j = divmod(i, BATCH)
    loop.make_speculative_scheduler = recording
    try:
        loop.run_raw(nodes, pods[:(k + 1) * BATCH], BATCH, device=device)
    finally:
        loop.make_speculative_scheduler = make
    state, pb, kw = seen[k]
    pbt = pods_to_torch(pb, device)
    mask, _ = filter_batch(state, pbt, FilterConfig(),
                           kw["unsched_taint_key"], need_per=False)
    total, _ = score_batch(state, pbt, zone_key_id=kw["zone_key_id"],
                           skip_zero_weight=True, need_per=False)
    row = torch.where(mask[j], total[j], float("-inf"))
    vals, idx = torch.topk(row, 2)
    best = [(int(n), float(v)) for n, v in zip(idx, vals)]
    at = {n: float(total[j, n]) for n in of_nodes if n >= 0}
    return f"round-1 two best (node, score) {best}, scores at {at}"


def _profiled(fn):
    """fn() under torch.profiler (CPU and CUDA activities): (the profile,
    wall seconds, [(name, start us, device ms)] of every device activity,
    in start order)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t
    dev = [(e.name, e.time_range.start, e.time_range.elapsed_us() / 1e3)
           for e in prof.events() if e.device_type == DeviceType.CUDA]
    return prof, wall, sorted(dev, key=lambda d: d[1])


def _is_k1(name: str) -> bool:
    return "select_hosts_kernel" in name


def _split(dev):
    """(kernel launches, copies and sets, device ms, K1 launches, K1 ms)."""
    copies = [ms for n, _, ms in dev if n.startswith(("Memcpy", "Memset"))]
    k1 = [ms for n, _, ms in dev if _is_k1(n)]
    return (len(dev) - len(copies), len(copies), sum(ms for *_, ms in dev),
            len(k1), sum(k1))


def _top_ops(prof, dev, n=6) -> str:
    """The device time by the op that launched it (K1 by its kernel)."""
    from torch.autograd import DeviceType

    ops = [(e.key, e.self_device_time_total / 1e3)
           for e in prof.key_averages()
           if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    ops.append(("K1 select_hosts", _split(dev)[4]))
    ops.sort(key=lambda o: -o[1])
    return ", ".join(f"{k} {ms:.4f}" for k, ms in ops[:n])


def _inclusive_ms(prof, name: str) -> float:
    """Device ms of the kernels that ops called `name` launched, their
    children's included."""
    from torch.autograd import DeviceType

    return sum(e.device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and e.key == name)


def _engine(make, fleet, pods, B, existing=0, device="cuda"):
    """A warmed engine call over the first B pods on a fresh encoder of
    `fleet` with `existing` running pods, the affinity state included
    where the pods carry pod affinity: (run, fn)."""
    from kubernetes_tpu_torch.codec import transfer
    from kubernetes_tpu_torch.loop import build_encoder
    from kubernetes_tpu_torch.models.batched import (
        batch_has_pod_affinity,
        encode_batch_affinity,
        encode_batch_ports,
    )

    enc = build_encoder(fleet, existing)
    fn = make(unsched_taint_key=enc.interner.intern(
        "node.kubernetes.io/unschedulable"),
        zone_key_id=enc.getzone_key, device=device)
    batch = list(pods[:B])
    aff = (encode_batch_affinity(enc, batch)
           if batch_has_pod_affinity(batch) else None)
    pb, ports = enc.encode_pods(batch), encode_batch_ports(enc, batch)
    state = transfer.upload_cluster(enc.snapshot(), device)
    run = lambda: fn(state, pb, ports, 0, aff_state=aff)   # noqa: E731
    run()                                                   # warm
    return run, fn


def _round_line(label, run, fn, out: dict) -> str:
    """One profiled warm speculative call whose batch takes one round."""
    prof, wall, dev = _profiled(run)
    check(fn.last_rounds == 1 and not fn.last_redo,
          f"7 profile: the {label} batch took {fn.last_rounds} rounds")
    if not dev:
        return f"{label} round: not measured (no CUDA activity in the profile)"
    kern, copies, dev_ms, k1_n, k1_ms = _split(dev)
    ein, mm = _inclusive_ms(prof, "aten::einsum"), _inclusive_ms(
        prof, "aten::matmul")
    out[label] = {"wall_ms": wall * 1e3, "device_ms": dev_ms,
                  "kernels": kern, "k1_ms": k1_ms, "einsum_ms": ein,
                  "matmul_ms": mm}
    return (f"{label} round (B={BATCH}, 1 round): wall_ms {wall * 1e3:.3f} "
            f"device_ms {dev_ms:.3f} idle_share "
            f"{1 - dev_ms / (wall * 1e3):.3f} kernels {kern} copies "
            f"{copies} K1 launches {k1_n} K1_ms {k1_ms:.4f} K1_share "
            f"{k1_ms / dev_ms:.4f} einsum_ms {ein:.3f} einsum_share "
            f"{ein / dev_ms:.4f} matmul_ms {mm:.3f} matmul_share "
            f"{mm / dev_ms:.4f} | top: {_top_ops(prof, dev)}")


def _step_line(label, run, step_wall_ms, B, out: dict) -> str:
    """The sequential steps of one profiled call: a step is what runs from
    one K1 launch to the next (the median over the batch's steps)."""
    prof, _, dev = _profiled(run)
    at = [i for i, d in enumerate(dev) if _is_k1(d[0])]
    if len(at) < 3:
        return (f"{label} step: not measured ({len(at)} K1 launches in the "
                f"profile)")
    steps = [_split(dev[i:j]) for i, j in zip(at, at[1:])]
    kern, copies, dev_ms, k1_n, k1_ms = (
        float(np.median([s[c] for s in steps])) for c in range(5))
    out[label] = {"wall_ms": step_wall_ms, "device_ms": dev_ms,
                  "kernels": kern, "k1_launches": k1_n}
    return (f"{label} sequential step (median of {len(steps)}, B={B}): "
            f"wall_ms {step_wall_ms:.4f} device_ms {dev_ms:.4f} idle_share "
            f"{1 - dev_ms / step_wall_ms:.3f} kernels {kern:.0f} copies "
            f"{copies:.0f} K1 launches {k1_n:.0f} K1_ms {k1_ms:.4f} | "
            f"top ({B}-pod batch): {_top_ops(prof, dev)}")


def _timed(run) -> float:
    torch.cuda.synchronize()
    t = time.monotonic()
    run()
    torch.cuda.synchronize()
    return time.monotonic() - t


def phase_profile(nodes, tight, pods, anti_pods, device="cuda") -> dict:
    """Where the device time goes: one warm speculative call of the plain
    cell and of the pod-anti-affinity cell (each batch takes one round),
    and the sequential steps of the redo cells.  A plain step's wall time
    is a 96-pod batch's less a 32-pod batch's, over 64 steps; an affinity
    step's is a 2,048-pod batch's over its steps (the carry's width is the
    batch's), both unprofiled."""
    from kubernetes_tpu_torch.models.batched import make_sequential_scheduler
    from kubernetes_tpu_torch.models.speculative import (
        make_speculative_scheduler,
    )

    spec, seq = make_speculative_scheduler, make_sequential_scheduler
    out: dict = {}
    lines = [_round_line("plain", *_engine(spec, nodes, pods, BATCH,
                                            device=device), out)]
    lines.append(_round_line("pod-anti-affinity", *_engine(
        spec, nodes, anti_pods, BATCH, EXISTING_ANTI, device), out))
    walls = {}
    for B in (32, 96):
        run, _ = _engine(seq, tight, pods, B, device=device)
        walls[B] = _timed(run)
    lines.append(_step_line("redo", run, (walls[96] - walls[32]) / 64 * 1e3,
                            96, out))
    run, _ = _engine(seq, tight, anti_pods, BATCH, device=device)
    wall = _timed(run) / BATCH * 1e3
    run, _ = _engine(seq, tight, anti_pods, 256, device=device)
    lines.append(_step_line("affinity redo", run, wall, 256, out)
                 + f" (wall_ms at B={BATCH})")
    print("[7 profile] " + " || ".join(lines), flush=True)
    return out


def _check_golden(label, workload, res, nodes=None, pods=None):
    """The winners against the JAX speculative engine's golden file, and
    its rounds per batch.  A plain-cell mismatch is explained from the
    first round's scores."""
    data = np.load(golden(workload))
    want = data["hosts"]
    diff = np.nonzero(want != res["hosts"])[0]
    if diff.size:
        i = int(diff[0])
        why = ("; " + _explain_pod(nodes, pods, i,
                                   (int(want[i]), int(res["hosts"][i])))
               if workload == "plain" else "")
        fail(f"{label} golden: {diff.size} pods differ from the JAX winners; "
             f"first pod {i} (batch {i // BATCH}): JAX node {int(want[i])}, "
             f"port node {int(res['hosts'][i])}{why}")
    check(res["rounds"] == data["rounds"].tolist(),
          f"{label} golden: rounds {res['rounds']}, JAX "
          f"{data['rounds'].tolist()}")
    return want.size


def _scatter_ms(n_rows: int, rows: int, cols: int) -> dict:
    """The dirty-row scatter (codec/transfer.py _scatter_rows, an
    index_copy_ of `rows` f32 rows of `cols` columns into a resident
    [n_rows, cols] tensor) timed with L2 cold, beside its bytes bound
    (the rows read and written once, the int64 indices read once)."""
    from kubernetes_tpu_torch.codec.transfer import _scatter_rows
    from kubernetes_tpu_torch.kernels import k1_bench

    dev = torch.device("cuda")
    resident = torch.zeros((n_rows, cols), dtype=torch.float32, device=dev)
    idx = torch.randperm(n_rows, device=dev)[:rows]
    vals = torch.ones((rows, cols), dtype=torch.float32, device=dev)
    ms = k1_bench.time_ms(lambda: _scatter_rows(resident, idx, vals))
    nbytes = rows * cols * 4 * 2 + rows * 8
    return {"rows": rows, "cols": cols, "ms": ms,
            "bound_ms": nbytes / k1_bench.HBM_BYTES_PER_S * 1e3}


def _live_recount(nodes, res, label, nominations=()):
    """Numpy recount of a live run from its bindings: resources and taints
    (the warmup pods included); with nominations, every nominated node's
    claim plus the pods bound there after the nominations fit its CPU, and
    no pod an anti term of a nominated preemptor matches sits on its
    node."""
    from kubernetes_tpu_torch.api.nodeaffinity import _term_matches_pod
    from kubernetes_tpu_torch.api.types import RESOURCE_CPU
    from kubernetes_tpu_torch.loop import pending_pod

    pods = [pending_pod(i) for i in range(PODS + BATCH)]
    _recount(nodes, pods, res, label)
    names = res["node_names"]
    alloc = {n.name: n.status.allocatable[RESOURCE_CPU].milli for n in nodes}
    used = {}
    for i in range(PODS, PODS + BATCH):      # the warmup, before the claims
        name = names[int(res["hosts"][i])]
        used[name] = used.get(name, 0) + 100
    for pre, name in nominations:
        cpu = pre.resource_request()[RESOURCE_CPU].milli
        on = [i for i in range(PODS) if names.get(int(res["hosts"][i])) == name]
        check(not on or used.get(name, 0) + cpu + 100 * len(on)
              <= alloc[name],
              f"{label}: {len(on)} pods on {name} past {pre.name}'s claim")
        aff = pre.spec.affinity
        for term in (aff.pod_anti_affinity.required if aff is not None
                     and aff.pod_anti_affinity is not None else ()):
            bad = [i for i in on if _term_matches_pod(term, pre, pods[i])]
            check(not bad, f"{label}: pod {bad[:1]} on {name} against "
                  f"{pre.name}'s anti-affinity")


def phase_live(label: str, nodes, nominated: int = 0) -> dict:
    """loop.run_live at full width on the card, K1 counts reset just before
    and read just after; bindings and their order against the JAX
    Scheduler's golden file; a recount; one line of numbers."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import nominated_preemptors, run_live

    noms = nominated_preemptors(NODES, nominated)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_live(nodes, PODS, BATCH, device="cuda", nominations=noms)
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(launches["select_hosts"] > 0,
          f"{label}: the live cycle launched K1 no time")
    data = np.load(golden("live_nominated" if nominated else "live"))
    diff = np.nonzero(data["hosts"] != res["hosts"])[0]
    check(diff.size == 0, f"{label}: {diff.size} pods bound apart from the "
          f"JAX Scheduler; first pod index {diff[:1].tolist()}: JAX row "
          f"{data['hosts'][diff[:1]].tolist()}, port row "
          f"{res['hosts'][diff[:1]].tolist()}")
    check(np.array_equal(data["bind_order"], res["bind_order"]),
          f"{label}: the binder was called in another order than JAX's")
    check(res["placed"] == PODS, f"{label}: {res['unschedulable']} unplaced")
    _live_recount(nodes, res, label, noms)
    sched = res["scheduler"]
    sched.flush_pipeline()
    cycles = max(res["cycles"], 1)
    xf = res["transfers"]
    # the cycles' own uploads; the attempts' are per_attempt
    h2d = sum(v["bytes"] for k, v in xf.items()
              if k.startswith("h2d/") and not k.endswith("/preempt"))
    snap_up = xf.get("h2d/snapshot_upload", {"bytes": 0})["bytes"]
    scat = res["scatter_rows"]
    ph = res["phases"]
    out = {"pods_per_s": res["pods_per_s"], "seconds": res["seconds"],
           "phases": ph, "tail_seconds": res["tail_seconds"],
           "commit_state_seconds": res["commit_state_seconds"],
           "overlap_efficiency": res["overlap_efficiency"],
           "cycles": res["cycles"], "scatter_rows": scat,
           "h2d_bytes_per_cycle": h2d / cycles,
           "snapshot_upload_bytes_per_cycle": snap_up / cycles,
           "snapshot_bytes": res["snapshot_bytes"], "launches": launches,
           "gc_full": res["gc_full"], "peak_gb": peak_gb, "transfers": xf}
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} seconds "
          f"{res['seconds']:.3f} placed {res['placed']} cycles "
          f"{res['cycles']} | phases pop {ph['pop']:.4f} encode "
          f"{ph['encode']:.4f} dispatch {ph['dispatch']:.4f} fetch "
          f"{ph['fetch']:.4f} fetch_block {ph['fetch_block']:.4f} commit "
          f"{ph['commit']:.4f} (state {res['commit_state_seconds']:.4f} "
          f"tail {res['tail_seconds']:.4f}) enqueue {ph['enqueue']:.4f} | "
          f"full collections in the window {res['gc_full']['collections']} "
          f"({res['gc_full']['seconds']:.4f} s) | overlap_efficiency {res['overlap_efficiency']:.4f} | dirty rows "
          f"scattered per update {scat} | H2D bytes per cycle "
          f"{h2d / cycles:.0f} (whole-field uploads {snap_up / cycles:.0f}) "
          f"against a full snapshot {res['snapshot_bytes']} | by seam "
          f"{xf} | K1 launches {launches['select_hosts']} (B=1 "
          f"{launches['select_hosts_b1']}) | peak_device_GiB {peak_gb:.2f} "
          f"| bindings and order equal to the JAX Scheduler's "
          f"({res['hosts'].size})", flush=True)
    return out


def _preemption_recount(nodes, running, res: dict, label: str) -> None:
    """Numpy recount of CPU per node from the objects: the running pods
    that were not evicted plus the bound preemptors; every node at most its
    4 CPU, every preemptor's node at exactly 4 CPU, and the recount equal
    to the encoder's requested column and the golden's."""
    from kubernetes_tpu_torch.api.types import RESOURCE_CPU

    evicted = {v[1] for _, _, victims in res["preemptions"] for v in victims}
    row = {n.name: i for i, n in enumerate(nodes)}
    cpu = np.zeros(len(nodes))
    for pod in running:
        if pod.name not in evicted:
            cpu[row[pod.spec.node_name]] += (
                pod.resource_request()[RESOURCE_CPU].milli)
    for _, node in res["bindings"]:
        cpu[row[node]] += 1500
    check((cpu <= 4000).all(), f"{label}: a node over its 4 CPU")
    check(all(cpu[row[n]] == 4000 for _, n in res["bindings"]),
          f"{label}: a preemptor's node not at exactly 4 CPU")
    rows = {name: r for r, name in res["node_names"].items()}
    enc_cpu = res["requested"][[rows[n.name] for n in nodes], 0]
    check(np.array_equal(enc_cpu, cpu), f"{label}: the recount differs "
          f"from the encoder's requested CPU")


def phase_preemption(label: str) -> dict:
    """loop.run_preemption at full width on the card, launch counts reset
    just before and read just after; the preemptions, bindings, order,
    verdicts and requested CPU against the JAX Scheduler's golden file; a
    recount; one more attempt under torch.profiler; one line of
    numbers."""
    from torch.autograd import DeviceType

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import (
        preemption_fleet,
        preemption_running_pods,
        preemptors,
        run_preemption,
    )

    nodes = preemption_fleet(NODES)
    running = preemption_running_pods(nodes)
    pending = preemptors(PREEMPTORS + 1)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_preemption(nodes, running, pending[:PREEMPTORS], BATCH,
                         device="cuda")
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    attempts = res["attempts"]
    check(attempts > 0 and launches["preempt_one"] >= attempts,
          f"{label}: K2 launched {launches['preempt_one']} times for "
          f"{attempts} preemption attempts")
    check(launches["select_hosts"] > 0, f"{label}: K1 launched no time")
    data = np.load(golden("live_preemption"))
    pre = res["preemptions"]
    got = {"preemptor": [p[0][1] for p in pre],
           "preempt_node": [p[1] for p in pre],
           "victim_count": [len(p[2]) for p in pre],
           "victims": [v[1] for p in pre for v in p[2]],
           "bound_pod": [b[0] for b in res["bindings"]],
           "bound_node": [b[1] for b in res["bindings"]],
           "unschedulable": res["unschedulable_pods"]}
    for key, val in got.items():
        want = data[key].tolist()
        if want != val:
            i = next((j for j, (x, y) in enumerate(zip(want, val))
                      if x != y), min(len(want), len(val)))
            fail(f"{label}: {key} differs from the JAX Scheduler's at "
                 f"entry {i} of {len(want)} (port {len(val)}): JAX "
                 f"{want[i:i + 3]}, port {val[i:i + 3]}")
    check(np.array_equal(data["requested_cpu"], res["requested"][:, 0]),
          f"{label}: requested CPU per node differs from the JAX "
          f"Scheduler's")
    _preemption_recount(nodes, running, res, label)
    sched = res["scheduler"]
    # one more attempt that finds no node (every usable batch node is
    # taken): candidates, host arrays and K2, no state change
    prof, wall, dev = _profiled(lambda: sched.preempt(pending[-1]))
    k2_ms: dict = {}
    k2_ops = 0
    for n, _, ms in dev:
        if "k2_" in n:
            short = n[n.index("k2_"):].split("(")[0]
            k2_ms[short] = k2_ms.get(short, 0.0) + ms
            k2_ops += 1
    dev_ms = sum(ms for *_, ms in dev)
    xf = res["transfers"]
    per_attempt = {k: v["bytes"] / attempts for k, v in xf.items()
                   if k.endswith("/preempt")}
    # the cycles' own uploads; the attempts' are per_attempt
    h2d = sum(v["bytes"] for k, v in xf.items()
              if k.startswith("h2d/") and not k.endswith("/preempt"))
    cycles = max(res["cycles"], 1)
    scat = {int(r): res["scatter_rows"].count(r)
            for r in sorted(set(res["scatter_rows"]))}
    ph, ps = res["phases"], res["preempt_seconds"]
    out = {"pods_per_s": res["pods_per_s"], "seconds": res["seconds"],
           "placed": res["placed"], "preemptions": len(pre),
           "attempts": attempts, "phases": ph, "preempt_seconds": ps,
           "cycles": res["cycles"], "launches": launches,
           "bytes_per_attempt": per_attempt,
           "h2d_bytes_per_cycle": h2d / cycles, "scatter_rows": scat,
           "profiled_attempt": {"wall_ms": wall * 1e3, "device_ms": dev_ms,
                                "kernels": len(dev), "k2_ms": k2_ms,
                                "k2_launches": k2_ops},
           "gc_full": res["gc_full"], "peak_gb": peak_gb, "transfers": xf}
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} seconds "
          f"{res['seconds']:.3f} placed {res['placed']} preemptions "
          f"{len(pre)} (victims {sum(got['victim_count'])}) attempts "
          f"{attempts} unschedulable verdicts {len(got['unschedulable'])} "
          f"cycles {res['cycles']} | phases pop {ph['pop']:.4f} encode "
          f"{ph['encode']:.4f} dispatch {ph['dispatch']:.4f} commit "
          f"{ph['commit']:.4f} preempt {ph['preempt']:.4f} | preempt "
          f"split candidates {ps['candidates']:.4f} arrays "
          f"{ps['arrays']:.4f} pick(K2) {ps['pick']:.4f} verify "
          f"{ps['verify']:.4f} evict {ps['evict']:.4f} | full collections "
          f"in the window {res['gc_full']['collections']} "
          f"({res['gc_full']['seconds']:.4f} s) | K1 launches "
          f"{launches['select_hosts']} (B=1 {launches['select_hosts_b1']}) "
          f"K2 launches {launches['preempt_one']} | bytes per attempt "
          f"{per_attempt} H2D bytes per cycle (the attempts' left out) "
          f"{h2d / cycles:.0f} | dirty "
          f"rows scattered per update (rows: updates) {scat} | one "
          f"attempt profiled: wall_ms {wall * 1e3:.3f} device_ms "
          f"{dev_ms:.3f} idle_share {1 - dev_ms / (wall * 1e3):.3f} "
          f"kernels {len(dev)} K2 launches {k2_ops} K2 device ms {k2_ms} "
          f"| peak_device_GiB "
          f"{peak_gb:.2f} | preemptions, bindings and order equal to the "
          f"JAX Scheduler's", flush=True)
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from kubernetes_tpu_torch.loop import bench_nodes, build_encoder, pending_pod

    t_start = time.monotonic()
    smi = phase_device()
    nodes = bench_nodes(NODES)
    main_n = build_encoder(nodes).snapshot().n_nodes   # padded node width
    k1 = phase_k1(main_n)

    plain_pods = [pending_pod(i, "plain") for i in range(PODS)]
    res3, launches = _run_pair("3 plain", nodes, plain_pods, True)

    aff_pods = [pending_pod(i, "node-affinity") for i in range(PODS)]
    res4, launches4 = _run_pair("4 node-affinity", nodes, aff_pods, True)
    names = res4["node_names"]
    by_name = {n.name: n for n in nodes}
    check(all(by_name[names[int(r)]].labels.get("tier") == "a"
              for r in res4["hosts"]),
          "4 node-affinity: a pod landed off tier=a")

    tight = bench_nodes(NODES, pods_per_node=2)
    res5, launches5 = _run_pair("5 redo", tight, plain_pods, False)
    check(res5["redos"] > 0, "5 redo: the hybrid check never fired")
    check(launches5["select_hosts"] - launches5["select_hosts_b1"]
          == sum(res5["rounds"]),
          f"5 redo: {launches5} K1 launches, not one a round at B={BATCH} "
          f"({sum(res5['rounds'])} rounds) plus the B=1 steps")

    n = _check_golden("6", "plain", res3, nodes, plain_pods)
    print(f"[6 golden] {n} winners bit-identical to the JAX speculative "
          f"engine | total seconds {time.monotonic() - t_start:.1f}",
          flush=True)

    anti_pods = [pending_pod(i, "pod-anti-affinity") for i in range(PODS)]
    res8, launches8 = _run_pair("8 pod-anti-affinity", nodes, anti_pods,
                                True, EXISTING_ANTI)
    _anti_recount(nodes, anti_pods, res8, "8 pod-anti-affinity",
                  EXISTING_ANTI)
    check(launches8["select_hosts"] == sum(res8["rounds"]),
          f"8 pod-anti-affinity: {launches8} K1 launches for "
          f"{sum(res8['rounds'])} rounds")
    n = _check_golden("8", "pod-anti-affinity", res8)
    print(f"[8 golden] {n} winners bit-identical to the JAX speculative "
          f"engine, no two pods of one app on a node", flush=True)

    paff_pods = [pending_pod(i, "pod-affinity") for i in range(PODS)]
    res9, launches9 = _run_pair("9 pod-affinity", nodes, paff_pods, True)
    _aff_recount(nodes, paff_pods, res9, "9 pod-affinity")
    check(launches9["select_hosts"] == sum(res9["rounds"]),
          f"9 pod-affinity: {launches9} K1 launches for "
          f"{sum(res9['rounds'])} rounds")
    n = _check_golden("9", "pod-affinity", res9)
    print(f"[9 golden] {n} winners bit-identical to the JAX speculative "
          f"engine, rounds {res9['rounds']}, every pod's zone holds a pod "
          f"of its app", flush=True)

    redo_pods = anti_pods[:REDO_AFF_PODS]
    res10, launches10 = _run_pair("10 affinity redo", tight, redo_pods,
                                  False)
    _anti_recount(tight, redo_pods, res10, "10 affinity redo")
    check(res10["redos"] > 0, "10 affinity redo: the hybrid check never fired")
    check(launches10["select_hosts"] - launches10["select_hosts_b1"]
          == sum(res10["rounds"])
          and launches10["select_hosts_b1"] == res10["redos"] * BATCH,
          f"10 affinity redo: {launches10} K1 launches, not one a round at "
          f"B={BATCH} ({sum(res10['rounds'])} rounds) plus one a step at "
          f"B=1 ({res10['redos']} redone batches of {BATCH})")
    print(f"[10 affinity redo] redos {res10['redos']}, K1 launches "
          f"{launches10['select_hosts']} = {sum(res10['rounds'])} rounds + "
          f"{launches10['select_hosts_b1']} sequential steps | total seconds "
          f"{time.monotonic() - t_start:.1f}", flush=True)

    phase_profile(nodes, tight, plain_pods, anti_pods)

    live = phase_live("11 live", nodes)
    live12 = phase_live("12 live nominated", nodes, NOMINATED)
    # the scatter at the live cycle's shapes: the median dirty-row count of
    # the two cells' scatters, else the N/4 cap (every cycle above it
    # uploaded its row fields whole), into requested's [N, R] and
    # nonzero_req's [N, 2]
    enc = build_encoder(nodes)
    scat_rows = live["scatter_rows"] + live12["scatter_rows"]
    rows = (int(np.median(scat_rows)) if scat_rows else main_n // 4)
    scatter = [_scatter_ms(main_n, rows, enc.snapshot().requested.shape[1]),
               _scatter_ms(main_n, rows, 2)]
    print("[11 scatter] " + " | ".join(
        f"index_copy_ of {d['rows']} rows x {d['cols']} f32 into "
        f"[{main_n}, {d['cols']}]: cold_ms {d['ms']:.4f} bound_ms "
        f"{d['bound_ms']:.5f}" for d in scatter)
        + (f" (the median scattered count)" if scat_rows else
           f" (no update scattered: every cycle dirtied more than "
           f"{main_n // 4} rows)")
        + f" | total seconds {time.monotonic() - t_start:.1f}", flush=True)

    live13 = phase_preemption("13 live preemption")
    print(f"[13 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    # last, so that nothing of it can change the cells' numbers above
    k2 = phase_k2()

    # K1 launches by cell: one a speculative round at B=2048, and in the
    # redo cells one more a sequential step at B=1 (counted on their own)
    by_cell = {"plain": launches["select_hosts"],
               "node-affinity": launches4["select_hosts"],
               "redo": launches5["select_hosts"],
               "redo_b1": launches5["select_hosts_b1"],
               "pod-anti-affinity": launches8["select_hosts"],
               "pod-affinity": launches9["select_hosts"],
               "affinity-redo": launches10["select_hosts"],
               "affinity-redo_b1": launches10["select_hosts_b1"],
               "live": live["launches"]["select_hosts"],
               "live_b1": live["launches"]["select_hosts_b1"],
               "live-nominated": live12["launches"]["select_hosts"],
               "live-nominated_b1": live12["launches"]["select_hosts_b1"],
               "live-preemption": live13["launches"]["select_hosts"],
               "live-preemption_b1": live13["launches"]["select_hosts_b1"]}
    record = {"kernels": [{
        "name": "select_hosts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/select_hosts.cu",
        "replaces": "kubernetes_tpu/ops/select.py:162",
        "launches": launches["select_hosts"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "launches_by_cell": by_cell,
        "shapes": k1["shapes"],
    }, {
        "name": "preempt_one",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/preempt_one.cu",
        "replaces": "kubernetes_tpu/models/preemption.py:308",
        "launches": live13["launches"]["preempt_one"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "ms_warm": k2["ms_warm"],
        "stream_ops": k2["stream_ops"],
        "empty_launch_ms": k2["empty_launch_ms"],
        "launch_floor_ms": k2["launch_floor_ms"],
        "over_floor": k2["over_floor"],
        "shape": k2["shape"],
        "kernel_ms_in_an_attempt": live13["profiled_attempt"]["k2_ms"],
        "attempts": live13["attempts"],
    }]}
    print(f"total seconds {time.monotonic() - t_start:.1f}", flush=True)
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
