"""Chip smoke test for the PyTorch/CUDA port (kubernetes_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and the repository checkout around this file; it builds
the port's kernels from source (nvcc, sm_90a) at first use.  Phases, each
printing one line of numbers; any failure exits non-zero with no result:

  1. device: torch / CUDA versions and the card's name and power limit;
  2. K1 (select_hosts) against its plain twin on the card, bit for bit, on
     tie-dense rows plus all-false, one-feasible, NaN, B=1 and wrapping
     rotation-counter cases; times at the main path's shape;
  3. the raw loop at full width (5,000 nodes, 10,000 pending pods, batch
     2,048, speculative engine) on the plain workload: once with the plain
     select, then through K1 with the launch counts reset just before and
     read just after; identical winners, and invariants from a numpy
     recount;
  4. the same for the node-affinity workload (every pod on a tier=a node);
  5. the redo path: a 5,000-node fleet with 2 pod slots per node, where the
     hybrid check must send batches through the sequential engine;
  6. the phase-3 winners against tests/data/torch_port_golden_plain.npz,
     the JAX speculative engine's winners for the same workload.

The last two lines are the kernels' JSON record and the device line.
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
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden_plain.npz")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
NODES, PODS, BATCH = 5000, 10000, 2048


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


def _k1_inputs(B: int, N: int, gen: torch.Generator, dev):
    """Tie-dense scores (small integers) with random masks and the special
    rows the reference semantics must survive."""
    scores = torch.randint(0, 6, (B, N), generator=gen).to(torch.float32)
    mask = torch.rand((B, N), generator=gen) < 0.7
    if B >= 8:
        mask[0] = False                                # all-false row
        mask[1] = False
        mask[1, N // 3] = True                         # one feasible node
        scores[2, 7] = float("nan")                    # NaN, masked in
        mask[2, 7] = True
        scores[3, 9] = float("nan")                    # NaN, masked out
        mask[3, 9] = False
        scores[4] = 0.0                                # -0.0 == 0.0 ties
        scores[4, ::2] = -0.0
        scores[5] = float("-inf")                      # -inf everywhere
        mask[6] = True                                 # all feasible
    return scores.to(dev), mask.to(dev)


def _median_ms(fn, reps: int = 50) -> float:
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def phase_k1(main_n: int) -> dict:
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops.select import select_hosts_batch_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(20261017)
    t0 = time.monotonic()
    kernels.select_hosts(torch.zeros((1, 1), device=dev),
                         torch.ones((1, 1), dtype=torch.bool, device=dev), 0)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    cases = 0
    max_err = 0.0
    for B, N in ((2048, 5120), (2048, main_n), (1, 5120), (1, main_n),
                 (7, 1), (33, 300)):
        scores, mask = _k1_inputs(B, N, gen, dev)
        for li0 in (0, 5, 123457, 2**31 - B, 2**31 - B // 2 - 1, 2**31 - 1,
                    -3):
            hk, fk = kernels.select_hosts(scores, mask, li0)
            hp, fp = select_hosts_batch_plain(scores, mask, li0)
            torch.cuda.synchronize()
            max_err = max(max_err, float(
                (hk.to(torch.float64) - hp.to(torch.float64)).abs().max()))
            bad = torch.nonzero((hk != hp) | (fk != fp)).flatten()
            if bad.numel():
                r = int(bad[0])
                fail(f"K1 differs from its twin at B={B} N={N} li0={li0} "
                     f"row {r}: kernel ({int(hk[r])}, {bool(fk[r])}) twin "
                     f"({int(hp[r])}, {bool(fp[r])})")
            cases += 1
    # time at the main path's shape
    B, N = BATCH, main_n
    scores, mask = _k1_inputs(B, N, gen, dev)
    k_ms = _median_ms(lambda: kernels.select_hosts(scores, mask, 11))
    p_ms = _median_ms(lambda: select_hosts_batch_plain(scores, mask, 11))
    bytes_moved = B * N * 5 + B * 5          # read scores+mask, write hosts+feasible
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    print(f"[2 K1] build_s {build_s:.3f} bit-identical cases {cases} | "
          f"[{B},{N}] kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
          f"bound_ms {bound_ms:.4f} (bytes {bytes_moved})", flush=True)
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
            "max_abs_err": max_err}


def _recount(nodes, pods, res: dict, what: str) -> None:
    """Numpy recount from the committed pods: no node over any allocatable
    column or its pod cap, and no pod on a taint it does not tolerate."""
    from kubernetes_tpu_torch.api.types import RESOURCE_CPU

    hosts = res["hosts"]
    names = res["node_names"]
    by_name = {n.name: n for n in nodes}
    cols = sorted({k for n in nodes for k in n.status.allocatable})
    alloc = {n.name: np.array(
        [(n.status.allocatable[k].milli if k == RESOURCE_CPU
          else float(n.status.allocatable[k]))
         if k in n.status.allocatable else 0.0 for k in cols])
        for n in nodes}
    used = {n.name: np.zeros(len(cols)) for n in nodes}
    pod_col = cols.index("pods")
    for i, r in enumerate(hosts):
        if r < 0:
            continue
        name = names[int(r)]
        node = by_name[name]
        req = pods[i].resource_request()
        for k, q in req.items():
            if k in cols:
                used[name][cols.index(k)] += (q.milli if k == RESOURCE_CPU
                                              else float(q))
        used[name][pod_col] += 1
        for t in node.spec.taints:
            if t.effect in ("NoSchedule", "NoExecute"):
                check(any(tol.tolerates(t) for tol in pods[i].spec.tolerations),
                      f"{what}: pod {i} on {name} despite taint {t.key}")
    for name in used:
        over = used[name] > alloc[name]
        check(not over.any(), f"{what}: node {name} over allocatable in "
              f"{[c for c, o in zip(cols, over) if o]}")


def _run_pair(label: str, nodes, pods, require_all: bool):
    """run_raw through the plain select, then through K1 with the launch
    counts reset just before and read just after; the winners must agree.
    (The plain run goes first, so the reported K1 run starts warm.)
    Returns (K1 result, launches)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import run_raw

    plain = run_raw(nodes, pods, BATCH, device="cuda", select_impl="plain")
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run_raw(nodes, pods, BATCH, device="cuda", select_impl="kernel")
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
    _recount(nodes, pods, res, label)
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

        def wrapped(state, pb, ports, last):
            seen.append((state, pb, kw))
            out = fn(state, pb, ports, last)
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from kubernetes_tpu_torch.loop import bench_nodes, pending_pod

    t_start = time.monotonic()
    smi = phase_device()
    nodes = bench_nodes(NODES)
    from kubernetes_tpu_torch.loop import build_encoder

    main_n = build_encoder(nodes).snapshot().n_nodes   # padded node width
    k1 = phase_k1(main_n)

    plain_pods = [pending_pod(i, "plain") for i in range(PODS)]
    res3, launches = _run_pair("3 plain", nodes, plain_pods, True)

    aff_pods = [pending_pod(i, "node-affinity") for i in range(PODS)]
    res4, _ = _run_pair("4 node-affinity", nodes, aff_pods, True)
    names = res4["node_names"]
    by_name = {n.name: n for n in nodes}
    check(all(by_name[names[int(r)]].labels.get("tier") == "a"
              for r in res4["hosts"]),
          "4 node-affinity: a pod landed off tier=a")

    tight = bench_nodes(NODES, pods_per_node=2)
    res5, _ = _run_pair("5 redo", tight, plain_pods, False)
    check(res5["redos"] > 0, "5 redo: the hybrid check never fired")

    golden = np.load(GOLDEN)["hosts"]
    diff = np.nonzero(golden != res3["hosts"])[0]
    if diff.size:
        i = int(diff[0])
        fail(f"6 golden: {diff.size} pods differ from the JAX winners; first "
             f"pod {i} (batch {i // BATCH}): JAX node {int(golden[i])}, port "
             f"node {int(res3['hosts'][i])}; "
             + _explain_pod(nodes, plain_pods, i,
                            (int(golden[i]), int(res3["hosts"][i]))))
    print(f"[6 golden] {golden.size} winners bit-identical to the JAX "
          f"speculative engine | total seconds "
          f"{time.monotonic() - t_start:.1f}", flush=True)

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
    }]}
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
