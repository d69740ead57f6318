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
     the mean sequential step of the redo cell: the top device ops, K1's,
     K11's and K12's share of the round (one K11 and at least one K12
     launch in it, or the phase fails), the kernel launches in one step;
     then one warm round of the pod-anti-affinity cell (the share of the
     affinity einsums and matmuls) and one sequential step with the
     affinity carry;
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
 14. the placement-quality observatory (quality_top_k=3, the reference's
     default): K3 (select_topk) against its plain twin on the card, bit
     for bit, on every shape, case, rotation counter and K of
     kubernetes_tpu_torch/kernels/k3_cases.py (winners from K1 on the same
     rows; B in 1, 7, 33, 2048; N from 1 to 70,000; K in 1, 2, 3, 8 and
     K > N), then its times at [2048, N] and [1, N] with K=3, L2 cold and
     warm, beside its bytes bound, its twin and torch.topk; K4
     (binpack_ffd) against its twin on every case of
     kubernetes_tpu_torch/kernels/k4_cases.py (full bins, zero rows,
     overflow, duplicates, a workspace past shared memory, the regret's
     full width N 6,144 x P 2,048), then its times there beside its bound
     and its step floor (P empty block reductions and barriers); then the
     live cell through the port's Scheduler with the observatory on and a
     regret sample every cycle, launch counts reset just before and read
     just after: bindings and order equal to
     tests/data/torch_port_golden_live.npz, every cycle's top-k leaves and
     every regret sample equal to
     tests/data/torch_port_golden_live_quality.npz, no regret sample
     dropped; and once more at the default interval (32): pods/s and the
     quality hook's share of the window beside phase 11's quality-off run;
 K5. the cluster analytics kernel (cluster_analytics.cu) against its plain
     twin (computed on the CPU from the same inputs), bit for bit, on every
     case of kubernetes_tpu_torch/kernels/k5_cases.py (no rows, one row,
     rows not a power of two, every row invalid, a column with no
     capacity, over-committed nodes, recycled rows, -0.0 beside 0.0,
     quantile ties, decile edges, twelve decades of magnitude, R 4 and 5,
     the live cell's 6,144 rows and K5's widest 16,384); then its times
     at the live cell's shape with L2 cold and warm, beside its bytes
     bound, its twin's time on the card, an empty launch and its launch
     floor (the empty launch times K5's stream operations in one call,
     counted by torch.profiler in a child process: one kernel, or the
     phase fails);
 15. the live default: the live cell through the port's Scheduler at the
     reference's default SchedulerConfig with only cpu_fallback turned
     off (telemetry at interval 1, the timeline, quality_top_k=3 at
     interval 32; run_live's batch, window, commit and preemption
     settings), launch counts reset just before and read just after:
     bindings and order, every telemetry sample's cycle and analytics,
     the drift detectors' state after every cycle, every cycle's top-k
     leaves and every regret sample equal to
     tests/data/torch_port_golden_live_default.npz, the JAX Scheduler's;
     every sample from the device, none dropped, K5 launched once per
     committed cycle; pods/s beside phase 11's, and the shares of the
     window taken by the telemetry and the timeline hooks;
 K6. the megacycle's spread-count commit (commit_group_counts.cu)
     against its plain twin on the card, bit for bit, on every case of
     kubernetes_tpu_torch/kernels/k6_cases.py (B in 1, 7, 2,048; N in 12,
     6,144; G up to 64; every pod unschedulable, every pod on one node,
     duplicate slots, counts near 2^24), gc never written; then its times
     at the live cell's shape (N 6,144, G 32, B 2,048) with L2 cold and
     warm, beside its bytes bound, an empty launch, its twin's and one
     index_add of the same counts;
 16. the megacycle cell: loop.run_megacycle at full width with
     megacycle_batches 1 and 4, each through a fresh Scheduler at the
     reference's default config with only cpu_fallback off, launch counts
     taken in each timed window: K = 4's bindings and order equal K = 1's
     and tests/data/torch_port_golden_live_megacycle.npz (the JAX
     Scheduler's), and so do its windows' top-k leaves, regret samples and
     telemetry samples; at least one megacycle and one K6 launch in the
     timed window, nothing dropped; pods/s and host seconds a pod for both
     depths, printed, not judged;
 17. the live quality cell with 13 extended resource names on every node
     (R = 32, K4's wide variant), a regret sample every cycle: none
     dropped, every sample equal to the twin's on the same inputs;
 K7. the predicate fold (fold_predicates.cu) against its plain twin on the
     card, bit for bit, on every case of kubernetes_tpu_torch/kernels/
     k7_cases.py (B in 1, 7, 33, 2,048 x N in 1, 3, 4, 5, 6,144, 6,145,
     70,000; fail rates from 0 to 1, all-pass and all-fail rows, invalid
     nodes and pods, a disabled predicate); then its times at the
     extender's shape [1, 23, 6,144] and at [2,048, 23, 6,144] with L2
     cold and warm, beside its bytes bound, an empty launch, its twin's
     and torch.all's (the mask half alone);
 K11. the predicate pass (filter_pass.cu) against its plain twin on the
     card, bit for bit, on every case of kubernetes_tpu_torch/kernels/
     k11_cases.py (every selector operator with NaN and infinite numeric
     labels, wildcard tolerations and PAD effects, wildcard host IPs, CSI
     per-driver columns, profile subsets, label presence and service
     affinity, padding rows, N not a multiple of 4, non-lean affinity and
     volume terms): the stack, the mask, and filter_batch's need_per mask
     (the stack folded by K7); then its times on the bench fleet at [1,
     6,144] in stack mode (the sidecar's) and [2,048, 6,144] in mask mode
     (the engines') with L2 cold and warm, beside its bound (bytes and
     operations from the shapes), an empty launch and its twin's;
 K12. the score pass (score_pass.cu) against its plain twin, bit for bit,
     on every case of kernels/k12_cases.py (stock, every-priority and a
     Policy's weights, skip_zero_weight, shipped and group-column spread
     counts, no zones, zero maxima, InterPodAffinity with and without
     spread, ImageLocality's clamps, RTC's ends, a snapshot past one
     block's shared memory), the total and every row with need_per and the
     total without; then its times at [1, 6,144] and [2,048, 6,144];
 18. the extender sidecar: the port's ExtenderServer on the card driven
     over HTTP on 127.0.0.1 by loop.drive_extender as a stock
     kube-scheduler with NodeCacheCapable: true drives it (the bench
     fleet, its 20 spread selectors and 1,000 running pods synced; 512
     pending pods through /filter, /prioritize and /bind), with the launch
     counts reset just before and read just after: every reply digest and
     bound node equal to tests/data/torch_port_golden_extender.npz (the
     JAX sidecar's), K7 launched twice a pod; then a second sidecar synced
     with phase 13's fleet and 20,500 running pods answers the first 16
     preemptors' /preempt (each reply's victims deleted before the next)
     equal to the same golden, K2 launched; K11 (stack mode) and K12
     launched twice a pod; per-verb latency p50 / p99 and requests/s, the
     split of a /filter request, the syncs' seconds, and one warm /filter's
     device operations counted by torch.profiler in a child process (at
     most 30, or the phase fails);
 19. the live extender: loop.run_live through the port's Scheduler with
     one HTTP extender (filter, prioritize, bind verbs) pointed at the
     port's sidecar in this process, 5,000 nodes, a 64-pod warmup batch,
     then 1,024 pods in batches of 256, pipeline_commit off: bindings and
     order equal to
     tests/data/torch_port_golden_live_extender.npz (the JAX Scheduler
     with the JAX sidecar), K7 launched twice a pod on the sidecar;
     pods/s and the extenders span's share of the window;
 K9. the FFD class order (ffd_order.cu) against its plain twin on the card,
     bit for bit, on every case of kubernetes_tpu_torch/kernels/
     k9_cases.py (ties, duplicates, zero rows, zero-capacity columns, -0.0
     beside 0.0, C 1 and 777, R 1 to 64, C 65,536, the per-pod sweep's
     50,000 pods); then its times at the BASELINE sweep (256 classes x
     10,000 shapes) with L2 cold and warm, beside its bound, an empty
     launch and its twin's;
 K8. the count-carrying first-fit scan (binpack_counts.cu) against its
     twin, bit for bit, on every case of k8_cases.py (full bins and zero
     rows, zero classes, every class overflowing, counts near the int32
     clip, fractional inputs, negative order entries, max_bins 1 and
     2,048, R 4 to 64, 1,500 lanes, the workspace, per-bin N 6,144, 16,385
     and 40,000); then at the BASELINE sweep (10,000 lanes of 2,048 bins)
     its twin's run (kept for phase 20, its admissions counted for the
     bound) and the kernel's times;
 K10. the replicas' admission scan (reconcile_admit.cu) against its twin,
     bit for bit, on every case of k10_cases.py (one node, one tenant,
     quota vetoes, no quota, padding, stale rows, the 1e-3 slack's edge, Bp
     1 to 2,048, R 1 to 33); then its times at Bp 2,048, R 8;
 20. BASELINE's fifth configuration, the what-if: models/binpack.py what_if
     of 50,000 pending pods in 256 classes over 10,000 candidate shapes
     with 2,048 bins (one K9 and one K8 launch): bins and ok on every lane
     equal to the twin's and to tests/data/torch_port_golden_what_if.npz
     (the JAX binpack_shapes_compressed), and on the first 4 shapes the
     per-pod sweep (K9 over the 50,000 pods, then K4 a lane) needs the
     same bins; the solve's milliseconds and shapes a second;
 21. the live capacity cell: loop.run_live at full width with the capacity
     planner every cycle over phase 20's first 64 shapes, every node
     pre-filled to 3.5 free CPU and the pending pods' requests drawn from
     phase 20's classes (the last batch's fit no node): bindings, order
     and every solve equal to
     tests/data/torch_port_golden_live_capacity.npz (the JAX
     Scheduler's), placements equal to a planner-off run, K8 and K9
     launched twice a solve and no solve dropped; pods/s and the hook's
     share of the window;
 22. the replicas: loop.run_replicas at full width with 1 and 2 replicas,
     then the four-tenant storm with a 50-CPU quota on the flooding
     tenant: every pod placed or accounted for, no invariant violation,
     every replica drained, K10 launched once a scan, every scan replayed
     through the twin equal, at least one quota veto; pods/s a replica
     count, conflicts and the fast path printed, not judged;
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

Phases 14, K5 and 2b also hold K4 at 32 and 64 columns, K5 at 16,385 and
40,000 rows (its multi-block sequence) and K2 at 66 and 130 columns (its
wide variant) to their twins at full shapes, with their times.

Every phase whose cell filters and scores (3-19, 21, 22) checks that its
run launched K11 and K12, and K7 once for every K11 stack (stack mode:
the sidecar's requests, the preemption candidates); phase 7's round
profile reports K11's and K12's device ms and share.

Then the card's name and power limit, the kernels' JSON record (K1-K12;
K1's, K11's and K12's launches in each cell among their keys) and the
device line.
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
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (data sheet)
INT32_OPS_PER_S = F32_OPS_PER_S / 2   # an SM has 64 INT32 lanes beside its
#                                       128 FP32 ones (Hopper white paper)


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


_K5_OPS_CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.kernels import k1_bench, k5_cases
a = [torch.from_numpy(np.ascontiguousarray(x)).to(sys.argv[2])
     for x in k5_cases.full_width_case()]
print(json.dumps(k1_bench.stream_ops(lambda: kernels.cluster_analytics(*a))))
"""


_FILTER_OPS_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from kubernetes_tpu_torch import loop
from kubernetes_tpu_torch.api.serialize import pod_to_dict
from kubernetes_tpu_torch.extender.server import ExtenderServer
from kubernetes_tpu_torch.kernels import k1_bench
from kubernetes_tpu_torch.runtime.cache import SchedulerCache
nodes = loop.bench_nodes(5000)
srv = ExtenderServer(cache=SchedulerCache(loop.build_encoder(nodes, 1000)),
                     device=sys.argv[2])
args = {"pod": pod_to_dict(loop.pending_pod(0)),
        "nodenames": [n.name for n in nodes]}
print(json.dumps(k1_bench.stream_ops(lambda: srv.filter(args))))
"""


def _child_stream_ops(child: str, label: str, device: str) -> dict:
    """Every launch, memset and copy that one warm full-width call of a
    kernel puts on the stream, counted by torch.profiler in a child
    process: a profiler session slows the host's launches for the rest of
    its process, and one run after phase 13 recorded no device
    activity.  A child whose session saw no device activity at all (the
    profiler can miss the card: a run recorded nothing after the kernel
    had matched its twin) is run once more; its count is checked as any."""
    for _ in range(2):
        res = subprocess.run([sys.executable, "-c", child, ROOT, device],
                             capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"{label}: the stream-operation count "
              f"failed: {res.stderr.strip()[-800:]}")
        ops = json.loads(res.stdout.strip().splitlines()[-1])
        if ops:
            break
    return ops


def k2_stream_ops(device: str = "cuda") -> dict:
    """K2's stream operations in one warm full-width call."""
    return _child_stream_ops(_K2_OPS_CHILD, "2b K2", device)


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
    # past 64 columns (the wide variant) at the full shape
    out["wide"] = []
    for e in (66, 130):
        wc = k2_cases.wide_case(c, e)
        aw = [torch.from_numpy(np.ascontiguousarray(wc[k])).to(dev)
              for k in k2_cases.ARGS]
        got = kernels.preempt_one(*aw)
        want = preempt_one_plain(*aw[:10], tuple(aw[10:]))
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"2b K2: E={e} at the full shape differs from the twin")
        out["wide"].append({
            "E": e, "node": int(got[0]),
            "ms": k1_bench.time_ms(lambda: kernels.preempt_one(*aw),
                                   cold=True),
            "ms_warm": k1_bench.time_ms(lambda: kernels.preempt_one(*aw),
                                        cold=False),
            "plain_ms": k1_bench.time_ms(
                lambda: preempt_one_plain(*aw[:10], tuple(aw[10:]))),
            "bound_ms": k1_bench.k2_bound_ms(aw)})
    print(f"[2b K2] equal to the twin on {len(names)} cases "
          f"(case:node/victims {' '.join(names)}) | at {out['shape']}: "
          f"cold_ms {out['ms']:.4f} warm_ms {out['ms_warm']:.4f} "
          f"plain_cold_ms {out['plain_ms']:.4f} bound_ms "
          f"{out['bound_ms']:.5f} | stream_ops {out['stream_ops']} "
          f"empty_launch_ms {out['empty_launch_ms']:.4f} launch_floor_ms "
          f"{out['launch_floor_ms']:.4f} cold_over_floor "
          f"{out['over_floor']:.2f} | "
          + " | ".join(f"E={w['E']} (node {w['node']}, equal to the twin): "
                       f"cold_ms {w['ms']:.4f} warm_ms {w['ms_warm']:.4f} "
                       f"plain_cold_ms {w['plain_ms']:.4f} bound_ms "
                       f"{w['bound_ms']:.5f}" for w in out["wide"]),
          flush=True)
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
    _passes_launched(label, launches)
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
          f"{plain['pods_per_s']:.1f} | K1 launches {launches['select_hosts']}"
          f" K11 {launches['filter_pass']} K12 {launches['score_pass']}",
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


def _is_k11(name: str) -> bool:
    return "k11_filter_pass" in name


def _is_k12(name: str) -> bool:
    return "k12_score_pass" in name or "k12_zone_index" in name


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
    k11 = [ms for n, _, ms in dev if _is_k11(n)]
    k12 = [ms for n, _, ms in dev if _is_k12(n)]
    check(len(k11) == 1 and k12,
          f"7 profile: the {label} round launched K11 {len(k11)} times and "
          f"K12 {len(k12)}")
    out[label] = {"wall_ms": wall * 1e3, "device_ms": dev_ms,
                  "kernels": kern, "k1_ms": k1_ms, "einsum_ms": ein,
                  "matmul_ms": mm, "k11_launches": len(k11),
                  "k11_ms": sum(k11), "k12_launches": len(k12),
                  "k12_ms": sum(k12)}
    return (f"{label} round (B={BATCH}, 1 round): wall_ms {wall * 1e3:.3f} "
            f"device_ms {dev_ms:.3f} idle_share "
            f"{1 - dev_ms / (wall * 1e3):.3f} kernels {kern} copies "
            f"{copies} K1 launches {k1_n} K1_ms {k1_ms:.4f} K1_share "
            f"{k1_ms / dev_ms:.4f} K11 launches {len(k11)} K11_ms "
            f"{sum(k11):.4f} K11_share {sum(k11) / dev_ms:.4f} K12 "
            f"launches (zone index and pass) {len(k12)} K12_ms "
            f"{sum(k12):.4f} K12_share {sum(k12) / dev_ms:.4f} "
            f"einsum_ms {ein:.3f} einsum_share "
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


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (f32 compared as int32: NaN and -0.0 count)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.to(torch.float64) - b.to(torch.float64)).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def _k3_bound_ms(B: int, N: int, K: int) -> float:
    """K3's least time: scores and mask read once, hosts and feasible
    read once, the [B, K] nodes and scores and the B counts written once,
    over the memory rate."""
    from kubernetes_tpu_torch.kernels import k1_bench

    return (B * N * 5 + B * 5 + B * (8 * K + 4)) / k1_bench.HBM_BYTES_PER_S * 1e3


def phase_k3(main_n: int) -> dict:
    """K3 (select_topk) against its plain twin on the card, bit for bit,
    on every shape, case, rotation counter and K of kernels/k3_cases.py,
    with the winners from K1 on the same rows; then its times at the main
    path's [2048, main_n] and the sequential step's [1, main_n] with K=3,
    L2 cold and warm, beside its bytes bound, the twin and torch.topk."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k3_cases
    from kubernetes_tpu_torch.ops.select import select_topk_batch_plain

    dev = torch.device("cuda")
    cases = 0
    max_err = 0.0
    for B, N in k3_cases.shapes():
        for shift in k3_cases.shifts(B):
            s, m = (torch.from_numpy(a).to(dev)
                    for a in k3_cases.rows(B, N, shift))
            for li in k3_cases.LAST_INDICES:
                h, f = kernels.select_hosts(s, m, li)
                for k in k3_cases.KS:
                    got = kernels.select_topk(s, m, h, f, k)
                    want = select_topk_batch_plain(s, m, h, f, k)
                    torch.cuda.synchronize()
                    for g, w, what in zip(got, want, ("top_nodes",
                                                      "top_scores",
                                                      "feasible")):
                        max_err = max(max_err, _abs_err(g, w))
                        if not _bits_equal(g, w):
                            bad = torch.nonzero(
                                (g != w).reshape(B, -1).any(dim=1)).flatten()
                            r = int(bad[0]) if bad.numel() else 0
                            fail(f"14 K3: {what} differs from the twin at "
                                 f"B={B} N={N} shift {shift} li {li} k {k} "
                                 f"row {r}: kernel {g[r].tolist()} twin "
                                 f"{w[r].tolist()}")
                    cases += 1
            del s, m
    shapes = []
    for B in (BATCH, 1):
        s, m = (torch.from_numpy(a).to(dev)
                for a in k3_cases.rows(B, main_n))
        h, f = kernels.select_hosts(s, m, 11)
        k3 = lambda: kernels.select_topk(s, m, h, f, 3)       # noqa: E731
        shapes.append({
            "shape": [B, main_n], "k": 3,
            "ms": k1_bench.time_ms(k3, cold=True),
            "ms_warm": k1_bench.time_ms(k3, cold=False),
            "plain_ms": k1_bench.time_ms(
                lambda: select_topk_batch_plain(s, m, h, f, 3)),
            "library_ms": k1_bench.time_ms(
                lambda: torch.topk(torch.where(m, s, -3.4e38), 3)),
            "bound_ms": _k3_bound_ms(B, main_n, 3)})
    print(f"[14 K3] bit-identical to the twin on {cases} cases "
          f"({len(k3_cases.shapes())} shapes, K in {k3_cases.KS}) | "
          + " | ".join(
              f"[{r['shape'][0]},{r['shape'][1]}] K=3 cold_ms {r['ms']:.4f} "
              f"warm_ms {r['ms_warm']:.4f} plain_cold_ms "
              f"{r['plain_ms']:.4f} torch_topk_cold_ms {r['library_ms']:.4f} "
              f"bound_ms {r['bound_ms']:.4f}" for r in shapes), flush=True)
    return {**shapes[0], "max_abs_err": max_err, "cases": cases,
            "shapes": shapes}


def _k4_ops(reqs: np.ndarray, cap: np.ndarray, order: np.ndarray) -> int:
    """The operations first-fit needs on this data: for each pod with a
    positive request, an add and a compare a column for every bin up to
    and including its first fit (every bin when none fits), and an add a
    column where it lands (numpy replay of the scan)."""
    loads = np.zeros_like(cap)
    R = reqs.shape[1]
    ops = 0
    for oi in order:
        req = reqs[oi]
        if not (req > 0).any():
            continue
        fits = np.all(loads + req[None, :] <= cap, axis=-1)
        hit = np.flatnonzero(fits)
        ops += 2 * R * ((int(hit[0]) + 1) if hit.size else cap.shape[0])
        if hit.size:
            loads[hit[0]] += req
            ops += R
    return ops


def phase_k4() -> dict:
    """K4 (binpack_ffd) against its plain twin on the card, bit for bit,
    on every case of kernels/k4_cases.py; then its times at the regret's
    full width (N 6,144, P 2,048, R 8) with L2 cold and warm, beside its
    bound (the larger of its bytes and the operations this data needs over
    the card's rates), its step floor (an empty chain of P block
    reductions and barriers in K4's block, timed here) and the twin's."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k4_cases
    from kubernetes_tpu_torch.models.binpack import (
        binpack_ffd,
        binpack_ffd_plain,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    names = []
    for name, c in k4_cases.cases():
        reqs, cap = (torch.from_numpy(c[k]).to(dev) for k in ("reqs", "cap"))
        order = (None if c["order"] is None
                 else torch.from_numpy(c["order"]).to(dev))
        got = binpack_ffd(reqs, cap, c["max_bins"], order)
        want = binpack_ffd_plain(reqs, cap, c["max_bins"], order)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("used", "loads", "placed")):
            max_err = max(max_err, _abs_err(g, w))
            if not _bits_equal(g, w):
                fail(f"14 K4: {what} differs from the twin on case {name}: "
                     f"kernel {g.cpu().reshape(-1)[:8].tolist()} twin "
                     f"{w.cpu().reshape(-1)[:8].tolist()}")
        names.append(f"{name}:{int(got[0])}")
    check(name == "full-width", "14 K4: the last case is not the full width")
    P, R = reqs.shape
    N = cap.shape[0]
    k4 = lambda: binpack_ffd(reqs, cap, None, order)        # noqa: E731
    nbytes = (P * R * 4 + N * R * 4 + P * 4) + (N * R * 4 + P + 4)
    ops = _k4_ops(c["reqs"], c["cap"], c["order"])
    out = {"ms": k1_bench.time_ms(k4, cold=True),
           "ms_warm": k1_bench.time_ms(k4, cold=False),
           "plain_ms": k1_bench.time_ms(
               lambda: binpack_ffd_plain(reqs, cap, None, order), reps=3),
           "bytes_ms": nbytes / k1_bench.HBM_BYTES_PER_S * 1e3,
           "ops": ops, "ops_ms": ops / F32_OPS_PER_S * 1e3,
           "step_floor_ms": k1_bench.time_ms(
               lambda: kernels.barrier_floor_launch(P), cold=False),
           "max_abs_err": max_err, "shape": {"N": N, "P": P, "R": R}}
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                       else "operations")
    out["over_step_floor"] = out["ms"] / out["step_floor_ms"]
    # the regret's full width with 32 and 64 columns (the wide variant)
    out["wide"] = []
    for r in (32, 64):
        wc = k4_cases.full_width(r)
        wr, wcap, wo = (torch.from_numpy(wc[k]).to(dev)
                        for k in ("reqs", "cap", "order"))
        got = binpack_ffd(wr, wcap, None, wo)
        want = binpack_ffd_plain(wr, wcap, None, wo)
        torch.cuda.synchronize()
        check(all(_bits_equal(g, w) for g, w in zip(got, want)),
              f"14 K4: R={r} at the full width differs from the twin")
        wbytes = (P * r * 4 + N * r * 4 + P * 4) + (N * r * 4 + P + 4)
        wops = _k4_ops(wc["reqs"], wc["cap"], wc["order"])
        row = {"R": r, "bins": int(got[0]),
               "ms": k1_bench.time_ms(
                   lambda: binpack_ffd(wr, wcap, None, wo), cold=True),
               "ms_warm": k1_bench.time_ms(
                   lambda: binpack_ffd(wr, wcap, None, wo), cold=False),
               "plain_ms": k1_bench.time_ms(
                   lambda: binpack_ffd_plain(wr, wcap, None, wo), reps=3),
               "bytes_ms": wbytes / k1_bench.HBM_BYTES_PER_S * 1e3,
               "ops_ms": wops / F32_OPS_PER_S * 1e3}
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        out["wide"].append(row)
    print(f"[14 K4] equal to the twin on {len(names)} cases (case:bins "
          f"{' '.join(names)}) | at {out['shape']}: cold_ms {out['ms']:.4f} "
          f"warm_ms {out['ms_warm']:.4f} plain_cold_ms {out['plain_ms']:.2f} "
          f"bound_ms {out['bound_ms']:.5f} ({out['bound_by']}: bytes "
          f"{out['bytes_ms']:.5f}, {ops} operations {out['ops_ms']:.5f}) | "
          f"step_floor_ms {out['step_floor_ms']:.4f} cold_over_floor "
          f"{out['over_step_floor']:.2f} | "
          + " | ".join(f"R={w['R']} (bins {w['bins']}, equal to the twin): "
                       f"cold_ms {w['ms']:.4f} warm_ms {w['ms_warm']:.4f} "
                       f"plain_cold_ms {w['plain_ms']:.2f} bound_ms "
                       f"{w['bound_ms']:.5f}" for w in out["wide"]),
          flush=True)
    return out


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal arrays, floats bit for bit (NaN and -0.0 count)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        return np.array_equal(a.view(np.int32), b.view(np.int32))
    if a.dtype == np.float64:
        return np.array_equal(a.view(np.int64), b.view(np.int64))
    return np.array_equal(a, b)


def phase_quality(nodes, live: dict) -> dict:
    """The live cell through the port's Scheduler with the placement-
    quality observatory on (quality_top_k=3): with a regret sample every
    cycle, launch counts reset just before and read just after, its
    bindings and order equal to tests/data/torch_port_golden_live.npz and
    its top-k leaves and regret samples to
    tests/data/torch_port_golden_live_quality.npz, no sample dropped; then
    at the default interval (32), its pods/s and the quality hook's share
    of the window beside phase 11's quality-off run."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import REGRET_KEYS, quality_arrays, run_live

    kernels.reset_launch_counts()
    res = run_live(nodes, PODS, BATCH, device="cuda", quality_top_k=3,
                   quality_interval_cycles=1)
    launches = dict(kernels.LAUNCHES)
    label = "14 live quality"
    q = res["quality"]
    check(launches["select_topk"] > 0, f"{label}: K3 launched no time")
    check(launches["binpack_ffd"] > 0, f"{label}: K4 launched no time")
    check(q["regret_dropped"] == 0,
          f"{label}: {q['regret_dropped']} regret samples dropped")
    ref = np.load(golden("live"))
    diff = np.nonzero(ref["hosts"] != res["hosts"])[0]
    check(diff.size == 0, f"{label}: {diff.size} pods bound apart from "
          f"the JAX Scheduler; first pod index {diff[:1].tolist()}")
    check(np.array_equal(ref["bind_order"], res["bind_order"]),
          f"{label}: the binder was called in another order than JAX's")
    data = np.load(golden("live_quality"))
    got = quality_arrays(res["quality_record"])
    for key, val in got.items():
        want = data[key]
        check(_same(want, val), f"{label}: {key} differs from the JAX "
              f"Scheduler's: "
              f"JAX {want.reshape(-1)[:6].tolist()} port "
              f"{val.reshape(-1)[:6].tolist()}")
    check(launches["binpack_ffd"] == len(got["regret_cycle"]),
          f"{label}: {launches['binpack_ffd']} K4 launches for "
          f"{len(got['regret_cycle'])} regret samples")
    kernels.reset_launch_counts()
    res32 = run_live(nodes, PODS, BATCH, device="cuda", quality_top_k=3)
    launches32 = dict(kernels.LAUNCHES)
    q32 = res32["quality"]
    check(q32["regret_dropped"] == 0,
          f"14 live quality/32: {q32['regret_dropped']} regret samples "
          f"dropped")
    check(np.array_equal(ref["hosts"], res32["hosts"]),
          "14 live quality/32: bindings differ from the JAX Scheduler's")
    out = {"launches": launches, "launches_interval32": launches32,
           "pods_per_s": res["pods_per_s"],
           "quality_seconds": res["quality_seconds"],
           "seconds": res["seconds"],
           "pods_per_s_interval32": res32["pods_per_s"],
           "seconds_interval32": res32["seconds"],
           "quality_seconds_interval32": res32["quality_seconds"],
           "quality_share_interval32":
               res32["quality_seconds"] / res32["seconds"],
           "regret": q["regret"], "regret_samples": q["regret_samples"],
           "margin": q["margin"], "feasible": q["feasible"],
           "gc_full": res["gc_full"], "gc_full_interval32": res32["gc_full"]}
    print(f"[{label}] interval 1: pods_per_s {res['pods_per_s']:.1f} "
          f"seconds {res['seconds']:.3f} quality_seconds "
          f"{res['quality_seconds']:.4f} | bindings, order, {len(got['top_nodes'])} "
          f"pods' top-3 leaves over {len(got['cycle_pods'])} cycles and "
          f"{len(got['regret_cycle'])} regret samples "
          f"({', '.join(REGRET_KEYS)}) equal to the JAX Scheduler's | last "
          f"regret {q['regret']} | margin {q['margin']} feasible "
          f"{q['feasible']} | K3 launches {launches['select_topk']} (B=1 "
          f"{launches['select_topk_b1']}) K4 {launches['binpack_ffd']} K1 "
          f"{launches['select_hosts']} | interval 32: pods_per_s "
          f"{res32['pods_per_s']:.1f} seconds {res32['seconds']:.3f} "
          f"quality_seconds {res32['quality_seconds']:.4f} share "
          f"{out['quality_share_interval32']:.4f} regret samples "
          f"{q32['regret_samples']} | phase 11 (quality off) pods_per_s "
          f"{live['pods_per_s']:.1f} seconds {live['seconds']:.3f} | full "
          f"collections in the windows {res['gc_full']['collections']}, "
          f"{res32['gc_full']['collections']}", flush=True)
    return out


# f32 operations K5's function needs a row: 4 divides, 4 subtracts, 8
# compares of the free and dominant-share maxima, 4 for the decile, 24
# fold adds, a subtract and a square for the imbalance, 8 compares of the
# masked maxima, and 3 compares a quantile for a linear-time selection
K5_OPS_PER_ROW = 4 + 4 + 8 + 4 + 24 + 2 + 8 + 3 * 3 * 4


def _k5_bound(n: int) -> dict:
    """K5's least time at n rows: the bytes (the four columns of the two
    tables and the mask read once, the 40-word sample written once) over
    the memory rate, or its operations over the f32 rate, the larger."""
    from kubernetes_tpu_torch.kernels import k1_bench

    bytes_ms = (n * (2 * 4 * 4 + 1) + 40 * 4) / k1_bench.HBM_BYTES_PER_S * 1e3
    ops_ms = n * K5_OPS_PER_ROW / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _k5_fields(buf: torch.Tensor) -> dict:
    from kubernetes_tpu_torch.ops.analytics import PACKED_LAYOUT

    return {name: buf[off:off + (int(np.prod(shape)) if shape else 1)]
            for name, off, shape, _ in PACKED_LAYOUT}


def phase_k5() -> dict:
    """K5 (cluster_analytics) against its plain twin, computed on the CPU
    from the same inputs, bit for bit, on every case of
    kernels/k5_cases.py; then its times at the live cell's shape (N 6,144,
    R 8) with L2 cold and warm, beside its bound, its twin's time on the
    card, an empty launch and its launch floor (the empty launch times
    K5's stream operations in one call, counted in a child process)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k5_cases
    from kubernetes_tpu_torch.ops.analytics import (
        PACKED_LAYOUT,
        cluster_analytics_plain,
        pack,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    names = []
    for name, c in k5_cases.cases():
        host = [torch.from_numpy(np.ascontiguousarray(x)) for x in c]
        got = kernels.cluster_analytics(*(t.to(dev) for t in host)).cpu()
        want = pack(cluster_analytics_plain(*host))
        g, w = _k5_fields(got), _k5_fields(want)
        for fname, _, _, dtype in PACKED_LAYOUT:
            if dtype == torch.float32:
                max_err = max(max_err, _abs_err(
                    g[fname].view(torch.float32),
                    w[fname].view(torch.float32)))
        if not torch.equal(got, want):
            bad = [f for f in g if not torch.equal(g[f], w[f])]
            f = bad[0]
            dt = dict((n, d) for n, _, _, d in PACKED_LAYOUT)[f]
            view = (lambda x: x.view(torch.float32)) if dt == torch.float32 \
                else (lambda x: x)
            fail(f"K5: {bad} differ from the twin on case {name} "
                 f"(N {c[0].shape[0]}): {f} kernel {view(g[f]).tolist()} "
                 f"twin {view(w[f]).tolist()}")
        names.append(name)
    check(names[-2:] == [f"wide-{n}" for n in k5_cases.WIDE_N],
          "K5: the multi-block cases are not the last")
    full = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in k5_cases.full_width_case()]
    N = int(full[0].shape[0])
    k5 = lambda: kernels.cluster_analytics(*full)          # noqa: E731
    out = {"ms": k1_bench.time_ms(k5, cold=True),
           "ms_warm": k1_bench.time_ms(k5, cold=False),
           "plain_ms": k1_bench.time_ms(
               lambda: cluster_analytics_plain(*full), reps=20),
           "empty_launch_ms": k1_bench.time_ms(kernels.noop_launch,
                                               cold=False),
           "max_abs_err": max_err, "cases": len(names),
           "shape": {"N": N, "R": int(full[0].shape[1]),
                     "valid": int(full[2].sum())},
           **_k5_bound(N)}
    ops = _child_stream_ops(_K5_OPS_CHILD, "K5", "cuda")
    out["stream_ops"] = sum(ops.values())
    check(out["stream_ops"] == 1 and all("k5_" in n for n in ops),
          f"K5: one call put {ops} on the stream, not one k5_ kernel")
    out["launch_floor_ms"] = out["empty_launch_ms"] * out["stream_ops"]
    out["over_floor"] = out["ms"] / out["launch_floor_ms"]
    # past the one-launch width: the multi-block sequence
    out["wide"] = []
    cs = dict(k5_cases.cases())
    for n in k5_cases.WIDE_N:
        w = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in cs[f"wide-{n}"]]
        out["wide"].append({
            "N": n,
            "ms": k1_bench.time_ms(lambda: kernels.cluster_analytics(*w),
                                   cold=True),
            "ms_warm": k1_bench.time_ms(
                lambda: kernels.cluster_analytics(*w), cold=False),
            "plain_ms": k1_bench.time_ms(
                lambda: cluster_analytics_plain(*w), reps=20),
            **_k5_bound(n)})
    print(f"[K5] bit-identical to the twin on {len(names)} cases "
          f"({' '.join(names)}) | at {out['shape']}: cold_ms "
          f"{out['ms']:.4f} warm_ms {out['ms_warm']:.4f} plain_ms (twin on "
          f"the card) {out['plain_ms']:.4f} bound_ms {out['bound_ms']:.6f} "
          f"({out['bound_by']}: bytes {out['bytes_ms']:.6f}, operations "
          f"{out['ops_ms']:.6f}) | stream_ops {out['stream_ops']} "
          f"empty_launch_ms {out['empty_launch_ms']:.4f} launch_floor_ms "
          f"{out['launch_floor_ms']:.4f} cold_over_floor "
          f"{out['over_floor']:.2f} | "
          + " | ".join(f"N={w['N']} (multi-block): cold_ms {w['ms']:.4f} "
                       f"warm_ms {w['ms_warm']:.4f} plain_ms "
                       f"{w['plain_ms']:.4f} bound_ms {w['bound_ms']:.6f}"
                       for w in out["wide"]), flush=True)
    return out


def phase_live_default(nodes, live: dict) -> dict:
    """The live cell through the port's Scheduler at the reference's
    default SchedulerConfig with only cpu_fallback turned off (telemetry
    at interval 1, the timeline, quality_top_k=3 at interval 32), launch
    counts reset just before and read just after: bindings, telemetry
    samples, drift state and quality record equal to
    tests/data/torch_port_golden_live_default.npz; every sample from the
    device, none dropped, K5 once per committed cycle; pods/s beside phase
    11's and the telemetry and timeline hooks' shares of the window."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import (
        quality_arrays,
        run_live,
        telemetry_arrays,
    )

    label = "15 live default"
    kernels.reset_launch_counts()
    res = run_live(nodes, PODS, BATCH, device="cuda", quality_top_k=3,
                   telemetry=True, timeline=True)
    launches = dict(kernels.LAUNCHES)
    sched = res["scheduler"]
    tel = res["telemetry"]
    data = np.load(golden("live_default"))
    diff = np.nonzero(data["hosts"] != res["hosts"])[0]
    check(diff.size == 0, f"{label}: {diff.size} pods bound apart from the "
          f"JAX Scheduler; first pod index {diff[:1].tolist()}")
    check(np.array_equal(data["bind_order"], res["bind_order"]),
          f"{label}: the binder was called in another order than JAX's")
    got = {**telemetry_arrays(res["telemetry_record"]),
           **quality_arrays(res["quality_record"])}
    for key, val in got.items():
        want = data[key]
        check(_same(want, val), f"{label}: {key} differs from the JAX "
              f"Scheduler's: JAX {want.reshape(-1)[:6].tolist()} port "
              f"{val.reshape(-1)[:6].tolist()}")
    n_samples = len(got["sample_cycle"])
    check(bool(np.all(got["sample_source"] == "device")),
          f"{label}: samples from {set(got['sample_source'].tolist())}, "
          f"not all from the device")
    check(tel["samples_dropped"] == 0,
          f"{label}: {tel['samples_dropped']} telemetry samples dropped")
    check(res["quality"]["regret_dropped"] == 0,
          f"{label}: {res['quality']['regret_dropped']} regret samples "
          f"dropped")
    cycles = sched.telemetry.cycles_total
    check(launches["cluster_analytics"] == cycles == n_samples,
          f"{label}: {launches['cluster_analytics']} K5 launches for "
          f"{cycles} committed cycles and {n_samples} samples")
    for k in ("select_hosts", "select_topk", "binpack_ffd"):
        check(launches[k] > 0, f"{label}: {k} launched no time")
    tl = res["timeline"]
    out = {"launches": launches, "pods_per_s": res["pods_per_s"],
           "seconds": res["seconds"], "cycles": cycles,
           "samples": n_samples,
           "telemetry_seconds": res["telemetry_seconds"],
           "telemetry_share": res["telemetry_seconds"] / res["seconds"],
           "timeline_seconds": res["timeline_seconds"],
           "timeline_share": res["timeline_seconds"] / res["seconds"],
           "quality_seconds": res["quality_seconds"],
           "timeline": tl, "compile": tel["compile"], "hbm": tel["hbm"],
           "gc_full": res["gc_full"]}
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} seconds "
          f"{res['seconds']:.3f} | bindings, order, {n_samples} telemetry "
          f"samples (cycle, analytics; all from the device, 0 dropped), "
          f"drift state after {len(got['drift_fast'])} cycles, "
          f"{len(got['cycle_pods'])} cycles of top-3 leaves and "
          f"{len(got['regret_cycle'])} regret samples equal to the JAX "
          f"Scheduler's | K5 launches {launches['cluster_analytics']} for "
          f"{cycles} committed cycles, K1 {launches['select_hosts']} K3 "
          f"{launches['select_topk']} K4 {launches['binpack_ffd']} | "
          f"telemetry_seconds {res['telemetry_seconds']:.4f} share "
          f"{out['telemetry_share']:.4f} | timeline_seconds "
          f"{res['timeline_seconds']:.4f} share {out['timeline_share']:.4f} "
          f"samples {tl['samples']} series {tl['series']} anomalies "
          f"{tl['anomalies']} | quality_seconds "
          f"{res['quality_seconds']:.4f} | last analytics cpu mean "
          f"{tel['analytics']['utilization']['cpu']['mean']} fragmentation "
          f"{tel['analytics']['fragmentation']} | kernel library "
          f"{tel['compile']} | hbm {tel['hbm']} | phase 11 pods_per_s "
          f"{live['pods_per_s']:.1f} seconds {live['seconds']:.3f} | full "
          f"collections in the window {res['gc_full']['collections']}",
          flush=True)
    return out


def _k6_bound(N: int, G: int, B: int, S: int) -> dict:
    """K6's least time: gc read once and the new counts written once
    (N * G f32 each), the window's hosts and slots read once, over the
    memory rate; its B * S adds over the f32 rate."""
    from kubernetes_tpu_torch.kernels import k1_bench

    bytes_ms = (2 * N * G * 4 + B * 4 + B * S * 5) / k1_bench.HBM_BYTES_PER_S \
        * 1e3
    ops_ms = B * S / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_k6() -> dict:
    """K6 (commit_group_counts) against its plain twin on the card, bit for
    bit, on every case of kernels/k6_cases.py, gc left unwritten; then its
    times at the live cell's shape (N 6,144, G 32, B 2,048) with L2 cold
    and warm, beside its bytes bound, an empty launch, its twin's and one
    index_add of the placed pods' group one-hots into gc (the library
    call that computes the same function)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k6_cases
    from kubernetes_tpu_torch.models.megacycle import (
        commit_group_counts_plain,
    )

    dev = torch.device("cuda")
    max_err = 0.0
    names = []
    for name, c in k6_cases.cases():
        gc, hosts, gids, gvalid = (
            torch.from_numpy(c[k]).to(dev)
            for k in ("gc", "hosts", "group_ids", "group_valid"))
        keep = gc.clone()
        got = kernels.commit_group_counts(gc, hosts, gids, gvalid)
        want = commit_group_counts_plain(gc, hosts, gids, gvalid)
        torch.cuda.synchronize()
        max_err = max(max_err, _abs_err(got, want))
        if not _bits_equal(got, want):
            bad = torch.nonzero(got != want)
            r, g = (int(x) for x in bad[0])
            fail(f"K6: differs from the twin on case {name} at [{r}, {g}]: "
                 f"kernel {float(got[r, g])} twin {float(want[r, g])}")
        check(_bits_equal(gc, keep), f"K6: case {name} wrote into gc")
        names.append(name)
    check(names[-1] == "live", "K6: the last case is not the live shape")
    N, G = gc.shape
    B, S = gids.shape
    acc = hosts >= 0
    onehot = ((gids[:, :, None] == torch.arange(G, device=dev)[None, None])
              & gvalid[..., None]).to(torch.float32).sum(dim=1)
    rows, adds = hosts[acc].to(torch.int64), onehot[acc]
    k6 = lambda: kernels.commit_group_counts(gc, hosts, gids,   # noqa: E731
                                             gvalid)
    lib = lambda: gc.index_add(0, rows, adds)                   # noqa: E731
    check(_bits_equal(lib(), k6()), "K6: index_add gives other counts")
    out = {"ms": k1_bench.time_ms(k6, cold=True),
           "ms_warm": k1_bench.time_ms(k6, cold=False),
           "plain_ms": k1_bench.time_ms(
               lambda: commit_group_counts_plain(gc, hosts, gids, gvalid)),
           "library_ms": k1_bench.time_ms(lib, cold=True),
           "library_ms_warm": k1_bench.time_ms(lib, cold=False),
           "empty_launch_ms": k1_bench.time_ms(kernels.noop_launch,
                                               cold=False),
           "max_abs_err": max_err, "cases": len(names),
           "shape": {"N": int(N), "G": int(G), "B": int(B), "S": int(S)},
           **_k6_bound(N, G, B, S)}
    out["over_floor"] = out["ms"] / out["empty_launch_ms"]
    print(f"[K6] bit-identical to the twin on {len(names)} cases, gc never "
          f"written | at {out['shape']}: cold_ms {out['ms']:.4f} warm_ms "
          f"{out['ms_warm']:.4f} plain_ms (twin on the card) "
          f"{out['plain_ms']:.4f} index_add_cold_ms {out['library_ms']:.4f} "
          f"index_add_warm_ms {out['library_ms_warm']:.4f} "
          f"bound_ms {out['bound_ms']:.6f} ({out['bound_by']}) | "
          f"empty_launch_ms {out['empty_launch_ms']:.4f} cold_over_empty "
          f"{out['over_floor']:.2f}", flush=True)
    return out


MEGA_KS = (1, 4)


def phase_megacycle(nodes, live: dict) -> dict:
    """The megacycle cell: loop.run_megacycle (bench.py run_megacycle's
    loop) at 5,000 nodes x 10,000 pods, batch 2,048, K in MEGA_KS, each
    through a fresh Scheduler at the reference's default config with only
    cpu_fallback off; kernel launches counted in each timed window.
    K = 4's bindings and order equal K = 1's and
    tests/data/torch_port_golden_live_megacycle.npz, the JAX Scheduler's,
    and so do every window's top-k leaves, the regret samples and every
    telemetry sample; at least one megacycle and one K6 launch in the
    timed window; nothing dropped.  Prints pods/s and host seconds a pod
    for each K (read, not judged)."""
    from kubernetes_tpu_torch.loop import (
        quality_arrays,
        run_megacycle,
        telemetry_arrays,
    )

    label = "16 megacycle"
    res = run_megacycle(nodes, PODS, BATCH, ks=MEGA_KS, device="cuda")
    check(res["identical"], f"{label}: K = 4 placed apart from K = 1")
    curve = {c["k"]: c for c in res["curve"]}
    for K, run in res["runs"].items():
        check(run["quality"]["regret_dropped"] == 0,
              f"{label}: K={K}: {run['quality']['regret_dropped']} regret "
              f"samples dropped")
        check(run["telemetry"]["samples_dropped"] == 0,
              f"{label}: K={K}: {run['telemetry']['samples_dropped']} "
              f"telemetry samples dropped")
    K = max(MEGA_KS)
    run, c4 = res["runs"][K], curve[K]
    check(c4["megacycles"] >= 1, f"{label}: no megacycle in the timed window")
    check(c4["launches"]["commit_group_counts"] >= 1,
          f"{label}: K6 launched no time in the timed window")
    check(curve[1]["megacycles"] == 0
          and curve[1]["launches"]["commit_group_counts"] == 0,
          f"{label}: K = 1 ran a megacycle")
    data = np.load(golden("live_megacycle"))
    check(int(data["k"]) == K, f"{label}: the golden is for K={data['k']}")
    diff = np.nonzero(data["hosts"] != run["hosts"])[0]
    check(diff.size == 0, f"{label}: {diff.size} pods bound apart from the "
          f"JAX Scheduler; first pod index {diff[:1].tolist()}")
    check(np.array_equal(data["bind_order"], run["bind_order"]),
          f"{label}: the binder was called in another order than JAX's")
    got = {**telemetry_arrays(run["telemetry_record"]),
           **quality_arrays(run["quality_record"])}
    for key, val in got.items():
        want = data[key]
        check(_same(want, val), f"{label}: {key} differs from the JAX "
              f"Scheduler's: JAX {want.reshape(-1)[:6].tolist()} port "
              f"{val.reshape(-1)[:6].tolist()}")
    check(run["scheduler"].megacycles_total == int(data["megacycles"]),
          f"{label}: {run['scheduler'].megacycles_total} megacycles, the "
          f"JAX Scheduler {int(data['megacycles'])}")
    print(f"[{label}] K={K}: bindings, order, {len(got['sample_cycle'])} "
          f"telemetry samples, {len(got['cycle_pods'])} windows of top-3 "
          f"leaves and {len(got['regret_cycle'])} regret samples equal to "
          f"the JAX Scheduler's and K = 1's; 0 dropped | "
          + " | ".join(
              f"K={c['k']}: pods_per_s {c['pods_per_s']:.1f} seconds "
              f"{c['seconds']:.3f} host_s_per_pod {c['host_s_per_pod']:.3e} "
              f"host_seconds {c['host_seconds']:.4f} megacycles "
              f"{c['megacycles']} K6 {c['launches']['commit_group_counts']} "
              f"K1 {c['launches']['select_hosts']} K3 "
              f"{c['launches']['select_topk']} K4 "
              f"{c['launches']['binpack_ffd']} K5 "
              f"{c['launches']['cluster_analytics']}"
              for c in res["curve"])
          + f" | phases K={K} "
          + " ".join(f"{k} {v:.4f}" for k, v in run["phases"].items())
          + f" | phase 11 pods_per_s {live['pods_per_s']:.1f}", flush=True)
    return {"curve": res["curve"], "launches": c4["launches"]}


def phase_wide_columns(label: str = "17 R=32 quality") -> dict:
    """The live quality cell with 13 extended resource names on every node
    (R = 32 columns), a regret sample every cycle, launch counts reset
    just before and read just after: K4 launched once a sample, none
    dropped, every sample equal to the regret twin's on the same inputs
    (each side launch's inputs kept and the counterfactual run again on
    the card with K4's plain twin in the kernel's place)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.loop import bench_nodes, run_live
    from kubernetes_tpu_torch.models.binpack import binpack_ffd_plain
    from kubernetes_tpu_torch.runtime import quality as quality_mod

    orig = quality_mod._ffd_counterfactual
    seen = []

    def recorded(*args):
        outs = orig(*args)
        seen.append((args, torch.stack([o.reshape(()) for o in outs])))
        return outs

    quality_mod._ffd_counterfactual = recorded
    try:
        kernels.reset_launch_counts()
        res = run_live(bench_nodes(NODES, extended=13), PODS, BATCH,
                       device="cuda", quality_top_k=3,
                       quality_interval_cycles=1)
        launches = dict(kernels.LAUNCHES)
    finally:
        quality_mod._ffd_counterfactual = orig
    R = res["scheduler"].cache.encoder.dims.R
    q = res["quality"]
    check(R == 32, f"{label}: the encoder's resource axis is {R}, not 32")
    check(q["regret_dropped"] == 0,
          f"{label}: {q['regret_dropped']} regret samples dropped")
    check(launches["binpack_ffd"] == len(seen) == q["regret_samples"] > 0,
          f"{label}: {launches['binpack_ffd']} K4 launches, {len(seen)} "
          f"side launches, {q['regret_samples']} regret samples")
    kernel = quality_mod.binpack_ffd
    quality_mod.binpack_ffd = binpack_ffd_plain
    try:
        for k, (args, got) in enumerate(seen):
            want = torch.stack([o.reshape(()) for o in orig(*args)])
            check(torch.equal(got, want), f"{label}: side launch {k}: "
                  f"kernel {got.tolist()} twin {want.tolist()}")
    finally:
        quality_mod.binpack_ffd = kernel
    check((res["hosts"] >= 0).all(), f"{label}: a pod went unbound")
    print(f"[{label}] R {R}: {len(seen)} regret samples (nodes, placed, "
          f"pods) equal to the twin's on the same inputs, 0 dropped, K4 "
          f"launches {launches['binpack_ffd']} | pods_per_s "
          f"{res['pods_per_s']:.1f} seconds {res['seconds']:.3f} | last "
          f"regret {q['regret']}", flush=True)
    return {"launches": launches, "samples": len(seen), "R": R}


def _k7_bound(B: int, K: int, N: int) -> dict:
    """K7's least time: the stack read once (B * K * N bytes), mask and
    failure written once (5 * B * N) and the two valid masks read once,
    over the memory rate; one compare a stack element over the f32
    rate."""
    from kubernetes_tpu_torch.kernels import k1_bench

    bytes_ms = (B * K * N + 5 * B * N + B + N) / k1_bench.HBM_BYTES_PER_S \
        * 1e3
    ops_ms = B * K * N / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def phase_k7() -> dict:
    """K7 (fold_predicates) against its plain twin on the card, bit for
    bit, on every case of kernels/k7_cases.py; then its times at the
    extender's shape [1, 23, 6,144] and the attribution shape [2,048, 23,
    6,144] with L2 cold and warm, beside its bytes bound, an empty launch,
    its twin's time and torch.all's (the mask half alone)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench, k7_cases
    from kubernetes_tpu_torch.ops.predicates import fold_predicates_plain

    dev = torch.device("cuda")
    names, inputs = [], {}
    for name, c in k7_cases.cases():
        args = [torch.from_numpy(c[k]).to(dev)
                for k in ("per_pred", "valid", "pod_valid")]
        got = kernels.fold_predicates(*args)
        want = fold_predicates_plain(*args)
        torch.cuda.synchronize()
        for what, g, w in (("mask", got[0], want[0]),
                           ("failure", got[1], want[1])):
            if not torch.equal(g, w):
                b, n = (int(x) for x in torch.nonzero(g != w)[0])
                fail(f"K7: {what} differs from the twin on case {name} at "
                     f"[{b}, {n}]: kernel {g[b, n].item()} twin "
                     f"{w[b, n].item()}")
        if name in ("extender", "attribution"):
            inputs[name] = args
        names.append(name)
        del args, got, want
    check(names[-2:] == ["extender", "attribution"],
          "K7: the extender and attribution shapes are not the last cases")
    empty = k1_bench.time_ms(kernels.noop_launch, cold=False)
    shapes = {}
    for name, args in inputs.items():
        B, K, N = (int(x) for x in args[0].shape)
        k7 = lambda: kernels.fold_predicates(*args)             # noqa: E731
        shapes[name] = {
            "B": B, "K": K, "N": N,
            "ms": k1_bench.time_ms(k7, cold=True),
            "ms_warm": k1_bench.time_ms(k7, cold=False),
            "plain_ms": k1_bench.time_ms(
                lambda: fold_predicates_plain(*args)),
            "all_ms": k1_bench.time_ms(lambda: torch.all(args[0], dim=1)),
            **_k7_bound(B, K, N)}
    main = shapes["extender"]
    out = {"ms": main["ms"], "ms_warm": main["ms_warm"],
           "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
           "bound_by": main["bound_by"], "empty_launch_ms": empty,
           "max_abs_err": 0.0, "cases": len(names),
           "shape": {k: main[k] for k in ("B", "K", "N")}, "shapes": shapes}
    att = shapes["attribution"]
    print(f"[K7] bit-identical to the twin on {len(names)} cases | "
          + " | ".join(
              f"[{d['B']}, {d['K']}, {d['N']}]: cold_ms {d['ms']:.4f} "
              f"warm_ms {d['ms_warm']:.4f} plain_ms (twin on the card) "
              f"{d['plain_ms']:.4f} torch.all_ms {d['all_ms']:.4f} "
              f"bound_ms {d['bound_ms']:.6f} ({d['bound_by']})"
              for d in shapes.values())
          + f" | empty_launch_ms {empty:.4f} extender cold_over_empty "
          f"{main['ms'] / empty:.2f} attribution share of bound "
          f"{att['bound_ms'] / att['ms']:.3f}", flush=True)
    return out


def _bench_batches(sizes=(1, 2048)) -> dict:
    """{B: (cluster, pods, unsched key, zone key)} on the card: the bench
    fleet (NODES nodes, padded to 6,144 rows, 20 spread selectors, 1 node
    in 50 tainted) and its first B pending pods, as the engines and the
    sidecar see them; and under "pod-anti-affinity" / "pod-affinity" the
    first 2,048 pods of those workloads on the same fleet (with
    EXISTING_ANTI running pods for the first), a batch that is not lean in
    the pair products (K11's hits and K12's IPA sums)."""
    from kubernetes_tpu_torch.codec.schema import cluster_to_torch, pods_to_torch
    from kubernetes_tpu_torch.loop import bench_nodes, build_encoder, pending_pod

    nodes = bench_nodes(NODES)
    out = {}
    for workload, existing, sizes_w in (
            ("plain", 0, sizes), ("pod-anti-affinity", EXISTING_ANTI, (2048,)),
            ("pod-affinity", 0, (2048,))):
        enc = build_encoder(nodes, existing)
        pods = [pending_pod(i, workload) for i in range(max(sizes_w))]
        ct = cluster_to_torch(enc.snapshot(), "cuda")
        key = enc.interner.intern("node.kubernetes.io/unschedulable")
        for B in sizes_w:
            out[B if workload == "plain" else workload] = (
                ct, pods_to_torch(enc.encode_pods(pods[:B]), "cuda"), key,
                enc.getzone_key)
    return out


def _arg_bytes(specs, ct, pb, keep=None) -> int:
    """Bytes of the snapshot's and the batch's fields a kernel binds
    (kernels._K11_ARGS / _K12_ARGS), each read once; `keep`: None, or the
    struct fields that are read (a lean batch leaves some unbound, a row
    that is off reads none of its own)."""
    total = 0
    for field, owner, attr, _, _ in specs:
        if keep is None or field in keep:
            t = getattr(ct if owner == "c" else pb, attr)
            total += t.numel() * t.element_size()
    return total


def _count(x) -> torch.Tensor:
    """Per row: the number of true (or non-PAD) entries of x [rows, ...],
    as f64."""
    from kubernetes_tpu_torch.codec.schema import PAD

    if x.dtype != torch.bool:
        x = x != PAD
    return x.reshape(x.shape[0], -1).sum(1, dtype=torch.float64)


def _pairs(pod=0.0, node=0.0, pod_x=0.0, node_x=None):
    """A per-pair operation count, pod[b] + node[n] + pod_x[b] * node_x[n]
    (each a scalar or a f64 vector), kept in factors."""
    return (pod, node, pod_x, node_x)


def _dot(x, v: torch.Tensor) -> float:
    return (float((x * v).sum()) if isinstance(x, torch.Tensor)
            else float(x) * float(v.sum()))


def _charge(cost, alive: torch.Tensor) -> float:
    """The sum of a _pairs count over the pairs where alive bool[B, N]."""
    pod, node, pod_x, node_x = cost
    a = alive.double()
    total = _dot(pod, a.sum(1)) + _dot(node, a.sum(0))
    if node_x is not None:
        total += _dot(pod_x, a @ node_x)
    return total


# K11's walk over the predicates (filter_pass.cu eval_node), by
# PREDICATE_ORDER index: the node-only flags, the resource and volume
# rows, ports, disks, taints, the label rows, the selector, the
# GeneralPredicates fold and the pair rows
K11_WALK = (0, 19, 20, 21, 1, 3, 6, 12, 13, 14, 15, 16, 17, 18, 4, 7, 8, 9,
            10, 11, 5, 2, 22)


def _k11_costs(ct, pb, cfg, offsets) -> dict:
    """{PREDICATE_ORDER index: (int32 operations, f32 operations), each a
    _pairs count}: what K11 does for each (pod, node) pair at that
    predicate on these inputs, counting only the entries that hold
    something: the pod's valid selector keys and required expressions
    against the node's label slots in use, its valid ports against the
    node's used ports, its disk ids against the node's, its valid
    tolerations against the node's NoSchedule / NoExecute taints, its
    nonzero requests and volume counts, its valid pair terms (one hit
    compare each); one operation for a predicate's verdict.  The
    GeneralPredicates parts (host, resources, ports, selector) are charged
    where they are computed, once."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import PAD

    B, N = pb.n_pods, ct.n_nodes
    P = _pairs
    labels_n = _count(ct.label_keys)
    enabled, _, presence, svc = kernels._filter_config(
        cfg, ct.vol_counts.shape[1])
    on = lambda k: (enabled >> k) & 1                       # noqa: E731
    zero = P()
    costs = {k: (P(pod=1.0), zero) for k in (0, 20, 21)}
    costs[19] = (P(pod=2.0), zero)
    costs[1] = (P(pod=2.0), zero)
    costs[3] = (P(pod=2.0), zero)
    R = ct.allocatable.shape[1]
    costs[6] = (P(pod=1.0), P(pod=R + 2 * _count(pb.req > 0)))
    overlap = 2.0 if pb.vol_overlap.shape[-1] == N else 0.0

    def vol(cols):
        f = sum(1.0 + overlap + 3.0 * (pb.new_vol_counts[:, c] > 0).double()
                for c in cols)
        return P(pod=1.0), P(pod=f)

    VT = ct.vol_counts.shape[1]
    for k, cols in ((12, [0]), (13, [1]), (14, [2] + list(range(5, VT))),
                    (15, [3]), (16, [4])):
        costs[k] = vol(cols)
    for k, name, valid in ((17, "vb", pb.vol_bind_valid),
                           (18, "vz", pb.vol_zone_valid)):
        hits = _count(valid) if offsets.get(name, -1) >= 0 else 0.0
        costs[k] = (P(pod=2.0 if k == 17 else 1.0), P(pod=hits))
    costs[4] = (P(pod=1.0, pod_x=5.0 * _count(pb.port_valid),
                  node_x=_count(ct.port_used)), zero)
    costs[7] = (P(pod=1.0, pod_x=_count(pb.disk_vol_ids),
                  node_x=_count(ct.disk_vol_ids)), zero)
    taints = ((ct.taint_effect == 0) | (ct.taint_effect == 2)).sum(
        1, dtype=torch.float64)
    costs[8] = (P(pod=1.0, node=taints,
                  pod_x=4.0 * _count(pb.tol_valid), node_x=taints), zero)
    costs[9] = (P(pod=1.0), zero)
    costs[10] = (P(pod=1.0, pod_x=float(len(presence)), node_x=labels_n),
                 zero)
    lookups = 0.0
    for j in range(len(svc)):
        lookups = lookups + 1.0 + ((pb.svc_aff_fixed[:, j] == PAD)
                                   & (pb.svc_aff_d0 >= 0)).double()
    costs[11] = (P(pod=1.0, pod_x=lookups, node_x=labels_n), zero)
    req_aff = pb.has_req_affinity.double()
    exprs = pb.expr_valid & pb.term_valid[:, :, None]
    lookups = _count(pb.ns_valid) + req_aff * _count(exprs)
    vals = (_count(pb.ns_valid) + req_aff * (
        _count(pb.term_valid)
        + (pb.expr_nval * exprs).reshape(B, -1).sum(1, dtype=torch.float64)))
    costs[5] = (P(pod=1.0 + vals, pod_x=lookups, node_x=labels_n), zero)
    costs[2] = (P(pod=4.0), zero)
    if offsets.get("aff", -1) >= 0:
        costs[22] = (P(pod=1.0), P(pod=1.0 + _count(pb.anti_term_valid)
                                   + 2.0 * _count(pb.aff_term_valid)))
    else:
        costs[22] = (P(pod=1.0), zero)
    if not on(8) and on(9):
        costs[9] = costs[8]               # the taint walk is NoExecute's
    # a GeneralPredicates part is computed when its own row or General's
    # is on
    general = bool(on(2))
    return {k: c for k, c in costs.items()
            if on(k) or (general and k in (3, 4, 5, 6))}


def _k11_bound(ct, pb, cfg, stack: bool, stack_rows=None) -> dict:
    """K11's least time on these inputs: the fields it binds and the hits
    rows read once, the output written once (1 byte a pair, 23 with the
    stack), over the memory rate; against its operations (_k11_costs),
    the int32 compares over the int32 rate and the f32 ones over the f32
    rate, the two pipes side by side.  Stack mode evaluates every pair;
    mask mode skips a pair whose node or pod is padding and stops a
    pair's walk at its first failing predicate (from stack_rows, the
    twin's stack of these inputs)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench
    from kubernetes_tpu_torch.ops.predicates import pair_hits

    B, N = pb.n_pods, ct.n_nodes
    hits, offsets = pair_hits(ct, pb)
    costs = _k11_costs(ct, pb, cfg, offsets)
    alive = (torch.ones((B, N), dtype=torch.bool, device=ct.valid.device)
             if stack else pb.valid[:, None] & ct.valid[None])
    int_ops = f32_ops = 0.0
    for k in K11_WALK:
        if k in costs:
            int_ops += _charge(costs[k][0], alive)
            f32_ops += _charge(costs[k][1], alive)
        if not stack:
            # the walk stops at the first failure (a disabled row reads
            # all true)
            alive = alive & stack_rows[:, k]
    skip = () if pb.vol_overlap.shape[-1] == N else ("vol_overlap",)
    keep = {s[0] for s in kernels._K11_ARGS} - set(skip)
    in_bytes = _arg_bytes(kernels._K11_ARGS, ct, pb, keep)
    if hits is not None:
        in_bytes += hits.numel() * 4
    out = B * N * (23 if stack else 1)
    bytes_ms = (in_bytes + out) / k1_bench.HBM_BYTES_PER_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "int_ops": int_ops, "f32_ops": f32_ops,
            "ops_per_pair": (int_ops + f32_ops) / (B * N),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


# the struct fields K12 reads for a priority row beyond those every row
# reads (allocatable, node_nonzero, pod_nonzero), by PRIORITY_ORDER index
K12_ROW_FIELDS = {
    0: ("group_counts", "group_ids", "group_valid", "spread_counts"),
    1: ("valid",),
    4: ("avoid_owner", "owner_uid"),
    5: ("label_keys", "label_vals", "label_nums", "node_name_id",
        "pref_weight", "pref_term_valid", "pref_expr_key", "pref_expr_op",
        "pref_expr_vals", "pref_expr_nval", "pref_expr_num",
        "pref_expr_valid"),
    6: ("taint_key", "taint_val", "taint_effect", "tol_key", "tol_op",
        "tol_val", "tol_effect", "tol_valid"),
    7: ("image_id", "image_size", "image_ids"),
    9: ("label_keys",),
    11: ("limits2",),
}


def _k12_bound(ct, pb, weights, all_rows: bool, need_per: bool, zone_key,
               score_cfg=None) -> dict:
    """K12's least time on these inputs for the rows this call computes
    (every row with all_rows, else the nonzero weights'): the fields those
    rows read, the IPA sums when the batch has them, the zone index's reads
    (the pair keys, and each node's zone-pair columns up to its zone pair)
    and the total (with need_per the 12 rows too) written once, over the
    memory rate; against its operations, counting only the entries that hold something (the pod's
    valid preferred terms and expressions against the node's label slots
    in use, its valid tolerations against the node's PreferNoSchedule
    taints, its images against the node's, the node's avoid slots, its
    spread groups), the int32 compares over the int32 rate and the f32
    operations over the f32 rate, the two pipes side by side."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import ScoreConfig
    from kubernetes_tpu_torch.kernels import k1_bench

    score_cfg = score_cfg or ScoreConfig()
    B, N = pb.n_pods, ct.n_nodes
    P = _pairs
    w = np.asarray(weights, np.float32)
    rows = [k for k in range(12) if all_rows or w[k] != 0.0]
    labels_n = _count(ct.label_keys)
    ipa = ct.topo_pairs.shape[1] == pb.pref_pair_weights.shape[-1] and 1 in rows
    lean_spread = pb.spread_counts.shape[-1] != N
    ints, f32s = [P()], [P(pod=2.0 + 2.0 * sum(w[k] != 0.0 for k in rows))]
    if 0 in rows:
        groups = _count(pb.group_valid) if lean_spread else 0.0
        ints.append(P(pod=2.0 * groups if lean_spread else 0.0))
        f32s.append(P(pod=groups + 14.0))
    if ipa:
        f32s.append(P(node=7.0 * ct.valid.double()))
    if 2 in rows or 8 in rows:
        f32s.append(P(pod=4.0 + 12.0 * (2 in rows) + 10.0 * (8 in rows)))
    if 3 in rows:
        f32s.append(P(pod=13.0))
    if 4 in rows:
        ints.append(P(pod=1.0, node=2.0 * _count(ct.avoid_owner)))
    if 5 in rows and pb.pref_term_valid.shape[1] > 0:
        exprs = pb.pref_expr_valid & pb.pref_term_valid[:, :, None]
        vals = (pb.pref_expr_nval * exprs).reshape(B, -1).sum(
            1, dtype=torch.float64)
        ints.append(P(pod=vals, pod_x=_count(exprs), node_x=labels_n))
        f32s.append(P(pod=_count(pb.pref_term_valid) + 6.0))
    if 6 in rows:
        prefer = (ct.taint_effect == 1).sum(1, dtype=torch.float64)
        ints.append(P(pod=1.0, node=prefer,
                      pod_x=4.0 * _count(pb.tol_valid), node_x=prefer))
        f32s.append(P(pod=7.0, node=prefer))
    if 7 in rows:
        imgs = _count(pb.image_ids)
        ints.append(P(pod_x=2.0 * imgs, node_x=_count(ct.image_id)))
        f32s.append(P(pod=5.0, pod_x=imgs, node_x=_count(ct.image_id)))
    if 9 in rows:
        n_prefs = float(len(score_cfg.label_prefs))
        ints.append(P(node=n_prefs * labels_n))
        f32s.append(P(pod=2.0 * n_prefs))
    if 10 in rows:
        f32s.append(P(pod=2.0 * (10.0 + len(score_cfg.rtc_shape)) + 2.0))
    if 11 in rows:
        f32s.append(P(pod=6.0))
    every = torch.ones((B, N), dtype=torch.bool, device=ct.valid.device)
    int_ops = sum(_charge(x, every) for x in ints)
    f32_ops = sum(_charge(x, every) for x in f32s)
    keep = {"allocatable", "node_nonzero", "pod_nonzero"}
    for k in rows:
        keep |= set(K12_ROW_FIELDS.get(k, ()))
    if lean_spread:
        keep.discard("spread_counts")
    in_bytes = _arg_bytes(kernels._K12_ARGS, ct, pb, keep)
    if ipa:
        in_bytes += B * N * 4
    if 0 in rows:
        # the zone index: the zone pairs' columns, found once from the pair
        # keys, of each node's pair row up to its zone pair; the index
        # written and read back
        is_zone = ct.pair_topo_key == zone_key
        zone = ct.topo_pairs[:, is_zone]
        first = torch.where(zone.any(1), zone.int().argmax(1) + 1,
                            zone.shape[1])
        zone_walk = float(first.sum(dtype=torch.float64))
        int_ops += is_zone.numel() + zone_walk
        in_bytes += zone_walk + is_zone.numel() * 4 + 8 * N
    out = B * N * 4 * (13 if need_per else 1)
    bytes_ms = (in_bytes + out) / k1_bench.HBM_BYTES_PER_S * 1e3
    ops_ms = max(int_ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "int_ops": int_ops, "f32_ops": f32_ops,
            "ops_per_pair": (int_ops + f32_ops) / (B * N),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _case_tensors(case, device="cuda"):
    """A k11_cases / k12_cases case as the port's dataclasses on device."""
    from kubernetes_tpu_torch.codec import schema as ts

    ct = ts.ClusterTensors(**{k: torch.from_numpy(np.array(v))
                              for k, v in case["cluster"].items()})
    pb = ts.PodBatch(**{k: torch.from_numpy(np.array(v))
                        for k, v in case["pods"].items()})
    return ts.cluster_to_torch(ct, device), ts.pods_to_torch(pb, device)


def _k11_against_twin(label, ct, pb, cfg, key, modes=("stack", "mask",
                                                      "need_per mask")):
    """K11 against its twin on one batch: the stack (stack mode), the mask
    (mask mode) and filter_batch's need_per mask (the stack folded by K7),
    bit for bit; fails at the first difference."""
    from kubernetes_tpu_torch.ops import predicates as tp

    want_mask, want_stack = tp.filter_batch_plain(ct, pb, cfg, key)
    runs = {"stack": lambda: tp.predicate_stack(ct, pb, cfg, key),
            "mask": lambda: tp.filter_batch(ct, pb, cfg, key,
                                            need_per=False)[0],
            "need_per mask": lambda: tp.filter_batch(ct, pb, cfg, key)[0]}
    for what in modes:
        g = runs[what]()
        torch.cuda.synchronize()
        w = want_stack if what == "stack" else want_mask
        if not torch.equal(g, w):
            at = [int(x) for x in torch.nonzero(g != w)[0]]
            fail(f"K11: {what} differs from the twin on {label} at {at}: "
                 f"kernel {g[tuple(at)].item()} twin {w[tuple(at)].item()}")
    return want_stack


def _k12_against_twin(label, ct, pb, need_pers=(True, False), **kw):
    """K12 against its twin on one batch: the total and, with need_per,
    every row, bit for bit; fails at the first difference."""
    from kubernetes_tpu_torch.ops import priorities as tpr

    for need_per in need_pers:
        got = tpr.score_batch(ct, pb, need_per=need_per, **kw)
        want = tpr.score_batch_plain(ct, pb, need_per=need_per, **kw)
        torch.cuda.synchronize()
        pairs = [("total", got[0], want[0])]
        if need_per:
            pairs += [(f"row {i}", got[1][:, i], want[1][:, i])
                      for i in range(want[1].shape[1])]
        for what, g, w in pairs:
            if not _bits_equal(g, w):
                b, n = (int(x) for x in torch.nonzero(
                    g.view(torch.int32) != w.view(torch.int32))[0])
                fail(f"K12: {what} (need_per {need_per}) differs from the "
                     f"twin on {label} at [{b}, {n}]: kernel "
                     f"{g[b, n].item()!r} twin {w[b, n].item()!r}")


AFFINITY_WORKLOADS = ("pod-anti-affinity", "pod-affinity")


def phase_k11(bench: dict) -> dict:
    """K11 (filter_pass) against its plain twin on the card, bit for bit,
    on every case of kernels/k11_cases.py and at full width on the bench
    fleet: the plain batch and the pod-anti-affinity and pod-affinity
    batches (pair hits present), each in the default profile and in
    static_pass's (the resource fit out, and MatchInterPodAffinity with
    in-batch affinity); the stack (stack mode), the mask (mask mode) and
    filter_batch's need_per mask (the stack folded by K7).  Then its times
    on the plain batch at [1, 6,144] (stack mode, the sidecar's route) and
    [2,048, 6,144] (mask mode, the engines' route) with L2 cold and warm,
    beside its bound, an empty launch and its twin's time."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import FilterConfig
    from kubernetes_tpu_torch.kernels import k1_bench, k11_cases
    from kubernetes_tpu_torch.models.batched import static_profile
    from kubernetes_tpu_torch.ops import predicates as tp
    from kubernetes_tpu_torch.ops.priorities import DEFAULT_PRIORITY_WEIGHTS

    names = []
    for name, case in k11_cases.cases():
        ct, pb = _case_tensors(case)
        _k11_against_twin(f"case {name}", ct, pb, FilterConfig(**case["cfg"]),
                          case["unsched_key"])
        names.append(name)
    cfg = FilterConfig()
    full = []
    for batch in (2048,) + AFFINITY_WORKLOADS:
        ct, pb, key, _ = bench[batch]
        if batch in AFFINITY_WORKLOADS:
            check(tp.pair_hits(ct, pb)[0] is not None,
                  f"K11: the {batch} batch is lean in the pair products")
        for prof, c in (
                ("default", cfg),
                ("static", static_profile(cfg, DEFAULT_PRIORITY_WEIGHTS)[0]),
                ("static in-batch", static_profile(
                    cfg, DEFAULT_PRIORITY_WEIGHTS, True)[0])):
            _k11_against_twin(f"the bench fleet's {batch} batch, {prof} "
                              f"profile", ct, pb, c, key)
            full.append(f"{batch} {prof}")
    empty = k1_bench.time_ms(kernels.noop_launch, cold=False)
    shapes = {}
    for B, stack in ((1, True), (2048, False)):
        ct, pb, key, _ = bench[B]
        if stack:
            k11 = lambda: tp.predicate_stack(ct, pb, cfg, key)  # noqa: E731
            twin = lambda: tp.predicate_stack_plain(       # noqa: E731
                ct, pb, cfg, key)
        else:
            k11 = lambda: tp.filter_batch(                 # noqa: E731
                ct, pb, cfg, key, need_per=False)[0]
            twin = lambda: tp.filter_batch_plain(          # noqa: E731
                ct, pb, cfg, key, need_per=False)[0]
        rows = tp.predicate_stack_plain(ct, pb, cfg, key)
        shapes[f"b{B}"] = {
            "B": B, "N": ct.n_nodes, "mode": "stack" if stack else "mask",
            "ms": k1_bench.time_ms(k11, cold=True),
            "ms_warm": k1_bench.time_ms(k11, cold=False),
            "plain_ms": k1_bench.time_ms(twin, reps=10),
            **_k11_bound(ct, pb, cfg, stack, rows)}
        del rows
    main = shapes["b2048"]
    out = {**{k: main[k] for k in ("ms", "ms_warm", "plain_ms", "bound_ms",
                                   "bound_by")},
           "empty_launch_ms": empty, "max_abs_err": 0.0, "cases": len(names),
           "full_width": full,
           "shape": {k: main[k] for k in ("B", "N", "mode")},
           "shapes": shapes}
    print(f"[K11] bit-identical to the twin on {len(names)} cases and "
          f"{len(full)} full-width batches ({', '.join(full)}), stack, mask "
          f"and need_per mask | " + " | ".join(
              f"[{d['B']}, {d['N']}] {d['mode']}: cold_ms {d['ms']:.4f} "
              f"warm_ms {d['ms_warm']:.4f} plain_ms (twin on the card) "
              f"{d['plain_ms']:.4f} bound_ms {d['bound_ms']:.6f} "
              f"({d['bound_by']}; bytes_ms {d['bytes_ms']:.6f} ops_ms "
              f"{d['ops_ms']:.6f}: int32 {d['int_ops']:.0f} f32 "
              f"{d['f32_ops']:.0f}, {d['ops_per_pair']:.2f} a pair)"
              for d in shapes.values())
          + f" | empty_launch_ms {empty:.4f}", flush=True)
    return out


def _round_weights(ct, pb, aff: bool) -> np.ndarray:
    """The weights a speculative round scores this batch with: the stock
    ones, IPA zeroed for a batch with pod affinity (aff), SelectorSpread
    zeroed for a spread-lean batch (models/speculative.py)."""
    from kubernetes_tpu_torch.ops.priorities import (DEFAULT_PRIORITY_WEIGHTS,
                                                     PRIO_INDEX)

    w = np.array(DEFAULT_PRIORITY_WEIGHTS, np.float32)
    if aff:
        w[PRIO_INDEX["InterPodAffinityPriority"]] = 0.0
    if pb.spread_counts.shape[-1] != ct.n_nodes:
        w[PRIO_INDEX["SelectorSpreadPriority"]] = 0.0
    return w


def phase_k12(bench: dict) -> dict:
    """K12 (score_pass) against its plain twin on the card, bit for bit,
    on every case of kernels/k12_cases.py and at full width on the bench
    fleet: the plain batch and the pod-anti-affinity and pod-affinity
    batches (IPA sums present), with the stock weights (need_per on and
    off), the round's (skip_zero_weight) and static_pass's (the
    state-independent rows alone); the total and every row with need_per.
    Then its times on the plain batch at [1, 6,144] (the sidecar's: stock
    weights, SelectorSpread on, the zone index and the pass) and [2,048,
    6,144] (the round's: SelectorSpread zeroed for the spread-lean batch,
    skip_zero_weight, one launch), total only, with L2 cold and warm,
    beside the bound of each configuration, an empty launch and its
    twin's time."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import FilterConfig, ScoreConfig
    from kubernetes_tpu_torch.kernels import k1_bench, k12_cases
    from kubernetes_tpu_torch.models.batched import static_profile
    from kubernetes_tpu_torch.ops import priorities as tpr

    names = []
    for name, case in k12_cases.cases():
        ct, pb = _case_tensors(case)
        _k12_against_twin(f"case {name}", ct, pb, weights=case["weights"],
                          zone_key_id=case["zone_key"],
                          skip_zero_weight=case["skip_zero_weight"],
                          score_cfg=ScoreConfig(**case["score_cfg"]))
        names.append(name)
    w_stock = tpr.DEFAULT_PRIORITY_WEIGHTS
    full = []
    for batch in (2048,) + AFFINITY_WORKLOADS:
        ct, pb, _, zk = bench[batch]
        if batch in AFFINITY_WORKLOADS:
            check(pb.pref_pair_weights.shape[-1] == ct.topo_pairs.shape[1],
                  f"K12: the {batch} batch has no IPA sums")
        aff = batch in AFFINITY_WORKLOADS
        _k12_against_twin(f"the bench fleet's {batch} batch, stock weights",
                          ct, pb, weights=w_stock, zone_key_id=zk)
        _k12_against_twin(f"the bench fleet's {batch} batch, the round's "
                          f"weights", ct, pb, need_pers=(False,),
                          weights=_round_weights(ct, pb, aff),
                          zone_key_id=zk, skip_zero_weight=True)
        for in_batch in (False, True):
            _k12_against_twin(
                f"the bench fleet's {batch} batch, static_pass's weights "
                f"(in-batch affinity {in_batch})", ct, pb,
                need_pers=(False,), zone_key_id=zk,
                weights=static_profile(FilterConfig(), w_stock, in_batch)[1])
        full.append(str(batch))
    empty = k1_bench.time_ms(kernels.noop_launch, cold=False)
    shapes = {}
    for B, skip in ((1, False), (2048, True)):
        ct, pb, _, zk = bench[B]
        w = (_round_weights(ct, pb, False) if skip
             else np.asarray(w_stock, np.float32))
        k12 = lambda: tpr.score_batch(                      # noqa: E731
            ct, pb, weights=w, zone_key_id=zk, skip_zero_weight=skip,
            need_per=False)
        twin = lambda: tpr.score_batch_plain(               # noqa: E731
            ct, pb, weights=w, zone_key_id=zk, skip_zero_weight=skip,
            need_per=False)
        check(_bits_equal(k12()[0], twin()[0]),
              f"K12: the bench fleet's [{B}, {ct.n_nodes}] batch differs "
              f"from the twin")
        spread = bool(w[tpr.PRIO_INDEX["SelectorSpreadPriority"]] != 0.0)
        shapes[f"b{B}"] = {
            "B": B, "N": ct.n_nodes, "launches": 2 if spread else 1,
            "weights": ("stock, SelectorSpread on" if spread else
                        "the round's, SelectorSpread zeroed"),
            "ms": k1_bench.time_ms(k12, cold=True),
            "ms_warm": k1_bench.time_ms(k12, cold=False),
            "plain_ms": k1_bench.time_ms(twin, reps=10),
            **_k12_bound(ct, pb, w, False, False, zk)}
    main = shapes["b2048"]
    out = {**{k: main[k] for k in ("ms", "ms_warm", "plain_ms", "bound_ms",
                                   "bound_by")},
           "empty_launch_ms": empty, "max_abs_err": 0.0, "cases": len(names),
           "full_width": full,
           "shape": {k: main[k] for k in ("B", "N")}, "shapes": shapes}
    print(f"[K12] bit-identical to the twin on {len(names)} cases (total "
          f"and rows, need_per on and off) and the bench fleet's "
          f"{', '.join(full)} batches (stock weights with need_per on and "
          f"off, the round's, static_pass's) | " + " | ".join(
              f"[{d['B']}, {d['N']}] {d['weights']} ({d['launches']} "
              f"launches): "
              f"cold_ms {d['ms']:.4f} warm_ms {d['ms_warm']:.4f} plain_ms "
              f"(twin on the card) {d['plain_ms']:.4f} bound_ms "
              f"{d['bound_ms']:.6f} ({d['bound_by']}; bytes_ms "
              f"{d['bytes_ms']:.6f} ops_ms {d['ops_ms']:.6f}: int32 "
              f"{d['int_ops']:.0f} f32 {d['f32_ops']:.0f}, "
              f"{d['ops_per_pair']:.2f} a pair)" for d in shapes.values())
          + f" | empty_launch_ms {empty:.4f}", flush=True)
    return out


def _passes_launched(label: str, launches: dict) -> None:
    """K11 and K12 launched in a cell that filters and scores, and K7
    once for every K11 stack (stack mode: the sidecar's B9, the
    preemption candidates)."""
    check(launches["filter_pass"] > 0,
          f"{label}: the main path launched K11 no time")
    check(launches["score_pass"] > 0,
          f"{label}: the main path launched K12 no time")
    check(launches["fold_predicates"] == launches["filter_pass_stack"],
          f"{label}: K7 launched {launches['fold_predicates']} times for "
          f"{launches['filter_pass_stack']} K11 stacks")


EXT_RUNNING = 1000     # running pods synced into the phase 18 sidecar
EXT_PODS = 512         # pending pods through /filter, /prioritize, /bind
EXT_PREEMPT = 16       # /preempt requests against the preemption fleet
# phase 19: timed pods, batch, and a warmup batch of 64 pods (cut, as the
# timed pods are from 10,000: every pod costs two round trips of 5,000 names)
LIVE_EXT_PODS, LIVE_EXT_BATCH, LIVE_EXT_WARMUP = 1024, 256, 64


def _pct_ms(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def phase_extender(label: str = "18 extender sidecar") -> dict:
    """The port's ExtenderServer on the card driven over HTTP on
    127.0.0.1 by loop.drive_extender, as a stock kube-scheduler with
    NodeCacheCapable: true drives it: the bench fleet, its 20 spread
    selectors and 1,000 running pods synced, then 512 pending pods through
    /filter, /prioritize and /bind with the launch counts reset just
    before and read just after; every reply digest and bound node against
    tests/data/torch_port_golden_extender.npz, K7 launched twice a pod.
    Then a second sidecar synced with phase 13's fleet and running pods
    answers the first 16 preemptors' /preempt against the same golden.
    Per-verb latency p50 / p99, requests/s, the split of a /filter
    request, the syncs' seconds."""
    from kubernetes_tpu_torch import kernels, loop
    from kubernetes_tpu_torch.extender.server import FILTER_PARTS, ExtenderServer

    data = np.load(golden("extender"))
    nodes = loop.bench_nodes(NODES)
    running = [loop.existing_pod(i, nodes) for i in range(EXT_RUNNING)]
    pods = [loop.pending_pod(i) for i in range(EXT_PODS)]
    srv = ExtenderServer(device="cuda")
    srv.start()
    try:
        # the syncs touch only the host mirror: no launch before the verbs
        kernels.reset_launch_counts()
        res = loop.drive_extender(srv.address, nodes, running, pods)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        srv.stop()
    check(launches["fold_predicates"] == 2 * EXT_PODS,
          f"{label}: K7 launched {launches['fold_predicates']} times for "
          f"{EXT_PODS} pods, not two a pod")
    check(launches["select_hosts"] == 2 * EXT_PODS,
          f"{label}: K1 launched {launches['select_hosts']} times, not two "
          f"a pod")
    check(launches["filter_pass"] == launches["filter_pass_stack"]
          == launches["score_pass"] == 2 * EXT_PODS,
          f"{label}: K11 launched {launches['filter_pass']} times "
          f"({launches['filter_pass_stack']} stacks), K12 "
          f"{launches['score_pass']}, for {EXT_PODS} pods, not two a pod")
    _passes_launched(label, launches)
    for verb in ("filter", "prioritize", "bind"):
        got = res["digests"][verb]
        want = [bytes(r) for r in data[verb]]
        if got != want:
            i = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                     min(len(got), len(want)))
            fail(f"{label}: /{verb} reply {i} of {len(want)} differs from "
                 f"the JAX sidecar's (port {len(got)} replies)")
    bound = [int(b.rsplit("-", 1)[1]) if b else -1 for b in res["bound"]]
    check(bound == data["bound"].tolist(),
          f"{label}: bound nodes differ from the JAX sidecar's drive")
    fleet = loop.preemption_fleet(NODES)
    pre_running = loop.preemption_running_pods(fleet)
    pre_srv = ExtenderServer(device="cuda")
    pre_srv.start()
    try:
        kernels.reset_launch_counts()
        pre = loop.drive_extender(
            pre_srv.address, fleet, pre_running,
            preemptors=loop.preemptors(EXT_PREEMPT))
        torch.cuda.synchronize()
        pre_launches = dict(kernels.LAUNCHES)
    finally:
        pre_srv.stop()
    replies = [json.dumps(r, sort_keys=True, separators=(",", ":"))
               for r in pre["preempt_replies"]]
    if replies != data["preempt_replies"].tolist():
        i = next((j for j, (x, y) in enumerate(
            zip(replies, data["preempt_replies"].tolist())) if x != y), 0)
        fail(f"{label}: /preempt reply {i} differs from the JAX sidecar's: "
             f"port {replies[i] if i < len(replies) else None} JAX "
             f"{data['preempt_replies'][i]}")
    check(pre["digests"]["preempt"] == [bytes(r) for r in data["preempt"]],
          f"{label}: /preempt reply digests differ from the JAX sidecar's")
    check(pre_launches["preempt_one"] >= EXT_PREEMPT,
          f"{label}: K2 launched {pre_launches['preempt_one']} times for "
          f"{EXT_PREEMPT} /preempt requests")
    check(pre_launches["filter_pass_stack"] > 0
          and pre_launches["fold_predicates"]
          == pre_launches["filter_pass_stack"],
          f"{label}: the /preempt candidates' stacks: K11 "
          f"{pre_launches['filter_pass_stack']}, K7 "
          f"{pre_launches['fold_predicates']}")
    ops = _child_stream_ops(_FILTER_OPS_CHILD, label, "cuda")
    n_ops = sum(ops.values())
    check(n_ops <= 30, f"{label}: one /filter ran {n_ops} device "
          f"operations, above 30: {ops}")
    lat = {v: res["latency"][v] for v in ("filter", "prioritize", "bind")}
    lat["preempt"] = pre["latency"]["preempt"]
    verbs = {v: {"p50_ms": _pct_ms(x, 50), "p99_ms": _pct_ms(x, 99),
                 "requests": len(x), "requests_per_s": len(x) / sum(x)}
             for v, x in lat.items()}
    n_f = max(srv.filter_requests, 1)
    split = {k: srv.filter_seconds[k] / n_f * 1e3 for k in FILTER_PARTS}
    out = {"verbs": verbs, "filter_split_ms": split, "launches": launches,
           "filter_device_ops": n_ops, "filter_ops": ops,
           "preempt_launches": pre_launches,
           "sync_seconds": res["sync_seconds"],
           "preempt_sync_seconds": pre["sync_seconds"],
           "synced": {"nodes": NODES, "running": EXT_RUNNING,
                      "preempt_running": len(pre_running)}}
    print(f"[{label}] {EXT_PODS} pods x 3 verbs and {EXT_PREEMPT} /preempt "
          f"equal to the JAX sidecar's golden, K7 launches "
          f"{launches['fold_predicates']} (two a pod), K1 "
          f"{launches['select_hosts']}, K2 {pre_launches['preempt_one']} | "
          + " | ".join(
              f"{v} p50_ms {d['p50_ms']:.3f} p99_ms {d['p99_ms']:.3f} "
              f"req_per_s {d['requests_per_s']:.1f}"
              for v, d in verbs.items())
          + " | filter split ms a request: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" | one /filter's device operations {n_ops}: "
          + ", ".join(f"{k} {v}" for k, v in sorted(ops.items()))
          + f" | sync seconds: bench fleet {res['sync_seconds']:.2f} "
          f"({NODES} nodes, {EXT_RUNNING} pods), preemption fleet "
          f"{pre['sync_seconds']:.2f} ({NODES} nodes, "
          f"{len(pre_running)} pods)", flush=True)
    return out


def phase_live_extender(label: str = "19 live extender") -> dict:
    """loop.run_live on the card with an extender sidecar: the port's
    Scheduler with one HTTP extender (filter, prioritize, bind) pointed at
    the port's sidecar in this process (loop.extender_sidecar), 5,000 nodes, a 64-pod warmup, then 1,024 pods in
    batches of 256, launch counts reset just before and read just after;
    bindings and their order against
    tests/data/torch_port_golden_live_extender.npz; pods/s and the
    extenders span's share of the window."""
    from kubernetes_tpu_torch import kernels, loop

    data = np.load(golden("live_extender"))
    nodes = loop.bench_nodes(NODES)
    with loop.extender_sidecar(nodes, device="cuda") as srv:
        kernels.reset_launch_counts()
        res = loop.run_live(nodes, LIVE_EXT_PODS, LIVE_EXT_BATCH,
                            device="cuda", pipeline=False,
                            warmup=LIVE_EXT_WARMUP, sidecar=srv)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    n_all = LIVE_EXT_PODS + LIVE_EXT_WARMUP
    check(np.array_equal(res["hosts"], data["hosts"]),
          f"{label}: bound rows differ from the JAX Scheduler's (port "
          f"{int((res['hosts'] >= 0).sum())} bound)")
    check(np.array_equal(res["bind_order"], data["bind_order"]),
          f"{label}: bind order differs from the JAX Scheduler's")
    check(launches["fold_predicates"] == 2 * n_all,
          f"{label}: K7 launched {launches['fold_predicates']} times for "
          f"{n_all} pods (warmup included), not two a pod on the sidecar")
    ph = res["phases"]
    share = res["extender_seconds"] / res["seconds"]
    n_f = max(res["filter_requests"], 1)
    split = {k: v / n_f * 1e3 for k, v in res["filter_seconds"].items()}
    out = {"pods_per_s": res["pods_per_s"], "seconds": res["seconds"],
           "placed": res["placed"], "cycles": res["cycles"],
           "extender_seconds": res["extender_seconds"],
           "extender_share": share, "phases": ph, "launches": launches,
           "filter_split_ms": split}
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} seconds "
          f"{res['seconds']:.3f} placed {res['placed']} cycles "
          f"{res['cycles']} | extenders span {res['extender_seconds']:.3f} "
          f"s, share of the window {share:.3f} | phases encode (fan-out "
          f"included) {ph['encode']:.3f} dispatch {ph['dispatch']:.3f} "
          f"commit {ph['commit']:.3f} | sidecar filter split ms a request: "
          + " ".join(f"{k} {v:.3f}" for k, v in split.items())
          + f" | K7 launches {launches['fold_predicates']} K1 "
          f"{launches['select_hosts']} | bindings and order equal to the "
          f"JAX Scheduler's", flush=True)
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


# ------------------------------------------ capacity and replicas (A10a)

WHAT_IF_BINS = 2048    # bench.py --autoscale-bins, BASELINE's what-if
CAPACITY_SHAPES = 64   # the live capacity cell's catalog: phase 20's first
STORM_QUOTA = {"cpu": "50"}   # the flooding tenant's quota in phase 22


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _baseline_sweep(device="cuda"):
    """BASELINE's fifth configuration on the card: (classes f32[256, 8],
    counts i32[256], shapes f32[10,000, 8], pod reqs f32[50,000, 8]) from
    loop.what_if_workload, compressed as models/binpack.py what_if does."""
    from kubernetes_tpu_torch import loop
    from kubernetes_tpu_torch.models.binpack import compress_classes

    reqs, shapes = loop.what_if_workload()
    classes, counts = compress_classes(reqs, pad_to_pow2=True)
    dev = torch.device(device)
    return (torch.from_numpy(classes).to(dev),
            torch.from_numpy(counts).to(dev),
            torch.from_numpy(shapes).to(dev), reqs)


def _timing(fn, twin_ms: float, bytes_: int, ops: int, reps: int) -> dict:
    """A kernel's times with L2 cold and warm, beside its bound (bytes over
    the memory rate, operations over the INT32 rate), an empty launch and
    its twin's time (given)."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench

    out = {"ms": k1_bench.time_ms(fn, reps=reps, cold=True),
           "ms_warm": k1_bench.time_ms(fn, reps=reps, cold=False),
           "plain_ms": twin_ms,
           "empty_launch_ms": k1_bench.time_ms(kernels.noop_launch,
                                               cold=False),
           "bytes": int(bytes_), "ops": int(ops),
           "bytes_ms": bytes_ / k1_bench.HBM_BYTES_PER_S * 1e3,
           "ops_ms": ops / INT32_OPS_PER_S * 1e3, "library_ms": None}
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = ("bytes" if out["bytes_ms"] >= out["ops_ms"]
                       else "operations")
    return out


def _cuda_ms(fn) -> "tuple[float, object]":
    """(milliseconds, result) of one fn() between two CUDA events."""
    a, b = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), res


def phase_k9(sweep, device="cuda") -> dict:
    """K9 (ffd_order) against its plain twin on the card, bit for bit, on
    every case of kernels/k9_cases.py; then its times at the BASELINE
    sweep (256 classes under 10,000 shapes) with L2 cold and warm, beside
    its bound (a comparison sort's C log2 C compares and the C R divisions
    a lane, over the INT32 rate; its bytes over the memory rate), an empty
    launch and the twin's time on the card."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k9_cases
    from kubernetes_tpu_torch.models.binpack import ffd_order_plain

    dev = torch.device(device)
    names = []
    for name, c in k9_cases.cases():
        reqs, caps = (torch.from_numpy(c[k]).to(dev) for k in ("reqs",
                                                               "caps"))
        got = kernels.ffd_order(reqs, caps)
        want = ffd_order_plain(reqs, caps)
        _sync(dev)
        if not torch.equal(got, want):
            bad = torch.nonzero(got != want)[0].tolist()
            fail(f"K9: differs from the twin on case {name} at {bad}: "
                 f"kernel {got[bad[0], bad[1]].item()} twin "
                 f"{want[bad[0], bad[1]].item()}")
        names.append(name)
    classes, _, shapes, _ = sweep
    S, (C, R) = shapes.shape[0], classes.shape
    twin_ms, _ = _cuda_ms(lambda: ffd_order_plain(classes, shapes))
    out = _timing(lambda: kernels.ffd_order(classes, shapes), twin_ms,
                  C * R * 4 + S * R * 4 + S * C * 4,
                  S * (C * int(np.ceil(np.log2(max(C, 2)))) + C * R), reps=10)
    out.update(max_abs_err=0.0, cases=len(names),
               shape={"S": S, "C": C, "R": R})
    print(f"[K9] bit-identical to the twin on {len(names)} cases "
          f"({', '.join(names)}) | at {out['shape']}: cold_ms "
          f"{out['ms']:.4f} warm_ms {out['ms_warm']:.4f} plain_ms (twin on "
          f"the card) {out['plain_ms']:.3f} bound_ms {out['bound_ms']:.5f} "
          f"({out['bound_by']}) empty_launch_ms "
          f"{out['empty_launch_ms']:.4f}", flush=True)
    return out


def phase_k8(sweep, device="cuda") -> dict:
    """K8 (binpack_counts) against its plain twin on the card, bit for
    bit, on every case of kernels/k8_cases.py; then at the BASELINE sweep
    (10,000 lanes of 2,048 bins, the 256 classes in K9's order): the
    twin's run on the card (kept for phase 20, its admissions counted),
    the kernel's times with L2 cold and warm beside its bound (its bytes,
    and four INT32 operations for every (bin, requested column) admission
    a step must evaluate up to its last fill, on this data) and an empty
    launch."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k8_cases
    from kubernetes_tpu_torch.models.binpack import binpack_counts_plain

    dev = torch.device(device)
    names = []
    for name, c in k8_cases.cases():
        args = [torch.from_numpy(c[k]).to(dev)
                for k in ("reqs", "counts", "caps", "order")]
        got = kernels.binpack_counts(*args, c["n_bins"], c["per_bin"], True)
        want = binpack_counts_plain(*args, c["n_bins"], c["per_bin"], True)
        _sync(dev)
        for g, w, what in zip(got, want, ("used", "placed", "loads",
                                          "touched")):
            if not ((g is None and w is None) or _bits_equal(g, w)):
                fail(f"K8: {what} differs from the twin on case {name}: "
                     f"kernel {g.reshape(-1)[:8].tolist()} twin "
                     f"{w.reshape(-1)[:8].tolist()}")
        names.append(name)
    classes, counts, shapes, _ = sweep
    order = kernels.ffd_order(classes, shapes)
    S, (C, R) = shapes.shape[0], classes.shape
    work: dict = {}
    twin_ms, twin = _cuda_ms(lambda: binpack_counts_plain(
        classes, counts, shapes, order, WHAT_IF_BINS, False, work=work))
    got = kernels.binpack_counts(classes, counts, shapes, order,
                                 WHAT_IF_BINS, False)
    _sync(dev)
    check(_bits_equal(got[0], twin[0]) and _bits_equal(got[1], twin[1]),
          "K8: differs from the twin at the BASELINE sweep")
    out = _timing(lambda: kernels.binpack_counts(
        classes, counts, shapes, order, WHAT_IF_BINS, False), twin_ms,
        C * R * 4 + C * 4 + S * R * 4 + S * C * 4 + S * 4 + S * C * 4,
        4 * work["bin_columns"], reps=5)
    out.update(max_abs_err=0.0, cases=len(names), twin=twin,
               shape={"S": S, "C": C, "R": R, "bins": WHAT_IF_BINS},
               bin_columns=work["bin_columns"])
    print(f"[K8] bit-identical to the twin on {len(names)} cases "
          f"({', '.join(names)}) | at {out['shape']}: cold_ms "
          f"{out['ms']:.4f} warm_ms {out['ms_warm']:.4f} plain_ms (twin on "
          f"the card) {out['plain_ms']:.1f} bound_ms {out['bound_ms']:.5f} "
          f"({out['bound_by']}: {work['bin_columns']} admissions) "
          f"empty_launch_ms {out['empty_launch_ms']:.4f}", flush=True)
    return out


def phase_k10(device="cuda") -> dict:
    """K10 (reconcile_admit) against its plain twin on the card, bit for
    bit, on every case of kernels/k10_cases.py; then its times at Bp
    2,048, R 8 (the last case) with L2 cold and warm, beside its bound
    (its bytes, and the six compares and subtractions a column a candidate
    over the INT32 rate), an empty launch and the twin's on the card."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k10_cases
    from kubernetes_tpu_torch.runtime.reconciler import admit_scan_plain

    dev = torch.device(device)
    keys = ("u_node", "u_ns", "order", "reqs", "node_head", "ns_head")
    names = []
    for name, c in k10_cases.cases():
        args = [torch.from_numpy(c[k]).to(dev) for k in keys]
        got = kernels.reconcile_admit(*args)
        want = admit_scan_plain(*args)
        _sync(dev)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"K10: differs from the twin on case {name}")
        names.append(f"{name}:{int(got[0].sum())}/{int(got[1].sum())}")
    check(names[-1].startswith("bp2048"), "K10: the last case is not Bp 2048")
    Bp, R = args[3].shape
    twin_ms, _ = _cuda_ms(lambda: admit_scan_plain(*args))
    out = _timing(lambda: kernels.reconcile_admit(*args), twin_ms,
                  3 * Bp * 4 + 3 * Bp * R * 4 + 2 * Bp, 6 * Bp * R, reps=20)
    out.update(max_abs_err=0.0, cases=len(names), shape={"Bp": Bp, "R": R})
    print(f"[K10] bit-identical to the twin on {len(names)} cases "
          f"(case:admitted/quota_ok {' '.join(names)}) | at {out['shape']}: "
          f"cold_ms {out['ms']:.4f} warm_ms {out['ms_warm']:.4f} plain_ms "
          f"(twin on the card) {out['plain_ms']:.2f} bound_ms "
          f"{out['bound_ms']:.6f} ({out['bound_by']}) empty_launch_ms "
          f"{out['empty_launch_ms']:.4f}", flush=True)
    return out


def phase_what_if(sweep, k8: dict, label: str = "20 what-if",
                  device="cuda") -> dict:
    """BASELINE's fifth configuration: models/binpack.py what_if of the
    50,000-pod backlog over 10,000 shapes with 2,048 bins, launch counts
    reset just before and read just after (one K9 and one K8 launch):
    bins and ok on every lane equal to the twin's (phase K8's run on the
    card) and to tests/data/torch_port_golden_what_if.npz (the JAX
    binpack_shapes_compressed); on the first 4 shapes the per-pod sweep
    (K9 over 50,000 pods, then K4 a lane) needs the same bins; the solve's
    milliseconds and shapes a second."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.models.binpack import binpack_shapes, what_if

    classes, counts, shapes, reqs = sweep
    shapes_np = shapes.cpu().numpy()
    what_if(reqs, shapes_np[:2], max_bins=WHAT_IF_BINS,
            device=device)                                # first call
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    fits = what_if(reqs, shapes_np, max_bins=WHAT_IF_BINS, device=device)
    solve_s = time.monotonic() - t0
    launches = dict(kernels.LAUNCHES)
    check(launches["ffd_order"] == 1 and launches["binpack_counts"] == 1,
          f"{label}: launches {launches}, not one K9 and one K8")
    S = shapes.shape[0]
    bins = np.full(S, -1, np.int64)
    for s, b in fits:
        bins[s] = b
    ok = bins >= 0
    used_t, placed_t = (x.cpu().numpy() for x in k8["twin"][:2])
    ok_t = placed_t.astype(np.int64).sum(-1) == int(counts.sum())
    check(np.array_equal(ok, ok_t) and np.array_equal(bins[ok],
                                                      used_t[ok_t]),
          f"{label}: what_if differs from the twin on the card")
    data = np.load(golden("what_if"))
    g = int(data["lanes"])
    check(np.array_equal(data["ok"], ok[:g])
          and np.array_equal(data["bins"], used_t[:g]),
          f"{label}: differs from the JAX golden on its {g} lanes")
    t1 = time.monotonic()
    pb, pok = binpack_shapes(torch.from_numpy(reqs).to(shapes.device),
                             shapes[:4], max_bins=WHAT_IF_BINS)
    pb, pok = pb.cpu().numpy(), pok.cpu().numpy()
    per_pod_s = time.monotonic() - t1
    check(np.array_equal(pok, ok[:4])
          and np.array_equal(pb[pok], bins[:4][pok]),
          f"{label}: the per-pod sweep needs {pb.tolist()} bins "
          f"(ok {pok.tolist()}), the compressed {bins[:4].tolist()}")
    out = {"solve_ms": solve_s * 1e3, "shapes_per_s": S / solve_s,
           "fitting": int(ok.sum()), "golden_lanes": g,
           "per_pod_seconds": per_pod_s, "launches": launches}
    print(f"[{label}] 50,000 pods in {int((counts > 0).sum())} classes x "
          f"{S} shapes, {WHAT_IF_BINS} bins: solve_ms {out['solve_ms']:.2f} "
          f"shapes_per_s {out['shapes_per_s']:.0f}, {out['fitting']} shapes "
          f"fit | equal to the twin on {S} lanes and to the JAX golden on "
          f"{g} | per-pod sweep on 4 shapes ({per_pod_s:.2f} s) needs the "
          f"same bins {pb.tolist()}", flush=True)
    return out


def phase_live_capacity(label: str = "21 live capacity",
                        device="cuda") -> dict:
    """loop.run_live at full width with the capacity planner every cycle
    over phase 20's first 64 shapes, the fleet pre-filled to 3.5 free CPU a
    node (loop.capacity_running_pods) and the pending pods' requests drawn
    from phase 20's classes (loop.capacity_requests: the last batch's fit
    no node), launch counts reset just before and
    read just after: bindings, order and every solve equal to
    tests/data/torch_port_golden_live_capacity.npz (the JAX Scheduler's);
    placements equal to a planner-off run; K8 and K9 twice a solve, none
    dropped; pods/s and the hook's share of the window."""
    from kubernetes_tpu_torch import kernels, loop

    data = np.load(golden("live_capacity"))
    backlog, caps = loop.what_if_workload()
    reqs = loop.capacity_requests(backlog, PODS, BATCH, BATCH)
    nodes = loop.bench_nodes(NODES)
    kw = dict(device=device,
              make_pending=lambda i: loop.capacity_pod(i, reqs),
              running=loop.capacity_running_pods(nodes))
    kernels.reset_launch_counts()
    res = loop.run_live(nodes, PODS, BATCH, capacity_planner=True,
                        capacity_interval_cycles=1,
                        node_shape_catalog=loop.shape_catalog(
                            caps[:CAPACITY_SHAPES]), **kw)
    launches = res["launches"]
    check(np.array_equal(res["hosts"], data["hosts"])
          and np.array_equal(res["bind_order"], data["bind_order"]),
          f"{label}: bindings differ from the JAX Scheduler's (port "
          f"{int((res['hosts'] >= 0).sum())} bound, golden "
          f"{int((data['hosts'] >= 0).sum())})")
    samples = loop.capacity_arrays(res["capacity_samples"])[
        "capacity_samples"]
    check(np.array_equal(samples, data["capacity_samples"]),
          f"{label}: the solves differ from the JAX planner's: port "
          f"{samples[:1]} golden {data['capacity_samples'][:1]}")
    cap = res["capacity"]
    check(cap["solves_dropped"] == 0,
          f"{label}: {cap['solves_dropped']} solves dropped")
    d = res["capacity_dispatches"]
    check(d > 0 and launches["binpack_counts"] == 2 * d
          and launches["ffd_order"] == 2 * d,
          f"{label}: K8 {launches['binpack_counts']} and K9 "
          f"{launches['ffd_order']} launches for {d} solves, not two each")
    overflow = [json.loads(x)["overflow_pods"] for x in samples]
    absorbed = [json.loads(x)["absorbed_existing"] for x in samples]
    check(max(overflow) > 0 and max(absorbed) > 0,
          f"{label}: no solve both absorbed and overflowed ({absorbed}, "
          f"{overflow})")
    off = loop.run_live(nodes, PODS, BATCH, **kw)
    check(np.array_equal(off["hosts"], res["hosts"])
          and np.array_equal(off["bind_order"], res["bind_order"]),
          f"{label}: placements differ with the planner off")
    share = res["capacity_seconds"] / res["seconds"]
    reco = cap["recommendation"] or {}
    out = {"pods_per_s": res["pods_per_s"], "seconds": res["seconds"],
           "placed": res["placed"], "solves": len(samples),
           "dispatches_in_window": d, "launches": launches,
           "capacity_seconds": res["capacity_seconds"],
           "capacity_share": share, "overflow": overflow,
           "absorbed": absorbed, "pods_per_s_planner_off":
               off["pods_per_s"], "scale_up": reco.get("scale_up")}
    print(f"[{label}] pods_per_s {res['pods_per_s']:.1f} (planner off "
          f"{off['pods_per_s']:.1f}) placed {res['placed']} | {len(samples)} "
          f"solves equal to the JAX planner's, {d} in the window, absorbed "
          f"{absorbed} overflow {overflow}, last scale_up "
          f"{reco.get('scale_up')} | hook {res['capacity_seconds']:.3f} s, "
          f"share of the window {share:.4f} | K8 "
          f"{launches['binpack_counts']} K9 {launches['ffd_order']} "
          f"launches, 0 dropped | bindings and order equal to the JAX "
          f"Scheduler's and to the planner-off run", flush=True)
    return out


def phase_replicas(label: str = "22 replicas", device="cuda") -> dict:
    """loop.run_replicas at full width (pipeline_commit and preemption
    off) at N = 1 and 2, then the four-tenant storm at N = 2 with a finite
    quota on the flooding tenant: every offered pod placed or accounted
    for, no invariant violation, every replica drained; the reconciler's
    kernel_calls equal to its scans and to K10's launches; every scan's
    inputs replayed through the twin give the kernel's admit and
    quota_ok; at least one scan and one quota veto.  Pods/s a replica
    count, conflicts and the fast-path share are printed, not judged."""
    from kubernetes_tpu_torch import loop
    from kubernetes_tpu_torch.runtime.reconciler import admit_scan_plain

    res = loop.run_replicas(loop.bench_nodes(NODES), PODS, BATCH, ns=(1, 2),
                            device=device, storm_quota=STORM_QUOTA,
                            record_scans=True)
    curve, storm = res["curve"], res["storm"]
    for c in curve:
        check(c["placed"] == PODS and c["invariant_violations"] == 0
              and c["drained_clean"] and c["kernel_calls"] == c["scans"],
              f"{label}: N={c['replicas']}: {c}")
    check(storm["lost"] == 0 and storm["invariant_violations"] == 0
          and storm["drained_clean"]
          and storm["kernel_calls"] == storm["scans"],
          f"{label}: storm {storm}")
    check(storm["scans"] >= 1 and storm["quota_vetoes"] >= 1,
          f"{label}: the storm ran {storm['scans']} scans with "
          f"{storm['quota_vetoes']} quota vetoes")
    calls = sum(c["kernel_calls"] for c in curve) + storm["kernel_calls"]
    check(res["launches"]["reconcile_admit"] == calls == len(res["scans"]),
          f"{label}: K10 launched {res['launches']['reconcile_admit']} "
          f"times for {calls} scans ({len(res['scans'])} recorded)")
    for k, (inputs, admit, quota_ok) in enumerate(res["scans"]):
        a, q = admit_scan_plain(*(torch.from_numpy(x) for x in inputs))
        check(np.array_equal(a.numpy(), admit)
              and np.array_equal(q.numpy(), quota_ok),
              f"{label}: scan {k} replayed through the twin differs")
    out = {"curve": curve, "storm": storm, "scans": len(res["scans"]),
           "launches": res["launches"]}
    print(f"[{label}] " + " | ".join(
        f"N={c['replicas']}: pods_per_s {c['pods_per_s']:.1f} "
        f"({c['pods_per_s'] / c['replicas']:.1f} a replica) conflicts "
        f"{c['conflicts']} fast_path {c['fast_path']} scans {c['scans']}"
        for c in curve)
        + f" | storm: offered {storm['offered']} placed {storm['placed']} "
        f"left {storm['left_in_queue']} shed {storm['shed']} lost 0, per "
        f"tenant {storm['per_tenant']}, quota vetoes "
        f"{storm['quota_vetoes']}, scans {storm['scans']} | "
        f"{len(res['scans'])} scans replayed through the twin, equal; K10 "
        f"launches {res['launches']['reconcile_admit']}", flush=True)
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
    _passes_launched("11 live", live["launches"])
    live12 = phase_live("12 live nominated", nodes, NOMINATED)
    _passes_launched("12 live nominated", live12["launches"])
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
    _passes_launched("13 live preemption", live13["launches"])
    print(f"[13 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    k3 = phase_k3(main_n)
    k4 = phase_k4()
    live14 = phase_quality(nodes, live)
    _passes_launched("14 live quality", live14["launches"])
    print(f"[14 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    k5 = phase_k5()
    live15 = phase_live_default(nodes, live)
    _passes_launched("15 live default", live15["launches"])
    print(f"[15 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    k6 = phase_k6()
    mega = phase_megacycle(nodes, live)
    _passes_launched("16 megacycle", mega["launches"])
    print(f"[16 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    wide17 = phase_wide_columns()
    _passes_launched("17 R=32 quality", wide17["launches"])
    print(f"[17 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    k7 = phase_k7()
    bench = _bench_batches()
    k11 = phase_k11(bench)
    k12 = phase_k12(bench)
    del bench
    print(f"[K12 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    ext = phase_extender()
    print(f"[18 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    live19 = phase_live_extender()
    _passes_launched("19 live extender", live19["launches"])
    print(f"[19 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    t_new = time.monotonic()
    sweep = _baseline_sweep()
    k9 = phase_k9(sweep)
    k8 = phase_k8(sweep)
    k10 = phase_k10()
    what = phase_what_if(sweep, k8)
    k8.pop("twin")
    print(f"[20 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    live21 = phase_live_capacity()
    _passes_launched("21 live capacity", live21["launches"])
    print(f"[21 done] total seconds {time.monotonic() - t_start:.1f}",
          flush=True)
    rep22 = phase_replicas()
    _passes_launched("22 replicas", rep22["launches"])
    print(f"[22 done] total seconds {time.monotonic() - t_start:.1f}, "
          f"phases K8-K10 and 20-22 {time.monotonic() - t_new:.1f}",
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
        "wide": k2["wide"],
    }, {
        "name": "select_topk",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/select_topk.cu",
        "replaces": "kubernetes_tpu/ops/select.py:152",
        "launches": live14["launches"]["select_topk"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": "bytes",
        "library_ms": k3["library_ms"],
        "ms_warm": k3["ms_warm"],
        "launches_b1": live14["launches"]["select_topk_b1"],
        "launches_interval32": live14["launches_interval32"]["select_topk"],
        "cases": k3["cases"],
        "shapes": k3["shapes"],
    }, {
        "name": "binpack_ffd",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/binpack_ffd.cu",
        "replaces": "kubernetes_tpu/models/binpack.py:59",
        "launches": live14["launches"]["binpack_ffd"],
        "max_abs_err": k4["max_abs_err"],
        "ms": k4["ms"],
        "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"],
        "library_ms": None,
        "ms_warm": k4["ms_warm"],
        "step_floor_ms": k4["step_floor_ms"],
        "over_step_floor": k4["over_step_floor"],
        "ops": k4["ops"],
        "shape": k4["shape"],
        "launches_interval32": live14["launches_interval32"]["binpack_ffd"],
        "wide": k4["wide"],
    }, {
        "name": "cluster_analytics",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/cluster_analytics.cu",
        "replaces": "kubernetes_tpu/ops/analytics.py:249",
        "launches": live15["launches"]["cluster_analytics"],
        "max_abs_err": k5["max_abs_err"],
        "ms": k5["ms"],
        "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"],
        "library_ms": None,
        "ms_warm": k5["ms_warm"],
        "stream_ops": k5["stream_ops"],
        "empty_launch_ms": k5["empty_launch_ms"],
        "launch_floor_ms": k5["launch_floor_ms"],
        "over_floor": k5["over_floor"],
        "cases": k5["cases"],
        "shape": k5["shape"],
        "committed_cycles": live15["cycles"],
        "multi_block": k5["wide"],
    }, {
        "name": "commit_group_counts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/commit_group_counts.cu",
        "replaces": "kubernetes_tpu/models/megacycle.py:78",
        "launches": mega["launches"]["commit_group_counts"],
        "max_abs_err": k6["max_abs_err"],
        "ms": k6["ms"],
        "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"],
        "bound_by": k6["bound_by"],
        "library_ms": k6["library_ms"],
        "ms_warm": k6["ms_warm"],
        "library_ms_warm": k6["library_ms_warm"],
        "empty_launch_ms": k6["empty_launch_ms"],
        "cases": k6["cases"],
        "shape": k6["shape"],
    }, {
        "name": "fold_predicates",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/fold_predicates.cu",
        "replaces": "kubernetes_tpu/models/generic.py:23 / "
                    "kubernetes_tpu/ops/predicates.py:479",
        "launches": ext["launches"]["fold_predicates"],
        "max_abs_err": k7["max_abs_err"],
        "ms": k7["ms"],
        "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"],
        "bound_by": k7["bound_by"],
        "library_ms": None,
        "ms_warm": k7["ms_warm"],
        "empty_launch_ms": k7["empty_launch_ms"],
        "cases": k7["cases"],
        "shape": k7["shape"],
        "shapes": k7["shapes"],
        "launches_live_extender": live19["launches"]["fold_predicates"],
    }, {
        "name": "binpack_counts",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/binpack_counts.cu",
        "replaces": "kubernetes_tpu/models/binpack.py:148",
        "launches": live21["launches"]["binpack_counts"],
        **{k: k8[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "ms_warm",
                              "empty_launch_ms", "cases", "shape",
                              "bin_columns")},
        "launches_what_if": what["launches"]["binpack_counts"],
    }, {
        "name": "ffd_order",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/ffd_order.cu",
        "replaces": "kubernetes_tpu/models/binpack.py:127",
        "launches": live21["launches"]["ffd_order"],
        **{k: k9[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "ms_warm",
                              "empty_launch_ms", "cases", "shape")},
        "launches_what_if": what["launches"]["ffd_order"],
    }, {
        "name": "reconcile_admit",
        "route": "cuda",
        "source": "kubernetes_tpu_torch/kernels/reconcile_admit.cu",
        "replaces": "kubernetes_tpu/runtime/reconciler.py:209",
        "launches": rep22["launches"]["reconcile_admit"],
        **{k: k10[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms", "ms_warm",
                               "empty_launch_ms", "cases", "shape")},
    }]}
    # K11 and K12 launches by cell (one a speculative round, one a
    # sequential batch's static pass, two a sidecar request)
    cells = {"plain": launches, "node-affinity": launches4,
             "redo": launches5, "pod-anti-affinity": launches8,
             "pod-affinity": launches9, "affinity-redo": launches10,
             "live": live["launches"], "live-nominated": live12["launches"],
             "live-preemption": live13["launches"],
             "live-quality": live14["launches"],
             "live-default": live15["launches"],
             "megacycle": mega["launches"], "R=32": wide17["launches"],
             "extender": ext["launches"],
             "extender-preempt": ext["preempt_launches"],
             "live-extender": live19["launches"],
             "live-capacity": live21["launches"],
             "replicas": rep22["launches"]}
    for name, source, replaces, k, res in (
            ("filter_pass", "filter_pass.cu",
             "kubernetes_tpu/ops/predicates.py:409", "filter_pass", k11),
            ("score_pass", "score_pass.cu",
             "kubernetes_tpu/ops/priorities.py:370", "score_pass", k12)):
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "kubernetes_tpu_torch/kernels/" + source,
            "replaces": replaces,
            "launches": launches[k],
            **{f: res[f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by")},
            "library_ms": None,
            **{f: res[f] for f in ("ms_warm", "empty_launch_ms", "cases",
                                   "shape", "shapes")},
            "launches_by_cell": {c: d[k] for c, d in cells.items()},
        })
    record["kernels"][-2]["stack_launches_by_cell"] = {
        c: d["filter_pass_stack"] for c, d in cells.items()}
    record["kernels"][-2]["filter_device_ops"] = ext["filter_device_ops"]
    print(f"total seconds {time.monotonic() - t_start:.1f}", flush=True)
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
