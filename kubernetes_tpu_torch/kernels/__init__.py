"""Hand-written CUDA kernels of the port, and their launch wrappers.

K1 `select_hosts` (select_hosts.cu) replaces the JAX package's
ops/select.py select_host / select_hosts_batch.  Its plain PyTorch twin is
ops/select.py `select_hosts_batch_plain`; ops/select.py dispatches to the
kernel for CUDA tensors.

K2 `preempt_one` (preempt_one.cu) replaces the JAX package's
models/preemption.py preempt_one and _exact_prio_sum.  Its plain twin is
models/preemption.py `preempt_one_plain`; models/preemption.py
`preempt_one` dispatches to the kernel for CUDA tensors.

K3 `select_topk` (select_topk.cu) replaces the JAX package's ops/select.py
select_topk / select_topk_batch: the quality observatory's winner-pinned
top-k beside K1's winners.  Its plain twin is ops/select.py
`select_topk_batch_plain`; ops/select.py `select_topk_batch` dispatches.

K4 `binpack_ffd` (binpack_ffd.cu) replaces the scan of the JAX package's
models/binpack.py binpack_ffd: the first-fit packing of the quality
observatory's regret counterfactual.  Its plain twin is models/binpack.py
`binpack_ffd_plain`; models/binpack.py `binpack_ffd` dispatches.

K5 `cluster_analytics` (cluster_analytics.cu) replaces the JAX package's
ops/analytics.py _analytics / cluster_analytics: the telemetry hub's
once-a-cycle analytics of the resident snapshot.  Its plain twin is
ops/analytics.py `cluster_analytics_plain`; ops/analytics.py
`cluster_analytics` dispatches.

K6 `commit_group_counts` (commit_group_counts.cu) replaces the JAX
package's models/megacycle.py _commit_group_counts: the megacycle's
chained SelectorSpread-count commit between two windows.  Its plain twin
is models/megacycle.py `commit_group_counts_plain`; models/megacycle.py
`commit_group_counts` dispatches.

K7 `fold_predicates` (fold_predicates.cu) replaces the fold of the JAX
package's ops/predicates.py filter_batch (`jnp.all(stack, 1) & alive`) and
first_failure, as models/generic.py schedule_batch_independent computes
them for the extender seam.  Its plain twin is ops/predicates.py
`fold_predicates_plain`; ops/predicates.py `fold_predicates` dispatches.

K8 `binpack_counts` (binpack_counts.cu) replaces the scan of the JAX
package's models/binpack.py binpack_ffd_counts: the count-carrying
first-fit of the capacity planner's two stages and of the what-if sweep.
K9 `ffd_order` (ffd_order.cu) replaces models/binpack.py ffd_order, the
shape-relative FFD order each of those lanes packs in.  Their plain twins
are models/binpack.py `binpack_counts_plain` and `ffd_order_plain`;
models/binpack.py `binpack_ffd_counts`, `ffd_order_batch` and their
callers dispatch.

K10 `reconcile_admit` (reconcile_admit.cu) replaces the admission scan of
the JAX package's runtime/reconciler.py ConflictReconciler._kernel: the
replicas' sequenced commit check.  Its plain twin is runtime/reconciler.py
`admit_scan_plain`; runtime/reconciler.py `admit_scan` dispatches.

K11 `filter_pass` (filter_pass.cu) replaces the JAX package's
ops/predicates.py filter_batch: the 23 predicates over the pods x nodes
grid, as the folded mask or as the stack K7 folds, the topology-pair
terms gathered over each node's pairs (pair_gather.cuh, the node-pair
table `node_pair_build` makes once a snapshot upload), in one launch of
blocks over (node slices, pod tiles) on the path filter_pass_paths picks.
K12 `score_pass`
(score_pass.cu) replaces ops/priorities.py score_batch: the 12
priorities, normalized per pod, and their weighted total, the IPA raw
sums gathered the same way and each node's zone read from the same table,
in one launch of thread-block clusters over the node axis, a tile of
pods a cluster.  Their plain twins are ops/predicates.py
`filter_batch_plain` / `predicate_stack_plain` and ops/priorities.py
`score_batch_plain`; `filter_batch`, `predicate_stack` and `score_batch`
there dispatch.  Each takes its arguments as one struct by value
(`FilterPassArgs`, `ScorePassArgs`).

K13 `seq_scan` (seq_scan.cu) replaces the JAX package's models/batched.py
schedule_impl: the sequential engine's whole scan of a batch in one
launch of one thread-block cluster (its nodes spread over the cluster's
blocks, the carried node state in their shared memory), with an affinity
mode that carries the in-batch pair state; its twin is models/batched.py
`scan_plain`.  K15 `round_fold`
(round_fold.cu), K14 `round_commit` (round_commit.cu, two launches) and
K16 `round_pairs` (round_pairs.cu) replace the parts of
models/speculative.py _round around the selector: K15 and K14 each with
an affinity mode (the IPA score; the same round's anti order, the
inversion sentinel and the deferred retirement), K16 the affinity state's
pair commit and bootstrap gate; their twins are models/speculative.py
`round_fold_plain`, `round_commit_plain` and `round_pairs_plain`.
round_graph.cu holds the CUDA graph API the speculative engine builds a
batch's graph with (a WHILE node over the rounds, an IF node over the
redo) and its two condition kernels.  K13's, K14's, K15's and K16's
arguments are one struct by value each (`SeqScanArgs`, `RoundCommitArgs`,
`RoundFoldArgs`, `RoundPairsArgs`).

Each wrapper counts its launches in `LAUNCHES` (one each time it launches
its kernels, nowhere else), so a run can show that its main path went
through the kernels; `select_hosts_b1` also counts K1's one-row launches
(the sequential engine's steps) on their own.  A preempt_one call puts
one kernel launch on the stream, no memset and no copy (chip_smoke.py
counts them under torch.profiler); the first call on a stream also zeroes
that stream's ticket.  K3, K4, K6 and K7 put one kernel launch each on
the stream; K5 one up to K5_ONE_LAUNCH_ROWS snapshot rows and, above, a
sequence of launches (cluster_analytics.cu launch_wide), counted once a
call.  K8 and K10 put one kernel launch each on the stream, K9 one per
K9_MAX_LANES lanes (counted once a call).  K11 puts one launch on the
stream (`filter_pass_stack` also counts those in stack mode,
`filter_pass_candidates` those in candidates mode); K12 one launch of
thread-block clusters (score_pass_paths), counted once a call; K13, K15
and K16 one launch, K14 two, counted once a round; node_pair_build one
launch, once a snapshot upload.  Inside a CUDA graph's capture a launch
queues a node and counts nothing: the capture records the names each
wrapper counts, by section (`capturing`), the
graph's launch is recorded (`graph_launched`) with them and its device
round count and redo flag, and `settle_launches()` adds them (once a
round for the WHILE body, once if it redid for the IF body); read
LAUNCHES through settle_launches().
The kernels are built from source at the first launch
(kernels/_build.py); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

LAUNCHES = {"select_hosts": 0, "select_hosts_b1": 0, "preempt_one": 0,
            "select_topk": 0, "select_topk_b1": 0, "binpack_ffd": 0,
            "cluster_analytics": 0, "commit_group_counts": 0,
            "fold_predicates": 0, "ffd_order": 0, "binpack_counts": 0,
            "reconcile_admit": 0, "filter_pass": 0, "filter_pass_stack": 0,
            "filter_pass_candidates": 0, "score_pass": 0, "seq_scan": 0, "round_fold": 0,
            "round_commit": 0, "round_graph": 0, "round_pairs": 0,
            "node_pair_build": 0}

# K1's variants, by the code select_hosts_launch takes: a block of 8 warps
# to a row, one warp to a row (8 rows to a block), or a block to a row that
# is read twice; float4 loads (N % 4 == 0 and aligned pointers) or scalar
# ones.
K1_VARIANTS = ("block_vec4", "block_scalar", "warp_vec4", "warp_scalar",
               "long_vec4", "long_scalar")
# rows this short take a warp each when B > 1: 2.1-2.5x faster than a
# block a row at B = 2048 (PERF.md, tools/k1_compare.py)
K1_WARP_MAX_N = 1024
K1_ONE_READ_MAX_N = 8192  # rows up to this width are read once
K2_MAX_SLOTS = 1024       # victim slots (sorted_victim_slots' cap)
K4_THREADS = 1024         # K4's one block
K5_ONE_LAUNCH_ROWS = 16384  # above, K5 runs its multi-block sequence
K5_WORDS = 40             # K5's output: ops/analytics.py PACKED_LAYOUT
K9_MAX_LANES = 65535      # lanes of one K9 launch (its grid's y extent)
# K2's ticket: one uint32 a (device, stream), zero between launches (each
# launch's last block sets it back)
_K2_TICKETS: dict = {}


# Set while this thread captures a CUDA graph (a capturing context): its
# launches queue graph nodes, recorded by the capture and counted when the
# graph's launches settle (settle_launches).
_CAPTURE = threading.local()


def _count(name: str) -> None:
    """One launch of `name`'s kernels; while this thread is capturing, one
    launch recorded by the capture instead."""
    cap = getattr(_CAPTURE, "on", None)
    if cap is None:
        LAUNCHES[name] += 1
    else:
        cap.record(name)


def reset_launch_counts() -> None:
    _GRAPH_PENDING.clear()
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def wrap_i32(x: int) -> int:
    """A Python int reduced to the int32 value two's-complement arithmetic
    gives (the reference's rotation counters are int32 and wrap)."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def k1_variant(B: int, N: int, scores_ptr: int, mask_ptr: int) -> int:
    """The K1 variant for a [B, N] launch from these addresses: an index
    into K1_VARIANTS."""
    vec4 = N % 4 == 0 and scores_ptr % 16 == 0 and mask_ptr % 4 == 0
    if B > 1 and N <= K1_WARP_MAX_N:
        route = 2
    elif N <= K1_ONE_READ_MAX_N:
        route = 0
    else:
        route = 4
    return route + int(not vec4)


def _check_rows(name: str, scores: torch.Tensor, mask: torch.Tensor) -> None:
    if not (scores.is_cuda and mask.is_cuda):
        raise ValueError(f"{name} launches on CUDA tensors only")
    if scores.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"{name} wants f32 scores and a bool mask, got "
                        f"{scores.dtype} and {mask.dtype}")
    if scores.dim() != 2 or mask.shape != scores.shape:
        raise ValueError(f"{name} wants matching [B, N] scores and mask, "
                         f"got {tuple(scores.shape)} and {tuple(mask.shape)}")
    if scores.device != mask.device:
        raise ValueError("scores and mask lie on different devices")


def select_hosts_prepare(scores: torch.Tensor, mask: torch.Tensor,
                         last_index):
    """K1 prepared: (launch, (hosts i32[B], feasible bool[B])) on the
    tensors' CUDA device for (scores f32[B, N], mask bool[B, N]); row b
    rotates its tie-break by last_index + b, where last_index is a host int
    or an i32[] on the scores' device that the kernel reads (a CUDA graph's
    counter).  launch() queues the kernel on the current stream and
    allocates nothing.  The variant follows from (B, N, alignment), see
    k1_variant.  Raises on anything the kernel does not take; launch()
    raises on a refused launch."""
    _check_rows("select_hosts", scores, mask)
    B, N = scores.shape
    if N == 0 or N >= (1 << 31):
        raise ValueError(f"select_hosts wants 0 < N < 2^31, got {N}")
    on_device = isinstance(last_index, torch.Tensor)
    if on_device and (last_index.dtype != torch.int32
                      or last_index.shape != ()
                      or last_index.device != scores.device):
        raise ValueError("select_hosts wants a device last_index as an "
                         "i32[] on the scores' device")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    scores = scores.contiguous()
    mask = mask.contiguous()
    hosts = torch.empty(B, dtype=torch.int32, device=scores.device)
    feasible = torch.empty(B, dtype=torch.bool, device=scores.device)
    variant = k1_variant(B, N, scores.data_ptr(), mask.data_ptr())
    li = last_index if on_device else wrap_i32(last_index)

    def launch():
        stream = torch.cuda.current_stream().cuda_stream
        if on_device:
            err = lib.select_hosts_launch_dev(
                scores.data_ptr(), mask.data_ptr(), B, N, li.data_ptr(),
                hosts.data_ptr(), feasible.data_ptr(), variant, stream)
        else:
            err = lib.select_hosts_launch(
                scores.data_ptr(), mask.data_ptr(), B, N, li,
                hosts.data_ptr(), feasible.data_ptr(), variant, stream)
        _launch_error(lib, "select_hosts", err)
        if B:
            _count("select_hosts")
            if B == 1:
                _count("select_hosts_b1")

    return launch, (hosts, feasible)


def select_hosts(scores: torch.Tensor, mask: torch.Tensor, last_index0):
    """K1: (scores f32[B, N], mask bool[B, N], last_index0) -> (hosts
    i32[B], feasible bool[B]), launched at once on the tensors' CUDA
    device; see select_hosts_prepare."""
    launch, out = select_hosts_prepare(scores, mask, last_index0)
    with torch.cuda.device(scores.device):
        launch()
    return out


def noop_launch() -> None:
    """Launch an empty kernel with K1's block shape on the current stream:
    the floor under a B=1 launch, for timing.  Not counted."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    err = lib.select_hosts_noop_launch(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("noop launch failed: "
                           + lib.select_hosts_error_string(err).decode())


_K2_ARGS = (
    # name, dtype, dims (None: any length, named: must agree)
    ("requested", torch.float32, ("N", "E")),
    ("allocatable", torch.float32, ("N", "E")),
    ("pod_req", torch.float32, ("E",)),
    ("candidates", torch.bool, ("N",)),
    ("pods_node", torch.int32, ("M",)),
    ("pods_priority", torch.int32, ("M",)),
    ("pods_req", torch.float32, ("M", "E")),
    ("pods_violating", torch.bool, ("M",)),
    ("pods_start", torch.float32, ("M",)),
    ("victim_slots", torch.int32, ("K",)),
    ("slot_vids", torch.int32, ("K", "VM")),
    ("vid_type", torch.int32, ("V",)),
    ("vid_total", torch.int32, ("V",)),
    ("vid_listed", torch.int32, ("V",)),
    ("freed_vol_init", torch.float32, ("N", "VT")),
)


def preempt_one(*tensors):
    """K2: the preemption pick for one preemptor, on the tensors' CUDA
    device.  Arguments in order (see models/preemption.py
    preempt_one_plain for their meaning): requested, allocatable f32[N, E],
    pod_req f32[E], candidates bool[N], pods_node, pods_priority i32[M],
    pods_req f32[M, E], pods_violating bool[M], pods_start f32[M],
    victim_slots i32[K] (distinct arena indices in [0, M), -1 pads),
    slot_vids i32[K, VM], vid_type, vid_total, vid_listed i32[V] (volume
    identities node-local, as encoder.victim_volume_tables makes them),
    freed_vol_init f32[N, VT].  Returns (node i32[], victim_mask bool[M],
    n_victims i32[], n_pdb_violations i32[]).  Raises on anything the kernel
    does not take and on a refused launch."""
    if len(tensors) != len(_K2_ARGS):
        raise TypeError(f"preempt_one takes {len(_K2_ARGS)} tensors, got "
                        f"{len(tensors)}")
    dims: dict = {}
    device = tensors[0].device
    for t, (name, dtype, shape) in zip(tensors, _K2_ARGS):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"preempt_one launches on CUDA tensors only "
                             f"({name})")
        if t.device != device:
            raise ValueError(f"preempt_one: {name} lies on {t.device}, "
                             f"requested on {device}")
        if t.dtype != dtype:
            raise TypeError(f"preempt_one wants {name} as {dtype}, got "
                            f"{t.dtype}")
        if t.dim() != len(shape):
            raise ValueError(f"preempt_one wants {name} of {len(shape)} "
                             f"dims, got {tuple(t.shape)}")
        for d, size in zip(shape, t.shape):
            if dims.setdefault(d, size) != size:
                raise ValueError(f"preempt_one: {name} has {d}={size}, "
                                 f"other inputs {dims[d]}")
    N, E, M, K = dims["N"], dims["E"], dims["M"], dims["K"]
    VM, V, VT = dims["VM"], dims["V"], dims["VT"]
    if not (0 < N < (1 << 27) and 0 < M < (1 << 31) - 1 and 0 < VM
            and 0 < V):
        raise ValueError(f"preempt_one: sizes N={N} M={M} VM={VM} V={V} "
                         f"out of range")
    if not 0 < K <= K2_MAX_SLOTS:
        raise ValueError(f"preempt_one takes 1 to {K2_MAX_SLOTS} victim "
                         f"slots, got {K}")
    if not (0 < E and VT <= E and N * E < (1 << 31)):
        raise ValueError(f"preempt_one takes E >= 1 columns with VT <= E "
                         f"and N * E < 2^31, got N={N} E={E} VT={VT}")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in tensors]
    workspace = torch.empty(lib.preempt_one_workspace_ints(N, K, V, E),
                            dtype=torch.int32, device=device)
    node = torch.empty((), dtype=torch.int32, device=device)
    victim_mask = torch.empty(M, dtype=torch.bool, device=device)
    n_victims = torch.empty((), dtype=torch.int32, device=device)
    n_viol = torch.empty((), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        ticket = _K2_TICKETS.get((device, stream))
        if ticket is None:
            ticket = _K2_TICKETS[(device, stream)] = torch.zeros(
                1, dtype=torch.int32, device=device)
        err = lib.preempt_one_launch(
            *(t.data_ptr() for t in ts), N, E, M, K, VM, V, VT,
            workspace.data_ptr(), ticket.data_ptr(), node.data_ptr(),
            victim_mask.data_ptr(), n_victims.data_ptr(), n_viol.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError("preempt_one launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["preempt_one"] += 1
    return node, victim_mask, n_victims, n_viol


def select_topk_prepare(scores: torch.Tensor, mask: torch.Tensor,
                        hosts: torch.Tensor, feasible: torch.Tensor, k: int):
    """K3 prepared: (launch, (top_nodes i32[B, K], top_scores f32[B, K],
    feasible_count i32[B])) with K = min(k, N), on the tensors' CUDA device,
    for (scores f32[B, N], mask bool[B, N], hosts i32[B], feasible
    bool[B]); hosts and feasible are the selector's verdict on the same
    rows (see ops/select.py select_topk_batch_plain).  launch() queues the
    kernel on the current stream (nothing at B = 0) and allocates nothing.
    Raises on anything the kernel does not take; launch() raises on a
    refused launch."""
    _check_rows("select_topk", scores, mask)
    B, N = scores.shape
    if hosts.shape != (B,) or feasible.shape != (B,):
        raise ValueError(f"select_topk wants hosts and feasible of shape "
                         f"({B},), got {tuple(hosts.shape)} and "
                         f"{tuple(feasible.shape)}")
    if hosts.dtype != torch.int32 or feasible.dtype != torch.bool:
        raise TypeError(f"select_topk wants i32 hosts and bool feasible, "
                        f"got {hosts.dtype} and {feasible.dtype}")
    if hosts.device != scores.device or feasible.device != scores.device:
        raise ValueError("select_topk: hosts or feasible lie on another "
                         "device than the scores")
    if N == 0 or N >= (1 << 31) - 1:
        raise ValueError(f"select_topk wants 0 < N < 2^31 - 1, got {N}")
    if k < 1:
        raise ValueError(f"select_topk wants k >= 1, got {k}")
    K = min(int(k), N)
    dev = scores.device
    out = (torch.empty((B, K), dtype=torch.int32, device=dev),
           torch.empty((B, K), dtype=torch.float32, device=dev),
           torch.empty(B, dtype=torch.int32, device=dev))
    if B == 0:
        return (lambda: None), out
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (scores, mask, hosts, feasible)]

    def launch():
        _launch_error(lib, "select_topk", lib.select_topk_launch(
            *(t.data_ptr() for t in ts), B, N, K,
            *(t.data_ptr() for t in out),
            torch.cuda.current_stream().cuda_stream))
        _count("select_topk")
        if B == 1:
            _count("select_topk_b1")

    return launch, out


def select_topk(scores: torch.Tensor, mask: torch.Tensor,
                hosts: torch.Tensor, feasible: torch.Tensor, k: int):
    """K3: (top_nodes i32[B, K], top_scores f32[B, K], feasible_count
    i32[B]), launched at once on the tensors' CUDA device; see
    select_topk_prepare."""
    launch, out = select_topk_prepare(scores, mask, hosts, feasible, k)
    with torch.cuda.device(scores.device):
        launch()
    return out


def binpack_ffd(pod_reqs: torch.Tensor, capacity: torch.Tensor,
                order: torch.Tensor, max_bins=None):
    """K4: first-fit of the pods pod_reqs f32[P, R], taken in `order`
    i32[P], into bins of capacity f32[N, R] (one row a bin; max_bins, if
    given, must be N) or f32[R] (max_bins bins of that capacity).  Returns
    (used i32[], loads f32[N, R], placed bool[P]) on the tensors' CUDA
    device, see models/binpack.py binpack_ffd_plain.  Raises on anything
    the kernel does not take and on a refused launch."""
    for name, t in (("pod_reqs", pod_reqs), ("capacity", capacity),
                    ("order", order)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"binpack_ffd launches on CUDA tensors only "
                             f"({name})")
        if t.device != pod_reqs.device:
            raise ValueError(f"binpack_ffd: {name} lies on {t.device}, "
                             f"pod_reqs on {pod_reqs.device}")
    if pod_reqs.dtype != torch.float32 or capacity.dtype != torch.float32:
        raise TypeError(f"binpack_ffd wants f32 requests and capacity, got "
                        f"{pod_reqs.dtype} and {capacity.dtype}")
    if order.dtype != torch.int32:
        raise TypeError(f"binpack_ffd wants an i32 order, got {order.dtype}")
    if pod_reqs.dim() != 2:
        raise ValueError(f"binpack_ffd wants pod_reqs [P, R], got "
                         f"{tuple(pod_reqs.shape)}")
    P, R = pod_reqs.shape
    if capacity.dim() == 2:
        N = capacity.shape[0]
        if capacity.shape[1] != R or (max_bins is not None
                                      and max_bins != N):
            raise ValueError(f"binpack_ffd wants capacity [max_bins, {R}], "
                             f"got {tuple(capacity.shape)} with max_bins "
                             f"{max_bins}")
        cap_stride = R
    elif capacity.dim() == 1 and capacity.shape[0] == R and max_bins:
        N = int(max_bins)
        cap_stride = 0
    else:
        raise ValueError(f"binpack_ffd wants capacity [N, {R}], or [{R}] "
                         f"with max_bins, got {tuple(capacity.shape)}")
    if order.shape != (P,):
        raise ValueError(f"binpack_ffd wants order of shape ({P},), got "
                         f"{tuple(order.shape)}")
    if R <= 0:
        raise ValueError(f"binpack_ffd wants R >= 1 resource columns, got "
                         f"{R}")
    if not (0 < N and N * R < (1 << 31) and P < (1 << 31)):
        raise ValueError(f"binpack_ffd: sizes N={N} R={R} P={P} out of "
                         f"range")
    dev = pod_reqs.device
    loads = torch.empty((N, R), dtype=torch.float32, device=dev)
    placed = torch.empty(P, dtype=torch.bool, device=dev)
    used = torch.empty((), dtype=torch.int32, device=dev)
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    smem = lib.binpack_ffd_smem_bytes(N, R)
    # loads live in shared memory when they fit, else in this workspace
    work = torch.empty(0 if smem else N * R, dtype=torch.float32,
                       device=dev)
    ts = [t.contiguous() for t in (pod_reqs, capacity, order)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.binpack_ffd_launch(
            ts[0].data_ptr(), P, R, ts[1].data_ptr(), cap_stride,
            ts[2].data_ptr(), N, work.data_ptr(), loads.data_ptr(),
            placed.data_ptr(), used.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("binpack_ffd launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["binpack_ffd"] += 1
    return used, loads, placed


def barrier_floor_launch(steps: int) -> None:
    """Launch K4's block shape running `steps` steps of nothing but its
    per-step reduction and barrier: the floor under a K4 launch of that
    many pods, for timing.  Not counted."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    err = lib.binpack_ffd_floor_launch(
        int(steps), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("floor launch failed: "
                           + lib.select_hosts_error_string(err).decode())


def cluster_analytics(allocatable: torch.Tensor, requested: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """K5: the analytics of one snapshot, allocatable and requested f32[N,
    R >= 4] and valid bool[N] on one CUDA device, as one int32[40] buffer
    in ops/analytics.py PACKED_LAYOUT (f32 fields as their bits), see
    ops/analytics.py cluster_analytics_plain.  Launches on the current
    stream, so it reads the tensors as the stream's earlier work (the
    snapshot's in-place scatter) left them.  Raises on anything the kernel
    does not take and on a refused launch."""
    for name, t in (("allocatable", allocatable), ("requested", requested),
                    ("valid", valid)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"cluster_analytics launches on CUDA tensors "
                             f"only ({name})")
        if t.device != allocatable.device:
            raise ValueError(f"cluster_analytics: {name} lies on "
                             f"{t.device}, allocatable on "
                             f"{allocatable.device}")
    if allocatable.dtype != torch.float32 or requested.dtype != torch.float32:
        raise TypeError(f"cluster_analytics wants f32 tables, got "
                        f"{allocatable.dtype} and {requested.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError(f"cluster_analytics wants a bool mask, got "
                        f"{valid.dtype}")
    if (allocatable.dim() != 2 or requested.shape != allocatable.shape
            or valid.shape != allocatable.shape[:1]):
        raise ValueError(f"cluster_analytics wants [N, R] tables and an "
                         f"[N] mask, got {tuple(allocatable.shape)}, "
                         f"{tuple(requested.shape)}, {tuple(valid.shape)}")
    N, R = allocatable.shape
    if R < 4:
        raise ValueError(f"cluster_analytics wants R >= 4 columns, got {R}")
    if N >= (1 << 30):
        raise ValueError(f"cluster_analytics wants N < 2^30 rows, got {N}")
    dev = allocatable.device
    out = torch.empty(K5_WORDS, dtype=torch.int32, device=dev)
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (allocatable, requested, valid)]
    # the multi-block sequence's partial sums, counts and histograms
    work = torch.empty(lib.cluster_analytics_workspace_ints(N),
                       dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cluster_analytics_launch(
            *(t.data_ptr() for t in ts), N, R, out.data_ptr(),
            work.data_ptr() if work.numel() else None, stream)
    if err != 0:
        raise RuntimeError("cluster_analytics launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["cluster_analytics"] += 1
    return out


def commit_group_counts(gc: torch.Tensor, hosts: torch.Tensor,
                        group_ids: torch.Tensor,
                        group_valid: torch.Tensor) -> torch.Tensor:
    """K6: one megacycle window's spread-count commit, gc f32[N, G] plus
    one for every valid (pod, slot) of group_ids i32[B, S] / group_valid
    bool[B, S] whose pod's winner hosts i32[B] is a row of gc, as a NEW
    f32[N, G] tensor on the tensors' CUDA device (gc is not written), see
    models/megacycle.py commit_group_counts_plain.  Raises on anything the
    kernel does not take and on a refused launch."""
    for name, t in (("gc", gc), ("hosts", hosts), ("group_ids", group_ids),
                    ("group_valid", group_valid)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"commit_group_counts launches on CUDA tensors "
                             f"only ({name})")
        if t.device != gc.device:
            raise ValueError(f"commit_group_counts: {name} lies on "
                             f"{t.device}, gc on {gc.device}")
    if (gc.dtype != torch.float32 or hosts.dtype != torch.int32
            or group_ids.dtype != torch.int32
            or group_valid.dtype != torch.bool):
        raise TypeError(f"commit_group_counts wants f32 gc, i32 hosts and "
                        f"group_ids and a bool group_valid, got {gc.dtype}, "
                        f"{hosts.dtype}, {group_ids.dtype}, "
                        f"{group_valid.dtype}")
    if (gc.dim() != 2 or hosts.dim() != 1 or group_ids.dim() != 2
            or group_valid.shape != group_ids.shape
            or group_ids.shape[0] != hosts.shape[0]):
        raise ValueError(f"commit_group_counts wants gc [N, G], hosts [B] "
                         f"and group slots [B, S], got {tuple(gc.shape)}, "
                         f"{tuple(hosts.shape)}, {tuple(group_ids.shape)}, "
                         f"{tuple(group_valid.shape)}")
    N, G = gc.shape
    B, S = group_ids.shape
    if N >= (1 << 31) or G >= (1 << 31) or B * S >= (1 << 62):
        raise ValueError(f"commit_group_counts: sizes N={N} G={G} B={B} "
                         f"S={S} out of range")
    out = torch.empty((N, G), dtype=torch.float32, device=gc.device)
    if N == 0 or G == 0:
        return out
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (gc, hosts, group_ids, group_valid)]
    with torch.cuda.device(gc.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.commit_group_counts_launch(
            *(t.data_ptr() for t in ts), N, G, B, S, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("commit_group_counts launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["commit_group_counts"] += 1
    return out


def fold_predicates(per_pred: torch.Tensor, valid: torch.Tensor,
                    pod_valid: torch.Tensor):
    """K7: the fold of one filter pass, per_pred bool[B, K, N] (K >= 1
    predicate rows), valid bool[N] and pod_valid bool[B] on one CUDA
    device -> (mask bool[B, N], failure i32[B, N]), see ops/predicates.py
    fold_predicates_plain.  Raises on anything the kernel does not take
    and on a refused launch."""
    for name, t in (("per_pred", per_pred), ("valid", valid),
                    ("pod_valid", pod_valid)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"fold_predicates launches on CUDA tensors only "
                             f"({name})")
        if t.device != per_pred.device:
            raise ValueError(f"fold_predicates: {name} lies on {t.device}, "
                             f"per_pred on {per_pred.device}")
        if t.dtype != torch.bool:
            raise TypeError(f"fold_predicates wants bool {name}, got "
                            f"{t.dtype}")
    if per_pred.dim() != 3:
        raise ValueError(f"fold_predicates wants per_pred [B, K, N], got "
                         f"{tuple(per_pred.shape)}")
    B, K, N = per_pred.shape
    if valid.shape != (N,) or pod_valid.shape != (B,):
        raise ValueError(f"fold_predicates wants valid ({N},) and pod_valid "
                         f"({B},), got {tuple(valid.shape)} and "
                         f"{tuple(pod_valid.shape)}")
    if K < 1 or B * K * N >= (1 << 62) or N >= (1 << 31) or B >= (1 << 31):
        raise ValueError(f"fold_predicates: sizes B={B} K={K} N={N} out of "
                         f"range")
    dev = per_pred.device
    mask = torch.empty((B, N), dtype=torch.bool, device=dev)
    failure = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return mask, failure
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (per_pred, valid, pod_valid)]
    vec = int(N % 4 == 0 and ts[0].data_ptr() % 4 == 0
              and ts[1].data_ptr() % 4 == 0 and mask.data_ptr() % 4 == 0
              and failure.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fold_predicates_launch(
            *(t.data_ptr() for t in ts), B, K, N, vec, mask.data_ptr(),
            failure.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("fold_predicates launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["fold_predicates"] += 1
    return mask, failure


def _cuda_args(name: str, specs) -> torch.device:
    """Check (tensor, dtype, label) triples for one launch: CUDA, one
    device, the dtype.  Returns the device."""
    dev = None
    for t, dtype, label in specs:
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} launches on CUDA tensors only "
                             f"({label})")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {label} lies on {t.device}, the "
                             f"first argument on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} wants {dtype} {label}, got {t.dtype}")
    return dev


def _launch_error(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.select_hosts_error_string(err).decode())


def ffd_order(reqs: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """K9: the FFD order of the items reqs f32[C, R] under each lane's
    capacity caps f32[S, R], on their CUDA device -> order i32[S, C]; see
    models/binpack.py ffd_order_plain.  Lanes past the grid's 65,535 go in
    more launches of the same call (counted once).  Raises on anything the
    kernel does not take and on a refused launch."""
    dev = _cuda_args("ffd_order", ((reqs, torch.float32, "reqs"),
                                   (caps, torch.float32, "caps")))
    if reqs.dim() != 2 or caps.dim() != 2 or caps.shape[1] != reqs.shape[1]:
        raise ValueError(f"ffd_order wants reqs [C, R] and caps [S, R], got "
                         f"{tuple(reqs.shape)} and {tuple(caps.shape)}")
    C, R = reqs.shape
    S = caps.shape[0]
    if C <= 0 or R <= 0 or C * R >= (1 << 31) or S * C >= (1 << 62):
        raise ValueError(f"ffd_order: sizes C={C} R={R} S={S} out of range")
    order = torch.empty((S, C), dtype=torch.int32, device=dev)
    if S == 0:
        return order
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    reqs = reqs.contiguous()
    caps = caps.contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for s0 in range(0, S, K9_MAX_LANES):
            s1 = min(S, s0 + K9_MAX_LANES)
            _launch_error(lib, "ffd_order", lib.ffd_order_launch(
                reqs.data_ptr(), C, R, caps[s0:s1].data_ptr(), s1 - s0,
                order[s0:s1].data_ptr(), stream))
    LAUNCHES["ffd_order"] += 1
    return order


# K8's layout (binpack_counts.cu make_layout, mirrored here): a warp a
# lane, as many lanes a block as K8_SMEM_BYTES of shared memory hold, or a
# block a lane where the lanes are fewer than the SMs (stage 1's per-bin
# lane among them); the columns held are those some class requests
# (int(req) != 0), which the kernel finds itself; the class table (m,
# real, the held requests and their multipliers) staged where it takes at
# most K8_TABLE_MAX bytes; a lane's loads (tier 1), and its summaries too
# (tier 2), in the workspace where they do not fit (K8_WORK_LANES slots a
# block).
K8_CHUNK = 32
K8_SMEM_BYTES = 220 * 1024
K8_TABLE_MAX = 32 * 1024
K8_WORK_LANES = 2
K8_THREADS = 256           # a block's: at most 8 lanes, or a lane's warps


class BinpackCountsPath(NamedTuple):
    """The path one K8 launch takes (binpack_counts_paths)."""

    block: bool         # a block a lane (else a warp a lane)
    grid: int           # blocks of K8_THREADS
    held: int           # columns held (some class requests them)
    lanes: int          # lanes a block at once
    tier: int           # 0 shared memory; 1 loads, 2 summaries too in the
                        # global workspace
    staged: bool        # the class table in shared memory


def _k8_layout(nb: int, R: int, C: int, held: int, per_bin: bool,
               block: bool):
    """(lanes, tier, staged) of make_layout in binpack_counts.cu."""
    warps = K8_THREADS // 32
    nch = -(-nb // K8_CHUNK)
    words = -(-nch // 32)
    tw = (2 + 2 * held) * C
    tw = tw if tw * 4 <= K8_TABLE_MAX else 0
    lane0 = 2 * R + tw + (words if block else 0) + warps * 2 * held
    room = K8_SMEM_BYTES // 4 - lane0
    most = 1 if block else warps
    tiers = (held + held * nch + held * nb * (2 if per_bin else 1),
             held + held * nch, held)
    tier, fit = 2, 0
    for t, words_a_lane in enumerate(tiers):
        fit = room // words_a_lane if words_a_lane else most
        if fit >= 1:
            tier = t
            break
    if tier > 0:
        fit = min(fit, K8_WORK_LANES)
    return min(fit, most), tier, tw != 0


def binpack_counts_paths(S: int, nb: int, R: int, C: int, held: int,
                         per_bin: bool, sms: int = 132) -> BinpackCountsPath:
    """The path of a K8 launch of S lanes of nb bins over C classes of R
    columns, `held` of them requested by some class, on a card of `sms`
    SMs: a block a lane where S < sms (a lane then has an SM of its own),
    else a warp a lane.  Sizes only: the CPU tests check it.  Raises
    where no layout holds a lane."""
    if S <= 0 or nb <= 0 or R <= 0 or C <= 0 or not 0 <= held <= R:
        raise ValueError(f"binpack_counts_paths: S={S} nb={nb} R={R} C={C} "
                         f"held={held}")
    block = S < sms
    lanes, tier, staged = _k8_layout(nb, R, C, held, per_bin, block)
    if lanes < 1:
        raise ValueError(f"binpack_counts: no layout holds a lane of {nb} "
                         f"bins x {held} columns over {C} classes")
    return BinpackCountsPath(block, min(S, sms), held, lanes, tier, staged)


def binpack_counts_held(reqs) -> int:
    """The columns some class of reqs [C, R] requests (int(req) != 0):
    what K8 holds.  A host read on a CUDA tensor (the tests and tools)."""
    r = torch.as_tensor(reqs).detach().to("cpu")
    return int((r.to(torch.int32) != 0).any(0).sum())


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def binpack_counts_path(reqs, caps, order, n_bins: int, per_bin: bool,
                        sms: int = 132) -> BinpackCountsPath:
    """The BinpackCountsPath a K8 launch takes on these inputs (on any
    device)."""
    S = int(order.shape[0])
    C, R = (int(x) for x in reqs.shape)
    if isinstance(reqs, torch.Tensor) and reqs.is_cuda:
        sms = _sms(reqs.device.index or 0)
    return binpack_counts_paths(S, int(n_bins), R, C,
                                binpack_counts_held(reqs), bool(per_bin),
                                sms)


def binpack_counts_prepare(reqs: torch.Tensor, counts: torch.Tensor,
                           caps: torch.Tensor, order: torch.Tensor,
                           n_bins: int, per_bin: bool,
                           want_loads: bool = False, path_out=None):
    """The arguments of one K8 launch (see binpack_counts) with its outputs
    allocated: (the launch's arguments before the stream, the tensors they
    point into, (used, placed, loads, touched)).  The launch shape comes
    from binpack_counts_paths on the sizes; the kernel finds the held
    columns itself, so the workspace is allocated wherever some held
    count would need it.
    path_out: an i32[3] CUDA tensor the kernel writes its path into (its
    path bits, lanes a block, held columns), or None."""
    dev = _cuda_args("binpack_counts", (
        (reqs, torch.float32, "reqs"), (counts, torch.int32, "counts"),
        (caps, torch.float32, "caps"), (order, torch.int32, "order")))
    if reqs.dim() != 2 or counts.shape != (reqs.shape[0],):
        raise ValueError(f"binpack_counts wants reqs [C, R] and counts [C], "
                         f"got {tuple(reqs.shape)} and "
                         f"{tuple(counts.shape)}")
    C, R = reqs.shape
    S = order.shape[0] if order.dim() == 2 else -1
    want_caps = (n_bins, R) if per_bin else (S, R)
    if order.dim() != 2 or order.shape[1] != C or caps.shape != want_caps \
            or (per_bin and S != 1):
        raise ValueError(f"binpack_counts wants order [S, {C}] and caps "
                         f"{'[n_bins, R] with S 1' if per_bin else '[S, R]'}"
                         f", got {tuple(order.shape)} and "
                         f"{tuple(caps.shape)} (n_bins {n_bins})")
    if (C <= 0 or R <= 0 or S <= 0 or n_bins <= 0
            or n_bins * R >= (1 << 31) or C * R >= (1 << 31)):
        raise ValueError(f"binpack_counts: sizes C={C} R={R} S={S} "
                         f"n_bins={n_bins} out of range")
    sms = _sms(dev.index if dev.index is not None
               else torch.cuda.current_device())
    paths = [binpack_counts_paths(S, n_bins, R, C, h, per_bin, sms)
             for h in range(R + 1)]
    p = paths[-1]
    ts = [t.contiguous() for t in (reqs, counts, caps, order)]
    used = torch.empty(S, dtype=torch.int32, device=dev)
    placed = torch.empty((S, C), dtype=torch.int32, device=dev)
    loads = (torch.empty((S, n_bins, R), dtype=torch.float32, device=dev)
             if want_loads else None)
    touched = (torch.empty(n_bins, dtype=torch.bool, device=dev)
               if per_bin else None)
    nch = -(-n_bins // K8_CHUNK)
    slot = R * (n_bins * (2 if per_bin else 1) + nch)
    work = (torch.empty(p.grid * K8_WORK_LANES * slot, dtype=torch.float32,
                        device=dev)
            if any(q.tier for q in paths) else None)
    if path_out is not None:
        _cuda_args("binpack_counts", ((path_out, torch.int32, "path_out"),))
    args = (ts[0].data_ptr(), ts[1].data_ptr(), C, R, ts[2].data_ptr(),
            int(per_bin), int(n_bins), ts[3].data_ptr(), S, int(p.block),
            p.grid, work.data_ptr() if work is not None else None,
            used.data_ptr(), placed.data_ptr(),
            loads.data_ptr() if loads is not None else None,
            touched.data_ptr() if touched is not None else None,
            path_out.data_ptr() if path_out is not None else None)
    return args, (ts, work, path_out), (used, placed, loads, touched)


def binpack_counts(reqs: torch.Tensor, counts: torch.Tensor,
                   caps: torch.Tensor, order: torch.Tensor, n_bins: int,
                   per_bin: bool, want_loads: bool = False, path_out=None):
    """K8: the count-carrying first-fit scan of classes reqs f32[C, R] with
    counts i32[C], in order i32[S, C], on one CUDA device.  Uniform
    (per_bin False): lane s packs into n_bins bins of caps[s] (caps
    f32[S, R]).  Per-bin (per_bin True, S 1): bin b has capacity caps[b]
    (caps f32[n_bins, R]).  Returns (used i32[S], placed i32[S, C] in scan
    positions, loads f32[S, n_bins, R] or None, touched bool[n_bins] in
    per-bin mode else None); see models/binpack.py binpack_counts_plain.
    path_out (an i32[3] CUDA tensor, or None) receives the path the
    kernel took (binpack_counts_prepare).  Raises on anything the kernel
    does not take and on a refused launch."""
    args, keep, outs = binpack_counts_prepare(
        reqs, counts, caps, order, n_bins, per_bin, want_loads, path_out)
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    with torch.cuda.device(reqs.device):
        _launch_error(lib, "binpack_counts", lib.binpack_counts_launch(
            *args, torch.cuda.current_stream().cuda_stream))
    LAUNCHES["binpack_counts"] += 1
    return outs


def binpack_counts_took(path_out: torch.Tensor, path: BinpackCountsPath
                        ) -> bool:
    """Does the path the kernel wrote (path_out of a launch) match
    `path`?"""
    bits, lanes, held = (int(x) for x in path_out.tolist())
    return (bits == (int(path.block) | path.tier << 1
                     | int(path.staged) << 3)
            and lanes == path.lanes and held == path.held)


def reconcile_admit(u_node: torch.Tensor, u_ns: torch.Tensor,
                    order: torch.Tensor, reqs: torch.Tensor,
                    node_head: torch.Tensor, ns_head: torch.Tensor):
    """K10: the sequenced admission scan over Bp candidate slots, u_node,
    u_ns, order i32[Bp] and reqs, node_head, ns_head f32[Bp, R] on one CUDA
    device -> (admit bool[Bp], quota_ok bool[Bp]) in candidate order; see
    runtime/reconciler.py admit_scan_plain.  Raises on anything the kernel
    does not take and on a refused launch."""
    dev = _cuda_args("reconcile_admit", (
        (u_node, torch.int32, "u_node"), (u_ns, torch.int32, "u_ns"),
        (order, torch.int32, "order"), (reqs, torch.float32, "reqs"),
        (node_head, torch.float32, "node_head"),
        (ns_head, torch.float32, "ns_head")))
    if reqs.dim() != 2:
        raise ValueError(f"reconcile_admit wants reqs [Bp, R], got "
                         f"{tuple(reqs.shape)}")
    Bp, R = reqs.shape
    for t, label in ((u_node, "u_node"), (u_ns, "u_ns"), (order, "order")):
        if t.shape != (Bp,):
            raise ValueError(f"reconcile_admit wants {label} ({Bp},), got "
                             f"{tuple(t.shape)}")
    for t, label in ((node_head, "node_head"), (ns_head, "ns_head")):
        if t.shape != (Bp, R):
            raise ValueError(f"reconcile_admit wants {label} ({Bp}, {R}), "
                             f"got {tuple(t.shape)}")
    if Bp <= 0 or R <= 0 or Bp * R >= (1 << 30):
        raise ValueError(f"reconcile_admit: sizes Bp={Bp} R={R} out of "
                         f"range")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (u_node, u_ns, order, reqs, node_head,
                                   ns_head)]
    admit = torch.empty(Bp, dtype=torch.bool, device=dev)
    quota_ok = torch.empty(Bp, dtype=torch.bool, device=dev)
    work = torch.empty(int(lib.reconcile_admit_workspace_floats(Bp, R)),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch_error(lib, "reconcile_admit", lib.reconcile_admit_launch(
            *(t.data_ptr() for t in ts), Bp, R, work.data_ptr(),
            admit.data_ptr(), quota_ok.data_ptr(), stream))
    LAUNCHES["reconcile_admit"] += 1
    return admit, quota_ok


# ------------------------------------------------- K11 and K12: B1 and B2


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool

# (struct field, "c" cluster / "p" pods, dataclass field, dtype, dims)
_K11_ARGS = (
    ("allocatable", "c", "allocatable", _F32, "N R"),
    ("requested", "c", "requested", _F32, "N R"),
    ("valid", "c", "valid", _BOOL, "N"),
    ("unschedulable", "c", "unschedulable", _BOOL, "N"),
    ("not_ready", "c", "not_ready", _BOOL, "N"),
    ("mem_pressure", "c", "mem_pressure", _BOOL, "N"),
    ("disk_pressure", "c", "disk_pressure", _BOOL, "N"),
    ("pid_pressure", "c", "pid_pressure", _BOOL, "N"),
    ("node_name_id", "c", "node_name_id", _I32, "N"),
    ("label_keys", "c", "label_keys", _I32, "N L"),
    ("label_vals", "c", "label_vals", _I32, "N L"),
    ("label_nums", "c", "label_nums", _F32, "N L"),
    ("taint_key", "c", "taint_key", _I32, "N T"),
    ("taint_val", "c", "taint_val", _I32, "N T"),
    ("taint_effect", "c", "taint_effect", _I32, "N T"),
    ("node_port_pp", "c", "port_pp", _I32, "N P"),
    ("node_port_ip", "c", "port_ip", _I32, "N P"),
    ("node_port_used", "c", "port_used", _BOOL, "N P"),
    ("vol_counts", "c", "vol_counts", _F32, "N VT"),
    ("vol_limits", "c", "vol_limits", _F32, "N VT"),
    ("node_disk_ids", "c", "disk_vol_ids", _I32, "N DVN"),
    ("pod_valid", "p", "valid", _BOOL, "B"),
    ("req", "p", "req", _F32, "B R"),
    ("best_effort", "p", "best_effort", _BOOL, "B"),
    ("node_name_req", "p", "node_name_req", _I32, "B"),
    ("port_pp", "p", "port_pp", _I32, "B Q"),
    ("port_ip", "p", "port_ip", _I32, "B Q"),
    ("port_valid", "p", "port_valid", _BOOL, "B Q"),
    ("tol_key", "p", "tol_key", _I32, "B TT"),
    ("tol_op", "p", "tol_op", _I32, "B TT"),
    ("tol_val", "p", "tol_val", _I32, "B TT"),
    ("tol_effect", "p", "tol_effect", _I32, "B TT"),
    ("tol_valid", "p", "tol_valid", _BOOL, "B TT"),
    ("ns_keys", "p", "ns_keys", _I32, "B NS"),
    ("ns_vals", "p", "ns_vals", _I32, "B NS"),
    ("ns_valid", "p", "ns_valid", _BOOL, "B NS"),
    ("has_req_affinity", "p", "has_req_affinity", _BOOL, "B"),
    ("term_valid", "p", "term_valid", _BOOL, "B S"),
    ("expr_key", "p", "expr_key", _I32, "B S E"),
    ("expr_op", "p", "expr_op", _I32, "B S E"),
    ("expr_vals", "p", "expr_vals", _I32, "B S E V"),
    ("expr_nval", "p", "expr_nval", _I32, "B S E"),
    ("expr_num", "p", "expr_num", _F32, "B S E"),
    ("expr_valid", "p", "expr_valid", _BOOL, "B S E"),
    ("new_vol_counts", "p", "new_vol_counts", _F32, "B VT"),
    ("vol_overlap", "p", "vol_overlap", _F32, "B VT NO"),
    ("disk_ids", "p", "disk_vol_ids", _I32, "B DV"),
    ("vol_fail_all", "p", "vol_fail_all", _BOOL, "B"),
    ("svc_aff_fixed", "p", "svc_aff_fixed", _I32, "B SA"),
    ("svc_aff_d0", "p", "svc_aff_d0", _I32, "B"),
    ("svc_aff_d1", "p", "svc_aff_d1", _I32, "B"),
    ("aff_term_pairs", "p", "aff_term_pairs", _BOOL, "B PT TPA"),
    ("aff_term_valid", "p", "aff_term_valid", _BOOL, "B PT"),
    ("aff_term_self", "p", "aff_term_self", _BOOL, "B PT"),
    ("anti_term_valid", "p", "anti_term_valid", _BOOL, "B AT"),
    ("vol_zone_valid", "p", "vol_zone_valid", _BOOL, "B VZ"),
    ("vol_bind_valid", "p", "vol_bind_valid", _BOOL, "B VB"),
)

_K12_ARGS = (
    ("allocatable", "c", "allocatable", _F32, "N R"),
    ("node_nonzero", "c", "nonzero_req", _F32, "N 2"),
    ("valid", "c", "valid", _BOOL, "N"),
    ("label_keys", "c", "label_keys", _I32, "N L"),
    ("label_vals", "c", "label_vals", _I32, "N L"),
    ("label_nums", "c", "label_nums", _F32, "N L"),
    ("node_name_id", "c", "node_name_id", _I32, "N"),
    ("taint_key", "c", "taint_key", _I32, "N T"),
    ("taint_val", "c", "taint_val", _I32, "N T"),
    ("taint_effect", "c", "taint_effect", _I32, "N T"),
    ("image_id", "c", "image_id", _I32, "N I"),
    ("image_size", "c", "image_size", _F32, "N I"),
    ("avoid_owner", "c", "avoid_owner", _I32, "N A"),
    ("group_counts", "c", "group_counts", _F32, "N G"),
    ("pod_nonzero", "p", "nonzero_req", _F32, "B 2"),
    ("limits2", "p", "limits2", _F32, "B 2"),
    ("owner_uid", "p", "owner_uid", _I32, "B"),
    ("tol_key", "p", "tol_key", _I32, "B TT"),
    ("tol_op", "p", "tol_op", _I32, "B TT"),
    ("tol_val", "p", "tol_val", _I32, "B TT"),
    ("tol_effect", "p", "tol_effect", _I32, "B TT"),
    ("tol_valid", "p", "tol_valid", _BOOL, "B TT"),
    ("pref_weight", "p", "pref_weight", _F32, "B PS"),
    ("pref_term_valid", "p", "pref_term_valid", _BOOL, "B PS"),
    ("pref_expr_key", "p", "pref_expr_key", _I32, "B PS E"),
    ("pref_expr_op", "p", "pref_expr_op", _I32, "B PS E"),
    ("pref_expr_vals", "p", "pref_expr_vals", _I32, "B PS E V"),
    ("pref_expr_nval", "p", "pref_expr_nval", _I32, "B PS E"),
    ("pref_expr_num", "p", "pref_expr_num", _F32, "B PS E"),
    ("pref_expr_valid", "p", "pref_expr_valid", _BOOL, "B PS E"),
    ("group_ids", "p", "group_ids", _I32, "B GP"),
    ("group_valid", "p", "group_valid", _BOOL, "B GP"),
    ("spread_counts", "p", "spread_counts", _F32, "B NS"),
    ("image_ids", "p", "image_ids", _I32, "B C"),
)


class FilterPassArgs(ctypes.Structure):
    """filter_pass.cu's FilterPassArgs, field for field: a device pointer
    for each row of _K11_ARGS, then the other pointers, then sizes, flags
    and the path (int32)."""

    _fields_ = ([(spec[0], ctypes.c_void_p) for spec in _K11_ARGS]
                + [(name, ctypes.c_void_p) for name in (
                    "forbidden_pairs", "anti_term_pairs", "vol_zone_pairs",
                    "vol_bind_pairs", "node_pair", "aff_slot", "max_vols",
                    "presence_keys", "svc_labels", "out")]
                + [(name, ctypes.c_int) for name in (
                    "b", "n", "r", "l", "t", "p", "q", "tt", "ns", "s", "e",
                    "v", "vt", "dv", "dvn", "sa", "at", "pt", "vz", "vb",
                    "tp", "kt", "aff_on", "vz_on", "vb_on", "n_presence",
                    "presence_present", "n_svc", "unsched_key", "enabled",
                    "unresolvable", "stack_mode", "threads", "per_thread",
                    "tile", "slice")])


class ScorePassArgs(ctypes.Structure):
    """score_pass.cu's ScorePassArgs, field for field: a device pointer for
    each row of _K12_ARGS, then the other pointers, the weights, then sizes,
    flags and the path (int32)."""

    _fields_ = ([(spec[0], ctypes.c_void_p) for spec in _K12_ARGS]
                + [(name, ctypes.c_void_p) for name in (
                    "node_pair", "pair_rank", "ipa_w", "prefs_key",
                    "prefs_presence", "prefs_weight", "rtc_xs", "rtc_ys",
                    "work", "total", "per")]
                + [("w", ctypes.c_float * 12)]
                + [(name, ctypes.c_int) for name in (
                    "b", "n", "r", "l", "t", "tt", "i", "c", "a", "g", "gp",
                    "ps", "e", "v", "tp", "kt", "n_prefs", "n_rtc", "rows",
                    "zslot", "zones", "cluster", "threads", "per_thread",
                    "tile", "slice", "smem_mode", "region", "inbox",
                    "node_off",
                    "na_off", "sp_off", "ipa_off", "zp_off", "zt_off")])


def _bind_rows(name: str, specs, cluster, pods, args) -> dict:
    """Check every (struct field, owner, dataclass field, dtype, dims) of
    a launch against the cluster's and the pods' tensors (CUDA, one
    device, the dtype, sizes that agree by name) and set each field's
    pointer in args.  Returns the sizes by name, "device", and "keep":
    the contiguous tensors the pointers point into (hold them until the
    launch is queued)."""
    dims: dict = {}
    keep = []
    device = cluster.valid.device
    for field, owner, attr, dtype, shape in specs:
        t = getattr(cluster if owner == "c" else pods, attr)
        label = f"{'cluster' if owner == 'c' else 'pods'}.{attr}"
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} launches on CUDA tensors only "
                             f"({label})")
        if t.device != device:
            raise ValueError(f"{name}: {label} lies on {t.device}, "
                             f"cluster.valid on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} wants {label} as {dtype}, got "
                            f"{t.dtype}")
        names = shape.split()
        if t.dim() != len(names):
            raise ValueError(f"{name} wants {label} of {len(names)} dims "
                             f"({shape}), got {tuple(t.shape)}")
        for d, size in zip(names, t.shape):
            if d.isdigit():
                if size != int(d):
                    raise ValueError(f"{name}: {label} has {size} columns, "
                                     f"not {d}")
            elif dims.setdefault(d, size) != size:
                raise ValueError(f"{name}: {label} has {d}={size}, other "
                                 f"inputs {dims[d]}")
        t = t.contiguous()
        keep.append(t)
        setattr(args, field, t.data_ptr())
    dims["device"] = device
    dims["keep"] = keep
    return dims


@functools.lru_cache(maxsize=None)
def _device_const(values: tuple, dtype, device) -> torch.Tensor:
    """A small constant table on the device (profile and policy
    arguments), copied there once a process."""
    return torch.tensor(values, dtype=dtype).to(device)


@functools.lru_cache(maxsize=None)
def _filter_config(cfg, vt: int) -> tuple:
    """(enabled bitmask, max_vols per column, presence keys, service
    affinity labels) of a FilterConfig for VT attach-count columns; the
    columns past the base types take the CSI default, as
    ops/predicates.py max_volume_counts does."""
    from kubernetes_tpu_torch.codec.schema import (NUM_PREDICATES,
                                                   PRED_INDEX, VOL_CSI)

    if cfg.enabled is None:
        enabled = (1 << NUM_PREDICATES) - 1
    else:
        enabled = sum(1 << PRED_INDEX[k] for k in set(cfg.enabled)
                      if k in PRED_INDEX)
    base = list(cfg.max_vols)
    if vt > len(base):
        base = base + [float(cfg.max_vols[VOL_CSI])] * (vt - len(base))
    return (enabled, tuple(base[:vt]),
            tuple(int(k) for k in cfg.label_presence_keys),
            tuple(int(k) for k in cfg.service_affinity_labels))


# K11's modes (filter_pass.cu stack_mode); False and True name the first
# two
K11_MASK, K11_STACK, K11_CANDIDATES = 0, 1, 2

# K11's layout (filter_pass.cu): a block owns a slice of nodes, per_thread
# nodes a thread strided by its threads; the grid is (slices, pod tiles),
# a block walks a tile of pods over its slice, each thread reading its
# nodes' rows in place.  At one pod a node a thread over ceil(N /
# K11_THREADS) blocks; at a batch K11_BATCH_PER_THREAD nodes a thread and
# K11_TILE pods a tile, the tile halved until its affinity flags fit in
# K11_SMEM_BUDGET bytes of dynamic shared memory (the kernel's
# kSmemBudget, set as the function's limit beside its static arrays;
# tools/k11_compare.py's sweeps on the card, PERF.md §6).
K11_SMEM_BUDGET = 48 * 1024
K11_THREADS = 128
K11_BATCH_PER_THREAD = 2
K11_TILE = 32


class FilterPassPath(NamedTuple):
    """The path one K11 launch takes (filter_pass_paths)."""

    threads: int        # threads a block
    per_thread: int     # nodes a thread
    slice: int          # nodes a block
    tile: int           # pods a block
    slices: int         # blocks over the node axis
    tiles: int          # blocks over the pod axis
    smem: int           # dynamic shared memory bytes a block


def filter_pass_paths(B: int, N: int, PT: int = 0,
                      aff: bool = False) -> FilterPassPath:
    """The path of a K11 launch over B pods and N nodes, each pod with PT
    affinity terms that the kernel reads where `aff` (the batch is not
    lean in them): K11_THREADS threads a block; one node a thread and one
    pod a tile at B 1, K11_BATCH_PER_THREAD nodes a thread and K11_TILE
    pods a tile (never more than B) past; the tile's PT affinity flags in
    shared memory, the tile halved until they fit in K11_SMEM_BUDGET.
    Sizes only: the CPU tests check it.  Raises where the kernel takes no
    path (more than K11_SMEM_BUDGET bytes of affinity flags at one pod, as
    the parent refused)."""
    if B <= 0 or N <= 0 or PT < 0:
        raise ValueError(f"filter_pass_paths: B={B} N={N} PT={PT}")
    T = K11_THREADS
    k = 1 if B == 1 else K11_BATCH_PER_THREAD
    P = min(1 if B == 1 else K11_TILE, B)
    flags = PT if aff else 0
    while P > 1 and P * flags > K11_SMEM_BUDGET:
        P //= 2
    if P * flags > K11_SMEM_BUDGET:
        raise ValueError(f"filter_pass: {PT} affinity terms a pod, past "
                         f"{K11_SMEM_BUDGET} bytes of flags")
    S = T * k
    return FilterPassPath(T, k, S, P, -(-N // S), -(-B // P), P * flags)


def filter_pass_path(cluster, pods) -> FilterPassPath:
    """The FilterPassPath a K11 launch takes on this snapshot and batch (on
    any device)."""
    aff = pods.aff_term_pairs.shape[-1] == cluster.topo_pairs.shape[1]
    return filter_pass_paths(
        int(pods.valid.shape[0]), int(cluster.valid.shape[0]),
        int(pods.aff_term_valid.shape[1]), bool(aff))


def filter_pass_prepare(cluster, pods, cfg, unsched_taint_key: int,
                        node_pair, aff_slot, mode, unresolvable: int = 0):
    """The arguments of one K11 launch (see filter_pass) with its output
    allocated: (FilterPassArgs, the tensors they point into, out).  The
    launch itself (filter_pass_launch) allocates nothing, so a CUDA graph
    can capture it.  args.path holds the FilterPassPath."""
    from kubernetes_tpu_torch.codec.schema import NUM_PREDICATES

    mode = int(mode)
    if mode not in (K11_MASK, K11_STACK, K11_CANDIDATES):
        raise ValueError(f"filter_pass: mode {mode} is not mask (0), stack "
                         f"(1) or candidates (2)")
    if not 0 <= int(unresolvable) < (1 << NUM_PREDICATES):
        raise ValueError(f"filter_pass: unresolvable {unresolvable} is not "
                         f"a mask of the {NUM_PREDICATES} predicates")
    stack = mode == K11_STACK
    args = FilterPassArgs()
    overlap = pods.vol_overlap
    lean_overlap = (isinstance(overlap, torch.Tensor) and overlap.dim() == 3
                    and overlap.shape[2] != cluster.valid.shape[0])
    specs = tuple(s for s in _K11_ARGS
                  if not (lean_overlap and s[0] == "vol_overlap"))
    dims = _bind_rows("filter_pass", specs, cluster, pods, args)
    dev, B, N = dims["device"], dims["B"], dims["N"]
    if lean_overlap:
        args.vol_overlap = None
    elif dims["NO"] != N:
        raise ValueError(f"filter_pass: pods.vol_overlap has {dims['NO']} "
                         f"node columns, the snapshot {N}")
    if dims["VT"] < 5:
        raise ValueError(f"filter_pass wants at least 5 attach-count "
                         f"columns, got {dims['VT']}")
    if not (0 < N < (1 << 31) and 0 < B < (1 << 31)
            and B * NUM_PREDICATES * N < (1 << 62)):
        raise ValueError(f"filter_pass: sizes B={B} N={N} out of range")
    enabled, max_vols, presence, svc = _filter_config(cfg, dims["VT"])
    if svc and dims["SA"] < len(svc):
        raise ValueError(f"filter_pass: {len(svc)} service affinity labels "
                         f"and {dims['SA']} svc_aff_fixed columns")
    consts = [_device_const(max_vols, torch.float32, dev)]
    args.max_vols = consts[0].data_ptr()
    for field, vals in (("presence_keys", presence), ("svc_labels", svc)):
        if vals:
            consts.append(_device_const(vals, torch.int32, dev))
            setattr(args, field, consts[-1].data_ptr())
    # the pair families the batch is not lean in, read by the gather
    TP = cluster.topo_pairs.shape[1]
    on = {"aff": dims["TPA"] == TP, "vz": pods.vol_zone_pairs.shape[-1] == TP,
          "vb": pods.vol_bind_pairs.shape[-1] == TP}
    rows = []
    if any(on.values()):
        if node_pair is None:
            raise ValueError("filter_pass: pair terms without node_pair")
        rows.append(("node_pair", node_pair, _I32, f"{N} KT"))
    if on["aff"]:
        rows += [("forbidden_pairs", pods.forbidden_pairs, _BOOL,
                  f"{B} {TP}"),
                 ("anti_term_pairs", pods.anti_term_pairs, _BOOL,
                  f"{B} {dims['AT']} {TP}"),
                 ("aff_slot", aff_slot, _I32, f"{B} {dims['PT']}")]
        if aff_slot is None:
            raise ValueError("filter_pass: affinity terms without aff_slot")
    if on["vz"]:
        rows.append(("vol_zone_pairs", pods.vol_zone_pairs, _BOOL,
                     f"{B} {dims['VZ']} {TP}"))
    if on["vb"]:
        rows.append(("vol_bind_pairs", pods.vol_bind_pairs, _BOOL,
                     f"{B} {dims['VB']} {TP}"))
    pdims, pdev, pkeep = _bind("filter_pass", args, rows)
    if pdev is not None and pdev != dev:
        raise ValueError(f"filter_pass: the pair rows lie on {pdev}, the "
                         f"snapshot on {dev}")
    for k in ("B", "N", "R", "L", "T", "P", "Q", "TT", "NS", "S", "E", "V",
              "VT", "DV", "DVN", "SA", "AT", "PT", "VZ", "VB"):
        setattr(args, k.lower(), int(dims[k]))
    args.tp = int(dims["TPA"])
    args.kt = int(pdims.get("KT", 0))
    args.aff_on, args.vz_on, args.vb_on = (int(on[k]) for k in
                                           ("aff", "vz", "vb"))
    args.n_presence = len(presence)
    args.presence_present = int(bool(cfg.label_presence_present))
    args.n_svc = len(svc)
    args.unsched_key = int(unsched_taint_key)
    args.enabled = enabled
    args.unresolvable = int(unresolvable)
    args.stack_mode = mode
    p = filter_pass_paths(B, N, dims["PT"], on["aff"])
    args.threads, args.per_thread, args.tile = p.threads, p.per_thread, p.tile
    args.slice = p.slice
    args.path = p
    shape = (B, NUM_PREDICATES, N) if stack else (B, N)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    args.out = out.data_ptr()
    return args, dims["keep"] + consts + pkeep + [out], out


def node_pair_build(topo: torch.Tensor, slot: torch.Tensor, kt: int,
                    out=None) -> torch.Tensor:
    """The node-pair table of one snapshot (ops/predicates.py
    build_node_pairs; twin node_pair_table_plain) on topo's CUDA device:
    topo bool[N, TP], slot i32[TP] each pair's topology key slot (-1: no
    key), kt the slots -> i32[N, max(kt, 1)], each node's pair of each
    slot or -1, written whole into `out` when given (nothing allocated).
    The caller has checked that no node lies in two pairs of one key or
    in a pair with no key (ops/predicates.py check_node_pairs).  One
    kernel launch (filter_pass.cu node_pair_build), no host sync."""
    if not (isinstance(topo, torch.Tensor) and topo.is_cuda
            and isinstance(slot, torch.Tensor) and slot.is_cuda):
        raise ValueError("node_pair_build launches on CUDA tensors only")
    if (topo.dtype != torch.bool or slot.dtype != torch.int32
            or topo.dim() != 2 or slot.shape != (topo.shape[1],)
            or slot.device != topo.device):
        raise ValueError(f"node_pair_build wants topo bool[N, TP] and slot "
                         f"i32[TP] on one device, got {topo.dtype} "
                         f"{tuple(topo.shape)} and {slot.dtype} "
                         f"{tuple(slot.shape)}")
    (N, TP), dev = topo.shape, topo.device
    topo, slot = topo.contiguous(), slot.contiguous()
    kt = max(int(kt), 1)
    if out is None:
        out = torch.empty((N, kt), dtype=torch.int32, device=dev)
    elif (out.dtype != torch.int32 or out.shape != (N, kt)
          or out.device != dev or not out.is_contiguous()):
        raise ValueError(f"node_pair_build writes i32[{N}, {kt}] in place, "
                         f"got {out.dtype} {tuple(out.shape)}")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    with torch.cuda.device(dev):
        _launch_error(lib, "node_pair_build", lib.node_pair_build_launch(
            topo.data_ptr(), slot.data_ptr(), N, TP, kt, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream))
    _count("node_pair_build")
    return out


def filter_pass_launch(args) -> None:
    """Queue one prepared K11 launch on the current stream; raises on a
    refused launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "filter_pass", lib.filter_pass_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("filter_pass")
    if args.stack_mode == K11_STACK:
        _count("filter_pass_stack")
    elif args.stack_mode == K11_CANDIDATES:
        _count("filter_pass_candidates")


def filter_pass(cluster, pods, cfg, unsched_taint_key: int, node_pair,
                aff_slot, mode, unresolvable: int = 0) -> torch.Tensor:
    """K11: every predicate of one filter pass over the pods x nodes grid,
    on the snapshot's CUDA device.  cluster / pods: the schema dataclasses
    of tensors; cfg: the FilterConfig; node_pair: None (the batch is lean
    in every pair family) or i32[N, KT], ops/predicates.py
    node_pair_table's, the pair rows (the pods' forbidden, anti-affinity,
    affinity, volume zone and binding pairs) are gathered at; aff_slot:
    i32[B, PT] each affinity term's key slot (ops/predicates.py
    key_slots), or None for an affinity-lean batch.  mode K11_MASK (or
    False) -> mask bool[B, N] (valid, pod_valid and every predicate
    folded); K11_STACK (or True) -> the stack bool[B, 23, N];
    K11_CANDIDATES -> bool[B, N], the nodes where preemption might help:
    valid, some predicate failing, none of the rows in the `unresolvable`
    bit mask (bit k: predicate k) failing and the pod's required affinity
    rules holding.  See ops/predicates.py filter_batch_plain /
    predicate_stack_plain and models/preemption.py preempt_eval_plain.
    Raises on anything the kernel does not take and on a refused
    launch."""
    args, keep, out = filter_pass_prepare(cluster, pods, cfg,
                                          unsched_taint_key, node_pair,
                                          aff_slot, mode, unresolvable)
    with torch.cuda.device(out.device):
        filter_pass_launch(args)
    return out


# K12's layout (score_pass.cu): a thread-block cluster of K12_CLUSTER
# blocks spreads the node axis; each cluster scores a tile of pods (the
# kernel's static shared memory holds K12_MAX_TILE); a block's threads, at
# most K12_MAX_THREADS, walk its slice of nodes; the block's arrays live
# in shared memory up to K12_SMEM_BUDGET bytes, else in the global
# workspace.  At one pod a node a thread; at a batch K12_BATCH_PER_THREAD
# nodes a thread and the larger of K12_TILES whose block keeps its shared
# memory within K12_TILE_SMEM (else the smaller), so that more blocks
# share an SM (tools/k12_compare.py's sweeps on the card, PERF.md §6).
K12_CLUSTER = 16
K12_MAX_THREADS = 512
K12_MAX_TILE = 32
K12_TILES = (16, 8)
K12_TILE_SMEM = 32 * 1024
K12_BATCH_PER_THREAD = 2
K12_SMEM_BUDGET = 200 * 1024
K12_NODE_ARRAYS = 7     # a node's values the node prologue keeps
K12_PARTS = 6           # a pod's partials a block pushes to every block


class ScorePassPath(NamedTuple):
    """The path one K12 launch takes (score_pass_paths)."""

    cluster: int        # blocks of a cluster, over the node axis
    threads: int        # threads a block
    per_thread: int     # nodes a thread
    tile: int           # pods a cluster
    tiles: int          # clusters of the launch
    slice: int          # nodes a block
    region: int         # floats of a block's arrays
    smem: bool          # the arrays in shared memory (else the workspace)
    inbox: int          # floats of a block's inbox (shared memory)


def _k12_layout(B, N, zones, arrays, P, C, per_thread) -> ScorePassPath:
    S = -(-N // C)
    S = -(-S // 32) * 32
    T = min(-(-S // (32 * per_thread)) * 32, K12_MAX_THREADS)
    region = K12_NODE_ARRAYS * S + arrays * P * S + 2 * P * zones
    # the inbox: every block's K12_PARTS partials a pod and, with the
    # arrays in shared memory, its zone partials
    smem = (region + C * P * (K12_PARTS + zones)) * 4 <= K12_SMEM_BUDGET
    inbox = C * P * (K12_PARTS + (zones if smem else 0))
    return ScorePassPath(C, T, -(-S // T), P, -(-B // P), S, region, smem,
                         inbox)


def score_pass_paths(B: int, N: int, zones: int = 0, arrays: int = 3,
                     tile: int = None, cluster_size: int = K12_CLUSTER,
                     per_thread: int = None) -> ScorePassPath:
    """The path of a K12 launch over B pods and N nodes: the node axis
    over a cluster of K12_CLUSTER blocks (cluster_size: another build's,
    for the tools), each a slice of N / cluster nodes (a multiple of 32),
    per_thread nodes a thread (one at B 1, K12_BATCH_PER_THREAD past) up
    to K12_MAX_THREADS threads and more nodes a thread past; `tile` pods a
    cluster (at B 1 one; past, the larger of K12_TILES whose block's
    shared memory stays within K12_TILE_SMEM, else the smaller; never
    more than B).  A
    block's arrays: its slice's K12_NODE_ARRAYS node values (the node
    prologue's), `arrays` per-(pod, node) rows of the slice (the
    NodeAffinity sums, the spread counts and the IPA raw sums, each when
    its row is on) and, with `zones` (the zone key's pairs when
    SelectorSpread's row is on, else 0), the pod's zone partials and
    totals; in shared memory up to K12_SMEM_BUDGET bytes, else in the
    workspace; and the block's inbox, in shared memory, where every block
    of the cluster pushes its K12_PARTS partials of each pod (and its zone
    partials, with the arrays in shared memory).  Sizes only: the CPU
    tests check it."""
    if B <= 0 or N <= 0 or zones < 0 or not 0 <= arrays <= 3:
        raise ValueError(f"score_pass_paths: B={B} N={N} zones={zones} "
                         f"arrays={arrays}")
    C = int(cluster_size)
    k = int(per_thread or (1 if B == 1 else K12_BATCH_PER_THREAD))
    if tile is not None:
        return _k12_layout(B, N, zones, arrays,
                           max(1, min(int(tile), K12_MAX_TILE, B)), C, k)
    for P in K12_TILES:
        path = _k12_layout(B, N, zones, arrays, max(1, min(P, B)), C, k)
        if (path.inbox + (path.region if path.smem else 0)) * 4 \
                <= K12_TILE_SMEM:
            return path
    return path


class _K12Plan(NamedTuple):
    rows: int           # the priority rows computed (bit k: row k)
    on: tuple           # the NodeAffinity, spread and IPA arrays
    zslot: int          # the zone key's slot in the node-pair table, or -1
    zones: int          # its pairs (0 with zslot -1)
    path: ScorePassPath


def _k12_plan(cluster, pods, weights, all_rows: bool, zone_key_id: int,
              ipa: bool, tile: int = None,
              cluster_size: int = K12_CLUSTER,
              per_thread: int = None) -> _K12Plan:
    """What a K12 launch computes and the path it takes, from the shapes,
    the weights and the snapshot's node-pair table (on any device; a
    refused table raises)."""
    from kubernetes_tpu_torch.codec.schema import NUM_PRIORITIES
    from kubernetes_tpu_torch.ops.predicates import node_pair_table

    w = np.asarray(weights, np.float32).reshape(-1)
    rows = ((1 << NUM_PRIORITIES) - 1 if all_rows
            else sum(1 << i for i, x in enumerate(w) if x != 0.0))
    pairs = node_pair_table(cluster)
    spread = bool(rows & 1)
    zslot = pairs.slot_of(zone_key_id) if spread else -1
    zones = int(pairs.sizes[zslot]) if zslot >= 0 else 0
    ps = pods.pref_weight.shape[1] if pods.pref_weight.dim() == 2 else 0
    on = (bool((rows >> 5) & 1) and ps > 0, spread, bool(ipa))
    return _K12Plan(rows, on, zslot, zones, score_pass_paths(
        pods.n_pods, cluster.n_nodes, zones, sum(on), tile, cluster_size,
        per_thread))


def score_pass_path(cluster, pods, weights, all_rows: bool,
                    zone_key_id: int, ipa: bool) -> ScorePassPath:
    """The ScorePassPath a K12 launch takes on this snapshot and batch
    (score_pass's arguments), on any device."""
    return _k12_plan(cluster, pods, weights, all_rows, zone_key_id,
                     ipa).path


def score_pass_prepare(cluster, pods, weights, all_rows: bool,
                       need_per: bool, score_cfg, zone_key_id: int,
                       ipa: bool, tile: int = None,
                       cluster_size: int = K12_CLUSTER,
                       per_thread: int = None):
    """The arguments of one K12 launch (see score_pass) with its outputs
    allocated: (ScorePassArgs, the tensors they point into, (total,
    per)).  The launch itself (score_pass_launch) allocates nothing, so a
    CUDA graph can capture it.  args.path holds the ScorePassPath (tile,
    cluster_size and per_thread: score_pass_paths', for the tools)."""
    from kubernetes_tpu_torch.codec.schema import NUM_PRIORITIES
    from kubernetes_tpu_torch.ops.predicates import node_pair_table

    args = ScorePassArgs()
    lean_spread = (pods.spread_counts.dim() == 2
                   and pods.spread_counts.shape[1]
                   != cluster.valid.shape[0])
    specs = tuple(s for s in _K12_ARGS
                  if not (lean_spread and s[0] == "spread_counts"))
    dims = _bind_rows("score_pass", specs, cluster, pods, args)
    dev, B, N = dims["device"], dims["B"], dims["N"]
    if lean_spread:
        args.spread_counts = None
    elif dims["NS"] != N:
        raise ValueError(f"score_pass: spread_counts has {dims['NS']} "
                         f"columns, the snapshot {N}")
    if not (0 < N < (1 << 31) and 0 < B < (1 << 31)
            and B * NUM_PRIORITIES * N < (1 << 62)):
        raise ValueError(f"score_pass: sizes B={B} N={N} out of range")
    w = [float(x) for x in np.asarray(weights, np.float32).reshape(-1)]
    if len(w) != NUM_PRIORITIES:
        raise ValueError(f"score_pass wants {NUM_PRIORITIES} weights, got "
                         f"{len(w)}")
    plan = _k12_plan(cluster, pods, w, all_rows, zone_key_id, ipa, tile,
                     cluster_size, per_thread)
    rows, path = plan.rows, plan.path
    TP = (int(cluster.topo_pairs.shape[1])
          if cluster.topo_pairs.dim() == 2 else -1)
    # every node's zone and the IPA gather read the node-pair table
    # (refused snapshots raise here)
    pairs = node_pair_table(cluster)
    pdims, pdev, keep = _bind("score_pass", args, [
        ("node_pair", pairs.table, _I32, f"{N} KT"),
        ("pair_rank", pairs.rank, _I32, f"{TP}")])
    if pdev != dev:
        raise ValueError(f"score_pass: the node-pair table lies on {pdev}, "
                         f"the snapshot on {dev}")
    args.kt = pdims["KT"]
    if ipa:
        # the IPA raw sums: the pods' preferred pair weights gathered over
        # each node's pairs
        _, _, pkeep = _bind("score_pass", args, [
            ("ipa_w", pods.pref_pair_weights, _F32, f"{B} {TP}")])
        keep += pkeep
    prefs = tuple(score_cfg.label_prefs)
    if prefs and (rows >> 9) & 1:
        for field, vals, dtype in (
                ("prefs_key", tuple(int(p[0]) for p in prefs), torch.int32),
                ("prefs_presence", tuple(int(bool(p[1])) for p in prefs),
                 torch.int32),
                ("prefs_weight", tuple(float(p[2]) for p in prefs),
                 torch.float32)):
            keep.append(_device_const(vals, dtype, dev))
            setattr(args, field, keep[-1].data_ptr())
    args.n_prefs = len(prefs)
    shape = tuple(score_cfg.rtc_shape)
    if (rows >> 10) & 1:
        if not shape:
            raise ValueError("score_pass: RequestedToCapacityRatio needs a "
                             "curve of at least one point")
        xs = _device_const(tuple(float(p[0]) for p in shape), torch.float32,
                           dev)
        ys = _device_const(tuple(float(p[1]) for p in shape), torch.float32,
                           dev)
        keep += [xs, ys]
        args.rtc_xs, args.rtc_ys = xs.data_ptr(), ys.data_ptr()
    args.n_rtc = len(shape)
    for k in ("B", "N", "R", "L", "T", "TT", "I", "C", "A", "G", "GP", "PS",
              "E", "V"):
        setattr(args, k.lower(), int(dims[k]))
    args.tp = TP
    args.w = (ctypes.c_float * NUM_PRIORITIES)(*w)
    args.rows = rows
    args.zslot, args.zones, zones = plan.zslot, plan.zones, plan.zones
    args.cluster, args.threads, args.per_thread = (path.cluster, path.threads,
                                                   path.per_thread)
    args.tile, args.slice, args.region = path.tile, path.slice, path.region
    args.inbox = path.inbox
    args.smem_mode = int(path.smem)
    args.node_off = 0
    at = K12_NODE_ARRAYS * path.slice
    for field, row in zip(("na_off", "sp_off", "ipa_off"), plan.on):
        setattr(args, field, at if row else -1)
        at += path.tile * path.slice if row else 0
    args.zp_off = at if zones else -1
    args.zt_off = at + path.tile * zones if zones else -1
    work = None
    if not path.smem:
        work = torch.empty(path.tiles * path.cluster * path.region,
                           dtype=torch.float32, device=dev)
        args.work = work.data_ptr()
    total = torch.empty((B, N), dtype=torch.float32, device=dev)
    per = (torch.empty((B, NUM_PRIORITIES, N), dtype=torch.float32,
                       device=dev) if need_per else None)
    args.total = total.data_ptr()
    args.per = per.data_ptr() if per is not None else None
    args.path = path
    keep = dims["keep"] + keep + [work, total, per]
    return args, keep, (total, per)


def score_pass_launch(args) -> None:
    """Queue one prepared K12 launch on the current stream; raises on a
    refused launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "score_pass", lib.score_pass_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("score_pass")


def score_pass(cluster, pods, weights, all_rows: bool, need_per: bool,
               score_cfg, zone_key_id: int, ipa: bool):
    """K12: the priorities of one score pass over the pods x nodes grid,
    on the snapshot's CUDA device.  weights: 12 f32 in PRIORITY_ORDER;
    all_rows: compute every priority (else only the nonzero weights');
    score_cfg: the ScoreConfig (NodeLabel and RTC arguments); ipa: the
    InterPodAffinity row's raw sums are the pods' preferred pair weights
    gathered over each node's pairs (ops/priorities.py ipa_gathers).  Each
    node's zone is its pair of the zone key in the snapshot's node-pair
    table (ops/predicates.py node_pair_table; a refused snapshot raises).
    Returns (total f32[B, N], per f32[B, 12, N] with the rows off at 0, or
    None without need_per); see ops/priorities.py score_batch_plain.  One
    kernel launch of K12_CLUSTER-block clusters.  Raises on anything the
    kernel does not take and on a refused launch."""
    args, keep, out = score_pass_prepare(
        cluster, pods, weights, all_rows, need_per, score_cfg, zone_key_id,
        ipa)
    with torch.cuda.device(out[0].device):
        score_pass_launch(args)
    return out


# ------------------------------------------------ K13, K14, K15: B5 and B4


# K13's affinity-mode pointers (seq_scan.cu SeqScanArgs, after `work`)
_K13_AFF_FIELDS = (
    "node_pair", "node_valid", "aff_slot", "anti_slot", "pref_slot",
    "aff_valid", "aff_self", "anti_valid", "aff_match", "anti_match",
    "anti_own", "aff_own", "pref_match", "pref_own", "pref_weight", "u_aff",
    "u_anti", "u_forb", "u_pref", "any_aff")


class SeqScanArgs(ctypes.Structure):
    """seq_scan.cu's SeqScanArgs, field for field: the pointers, the five
    state-dependent weights, then sizes (int32)."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "allocatable", "requested", "nonzero", "group_counts", "topo",
        "pair_key", "req", "pod_nonzero", "priority", "group_ids",
        "group_valid", "spread_counts", "spread_match", "pod_ports",
        "conflict", "static_mask", "static_score", "extra_mask",
        "extra_score", "nom_prio", "nom_req",
        "nom_order", "nom_start", "rtc_xs", "rtc_ys", "feas_limit", "hosts",
        "requested_out", "nonzero_out", "top_nodes", "top_scores",
        "top_feas", "work") + _K13_AFF_FIELDS]
        + [(name, ctypes.c_float) for name in (
            "w_least", "w_most", "w_bal", "w_spread", "w_rtc", "w_ipa",
            "hard_w")]
        + [(name, ctypes.c_int) for name in (
            "b", "n", "r", "g", "gp", "pv", "tp", "tk", "n_rtc", "zone_key",
            "last_index0", "kt", "pt", "at", "pp")])


def _bind(name: str, args, rows) -> tuple:
    """Check (field, tensor or None, dtype, dims) rows of one launch: CUDA
    tensors on one device, the dtype, sizes that agree by name (a digit
    is a fixed size), and set each field's pointer (None stays null).
    Returns (sizes by name, the device, the contiguous tensors to hold
    until the launch is queued)."""
    dims: dict = {}
    keep = []
    dev = None
    for field, t, dtype, shape in rows:
        if t is None:
            setattr(args, field, None)
            continue
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} launches on CUDA tensors only "
                             f"({field})")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {field} lies on {t.device}, the "
                             f"first argument on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} wants {field} as {dtype}, got "
                            f"{t.dtype}")
        names = shape.split()
        if t.dim() != len(names):
            raise ValueError(f"{name} wants {field} of {len(names)} dims "
                             f"({shape}), got {tuple(t.shape)}")
        for d, size in zip(names, t.shape):
            want = int(d) if d.isdigit() else dims.setdefault(d, size)
            if size != want:
                raise ValueError(f"{name}: {field} has {d}={size}, other "
                                 f"inputs {want}")
        t = t.contiguous()
        keep.append(t)
        setattr(args, field, t.data_ptr())
    return dims, dev, keep


def nominated_lists(node: torch.Tensor, n_nodes: int):
    """Each node's nominated claims as one list: (order i32[K], the claim
    indices sorted by node, stably; start i32[N + 1], node n's claims are
    order[start[n]:start[n + 1]]).  Claims off the node axis (-1) sort
    last and belong to no node.  Device ops only, no host sync."""
    key = torch.where((node >= 0) & (node < n_nodes), node.to(torch.int64),
                      n_nodes)
    sorted_key, order = torch.sort(key, stable=True)
    start = torch.searchsorted(
        sorted_key, torch.arange(n_nodes + 1, device=node.device))
    return order.to(torch.int32), start.to(torch.int32)


def seq_scan_barriers(spread: bool, limited: bool, tk: int,
                      aff: bool = False) -> tuple:
    """The barriers one K13 step passes (seq_scan.cu), by option: (block
    barriers, cluster stages).  The cluster stages are the function's
    dependent stages (the select; the spread maxima, or with affinity the
    fence behind the pair commits; the IPA extremes; the sample's prefix),
    the top-k riding on the select's; each is a wait for the partials every
    block pushed (an mbarrier's bytes, or a cluster barrier where global
    memory must be ordered).  The block barriers gather a stage's warps:
    the select's, the commit's; the spread's node maximum and zone sums;
    the IPA extremes; the sample's words and their prefix."""
    block = 2 + bool(spread) + bool(aff) + 2 * bool(limited)
    cluster = 1 + bool(spread or aff) + bool(aff) + bool(limited)
    return block, cluster


def seq_scan_prepare(cluster, pods, ports, static_mask, static_score,
                     extra_mask, extra_score, spread_match, nom, feas_limit,
                     rtc, weights, zone_key: int, last_index0: int, tk: int,
                     out=None, aff=None, pairs=None, unions=None,
                     ipa=(0.0, 0.0)):
    """The arguments of one K13 launch (see seq_scan) with its outputs
    and workspace allocated, or the outputs `out` (hosts, requested,
    nonzero, top or None) written in place: (SeqScanArgs, the tensors
    they point into, the outputs).  With aff (a dense BatchAffinityState)
    the affinity mode, which reads pairs and updates unions.  The launch
    itself (seq_scan_launch) allocates nothing, so a CUDA graph can
    capture it."""
    args = SeqScanArgs()
    lean = pods.spread_counts.shape[-1] != cluster.valid.shape[0]
    xs, ys = rtc if rtc is not None else (None, None)
    rows = [
        ("allocatable", cluster.allocatable, _F32, "N R"),
        ("requested", cluster.requested, _F32, "N R"),
        ("nonzero", cluster.nonzero_req, _F32, "N 2"),
        ("group_counts", cluster.group_counts, _F32, "N G"),
        ("topo", cluster.topo_pairs, _BOOL, "N TP"),
        ("pair_key", cluster.pair_topo_key, _I32, "TP"),
        ("req", pods.req, _F32, "B R"),
        ("pod_nonzero", pods.nonzero_req, _F32, "B 2"),
        ("priority", pods.priority, _I32, "B"),
        ("group_ids", pods.group_ids, _I32, "B GP"),
        ("group_valid", pods.group_valid, _BOOL, "B GP"),
        ("spread_counts", None if lean else pods.spread_counts, _F32,
         "B N"),
        ("spread_match", spread_match, _F32, "B B"),
        ("pod_ports", ports.pod_ports, _BOOL, "B PV"),
        ("conflict", ports.conflict, _BOOL, "PV PV"),
        ("static_mask", static_mask, _BOOL, "B N"),
        ("static_score", static_score, _F32, "B N"),
        ("extra_mask", extra_mask, _BOOL, "B N"),
        ("extra_score", extra_score, _F32, "B N"),
        ("rtc_xs", xs, _F32, "M"),
        ("rtc_ys", ys, _F32, "M"),
        ("feas_limit", feas_limit, _I32, ""),
    ]
    if nom is not None:
        order, start = nominated_lists(nom.node, cluster.valid.shape[0])
        rows += [("nom_prio", nom.prio, _I32, "K"),
                 ("nom_req", nom.req, _F32, "K R"),
                 ("nom_order", order, _I32, "K"),
                 ("nom_start", start, _I32, "N1")]
    if aff is not None:
        rows += _k13_affinity_rows(cluster, pods, aff, pairs, unions)
    if out is not None:
        top = out[3] if out[3] is not None else (None, None, None)
        rows += [("hosts", out[0], _I32, "B"),
                 ("requested_out", out[1], _F32, "N R"),
                 ("nonzero_out", out[2], _F32, "N 2"),
                 ("top_nodes", top[0], _I32, "B TK"),
                 ("top_scores", top[1], _F32, "B TK"),
                 ("top_feas", top[2], _I32, "B")]
    dims, dev, keep = _bind("seq_scan", args, rows)
    B, N, R, PV, TP = (dims[k] for k in ("B", "N", "R", "PV", "TP"))
    if nom is not None and dims["N1"] != N + 1:
        raise ValueError("seq_scan: the nominated lists do not fit N")
    if not (0 < B < (1 << 31) and 0 < N and B * N < (1 << 62) and R >= 2
            and TP > 0 and PV > 0 and 0 <= tk <= N
            and dims.get("TK", tk) == tk):
        raise ValueError(f"seq_scan: sizes B={B} N={N} R={R} TP={TP} "
                         f"PV={PV} tk={tk} out of range")
    if out is None:
        top = None
        if tk:
            top = (torch.empty((B, tk), dtype=torch.int32, device=dev),
                   torch.empty((B, tk), dtype=torch.float32, device=dev),
                   torch.empty(B, dtype=torch.int32, device=dev))
            args.top_nodes, args.top_scores, args.top_feas = (
                t.data_ptr() for t in top)
        out = (torch.empty(B, dtype=torch.int32, device=dev),
               torch.empty((N, R), dtype=torch.float32, device=dev),
               torch.empty((N, 2), dtype=torch.float32, device=dev), top)
        args.hosts, args.requested_out, args.nonzero_out = (
            t.data_ptr() for t in out[:3])
    elif any(not t.is_contiguous() for t in out[:3]):
        raise ValueError("seq_scan writes its outputs in place: they must "
                         "be contiguous")
    (args.w_least, args.w_most, args.w_bal, args.w_spread,
     args.w_rtc) = (float(x) for x in weights)
    args.w_ipa, args.hard_w = (float(x) for x in ipa)
    args.b, args.n, args.r, args.pv, args.tp, args.tk = B, N, R, PV, TP, tk
    args.kt, args.pt, args.at, args.pp = (dims.get(k, 0) for k in
                                          ("KT", "PT", "AT", "PP"))
    args.g, args.gp = dims["G"], dims["GP"]
    args.n_rtc = dims.get("M", 0)
    if args.w_rtc and not args.n_rtc:
        raise ValueError("seq_scan: RequestedToCapacityRatio needs a curve")
    args.zone_key = int(zone_key)
    args.last_index0 = wrap_i32(last_index0)
    from kubernetes_tpu_torch.kernels._build import library

    work = torch.empty(library().seq_scan_workspace_size(args),
                       dtype=torch.uint8, device=dev)
    args.work = work.data_ptr()
    return args, keep + [work, out], out


def _k13_affinity_rows(cluster, pods, aff, pairs, unions) -> list:
    """K13's affinity-mode rows: the batch's BatchPairs (the node-pair
    table and each term's key slot), the cross matches, and the pair rows
    the scan updates in place (unions: fresh TP-wide copies of the pods'
    own, ops/predicates.py union_rows)."""
    if pairs is None or unions is None:
        raise ValueError("seq_scan's affinity mode wants the batch's pairs "
                         "and unions")
    return [
        ("node_pair", pairs.node_pair, _I32, "N KT"),
        ("node_valid", cluster.valid, _BOOL, "N"),
        ("aff_slot", pairs.aff_slot, _I32, "B PT"),
        ("anti_slot", pairs.anti_slot, _I32, "B AT"),
        ("pref_slot", pairs.pref_slot, _I32, "B PP"),
        ("aff_valid", pods.aff_term_valid, _BOOL, "B PT"),
        ("aff_self", pods.aff_term_self, _BOOL, "B PT"),
        ("anti_valid", pods.anti_term_valid, _BOOL, "B AT"),
        ("aff_match", aff.aff_match, _BOOL, "B B PT"),
        ("anti_match", aff.anti_match, _BOOL, "B B AT"),
        ("anti_own", aff.anti_own, _BOOL, "B AT B"),
        ("aff_own", aff.aff_own, _BOOL, "B PT B"),
        ("pref_match", aff.pref_match, _BOOL, "B B PP"),
        ("pref_own", aff.pref_own, _BOOL, "B PP B"),
        ("pref_weight", aff.pref_weight, _F32, "B PP"),
        ("u_aff", unions["uaff"], _BOOL, "B PT TP"),
        ("u_anti", unions["uanti"], _BOOL, "B AT TP"),
        ("u_forb", unions["uforb"], _BOOL, "B TP"),
        ("u_pref", unions["upref"], _F32, "B TP"),
        ("any_aff", torch.any(pods.aff_term_pairs, dim=-1), _BOOL, "B PT")]


def seq_scan_launch(args) -> None:
    """Queue one prepared K13 launch on the current stream; raises on a
    refused launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "seq_scan", lib.seq_scan_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("seq_scan")


def seq_scan(cluster, pods, ports, static_mask, static_score, spread_match,
             nom, feas_limit, rtc, weights, zone_key: int, last_index0: int,
             tk: int, extra_mask=None, extra_score=None, aff=None,
             pairs=None, unions=None, ipa=(0.0, 0.0)):
    """K13: the sequential engine's whole scan of one batch, in one launch
    on the snapshot's CUDA device.  cluster / pods / ports: the schema's
    tensors and the batch's BatchPortState; static_mask bool[B, N] /
    static_score f32[B, N]: the static pass, with extra_mask / extra_score
    (or None) folded in by the kernel; spread_match f32[B, B]
    (ops/priorities.py pod_spread_match); nom: the NominatedState on the
    device or None; feas_limit: i32[] (the sampling limit) or None; rtc:
    (xs, ys) f32 curve tensors or None; weights: (least, most, balanced,
    spread, rtc) as floats; tk: the top-k width (0 = off); aff: the dense
    BatchAffinityState of a batch with in-batch pod affinity (the static
    pass then without MatchInterPodAffinity and the IPA score) or None;
    with aff, pairs: the batch's ops/predicates.py BatchPairs, unions: the
    pods' pair rows the scan updates in place (ops/predicates.py
    union_rows), ipa: (InterPodAffinity's weight, the hard pod affinity
    weight).  Returns (hosts i32[B], requested f32[N, R], nonzero_req
    f32[N, 2], (top_nodes, top_scores, top_feas) or None); see
    models/batched.py scan_plain, its twin.  Raises on anything the kernel
    does not take, on a cluster the card cannot place and on a refused
    launch."""
    args, keep, out = seq_scan_prepare(
        cluster, pods, ports, static_mask, static_score, extra_mask,
        extra_score, spread_match, nom, feas_limit, rtc, weights, zone_key,
        last_index0, tk, aff=aff, pairs=pairs, unions=unions, ipa=ipa)
    with torch.cuda.device(out[0].device):
        seq_scan_launch(args)
    return out


class RoundFoldArgs(ctypes.Structure):
    """round_fold.cu's RoundFoldArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "total_in", "mask_in", "active", "emask", "pod_valid", "escore",
        "spread_g", "group_ids", "group_valid", "zone_of_node", "feas_limit",
        "li", "total_out", "mask_out", "work", "u_pref", "node_pair",
        "node_valid")]
        + [(name, ctypes.c_float) for name in ("w_spread", "w_ipa")]
        + [(name, ctypes.c_int) for name in ("b", "n", "g", "gp", "tp",
                                             "kt")])


class RoundCommitArgs(ctypes.Structure):
    """round_commit.cu's RoundCommitArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "hosts", "feasible", "top_nodes", "top_scores", "top_feas", "req",
        "pod_nonzero", "priority", "pod_ports", "conflict", "group_ids",
        "group_valid", "spread_match", "allocatable", "nom_prio", "nom_req",
        "nom_order", "nom_start", "c_hosts", "c_req", "c_nz", "c_spread",
        "c_claimed", "c_emask", "c_active", "c_li", "c_inv", "c_rounds",
        "c_any", "c_topn", "c_tops", "c_feas", "prop", "accept", "node_req",
        "claimed_h", "prior", "ticket", "round_mask", "rel", "node_pair",
        "anti_slot", "anti_match", "anti_own", "any_acc", "first_inf")]
        + [("cond", ctypes.c_ulonglong)]
        + [(name, ctypes.c_int) for name in (
            "b", "n", "r", "g", "gp", "pv", "tk", "kt", "at")])


def round_fold_prepare(total, mask, c, pods, zone_of_node, tp: int,
                       escore, feas_limit, w_spread: float, ipa=None):
    """The arguments of one K15 launch and the tensors they point into:
    (RoundFoldArgs, keep, (total_out f32[B, N], mask_out bool[B, N])).
    total / mask: the round's score and filter passes; c: the round
    carry (its "active", "emask", "spread" and device counter "li_dev",
    and with ipa its "upref"); zone_of_node i32[N] over the snapshot's tp
    topology pairs; escore f32[B, N] or None; feas_limit i32[] or None;
    ipa: None, or (node_pair i32[N, KT], node valid bool[N], the
    InterPodAffinity weight) for a batch with in-batch pod affinity (the
    affinity mode: the IPA score over c["upref"]).  Everything is
    allocated here, so the launch itself (round_fold_launch) allocates
    nothing."""
    args = RoundFoldArgs()
    N = mask.shape[1]
    lean = pods.spread_counts.shape[-1] != N
    rows = [("total_in", total, _F32, "B N"),
            ("mask_in", mask, _BOOL, "B N"),
            ("active", c["active"], _BOOL, "B"),
            ("emask", c["emask"], _BOOL, "B N"),
            ("pod_valid", pods.valid, _BOOL, "B"),
            ("escore", escore, _F32, "B N"),
            ("spread_g", c["spread"] if lean else None, _F32, "G N"),
            ("group_ids", pods.group_ids, _I32, "B GP"),
            ("group_valid", pods.group_valid, _BOOL, "B GP"),
            ("zone_of_node", zone_of_node, _I32, "N"),
            ("feas_limit", feas_limit, _I32, ""),
            ("li", c["li_dev"], _I32, "")]
    if ipa is not None:
        rows += [("u_pref", c["upref"], _F32, f"B {int(tp)}"),
                 ("node_pair", ipa[0], _I32, "N KT"),
                 ("node_valid", ipa[1], _BOOL, "N")]
        args.w_ipa = float(ipa[2])
    dims, dev, keep = _bind("round_fold", args, rows)
    B = dims["B"]
    TP = int(tp)
    if not (0 < B < (1 << 31) and 0 < N and B * N < (1 << 62) and TP > 0):
        raise ValueError(f"round_fold: sizes B={B} N={N} TP={TP} out of "
                         f"range")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    work = torch.empty(lib.round_fold_workspace_bytes(
        B, N, TP, int(feas_limit is not None)), dtype=torch.uint8,
        device=dev)
    total_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    mask_out = torch.empty((B, N), dtype=torch.bool, device=dev)
    args.total_out, args.mask_out = total_out.data_ptr(), mask_out.data_ptr()
    args.work = work.data_ptr()
    args.w_spread = float(w_spread)
    args.b, args.n, args.tp = B, N, TP
    args.g, args.gp = dims.get("G", 0), dims["GP"]
    args.kt = dims.get("KT", 0)
    keep += [work, total_out, mask_out]
    return args, keep, (total_out, mask_out)


def round_fold_launch(args) -> None:
    """Queue one prepared K15 launch (round_fold_prepare) on the current
    stream; raises on a refused launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "round_fold", lib.round_fold_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("round_fold")


def round_fold(total, mask, c, pods, zone_of_node, tp: int, escore,
               feas_limit, w_spread: float, ipa=None):
    """K15: the speculative round's fold between the score pass and the
    selector, on the tensors' CUDA device; returns (total f32[B, N], mask
    bool[B, N]).  See models/speculative.py round_fold_plain, its twin,
    and round_fold_prepare for the arguments.  Raises on anything the
    kernel does not take and on a refused launch."""
    args, keep, out = round_fold_prepare(total, mask, c, pods, zone_of_node,
                                         tp, escore, feas_limit, w_spread,
                                         ipa)
    with torch.cuda.device(out[0].device):
        round_fold_launch(args)
    return out


def round_commit_prepare(c, hosts, feasible, top, pods, ports, cluster,
                         nom_lists, spread_match, scratch, cond: int = 0,
                         aff=None):
    """The arguments of one K14 round (RoundCommitArgs) and the tensors
    they point into.  c: the round carry, updated in place by the launch
    (hosts, req, nz, spread, claimed, emask, active, li_dev, inv,
    rounds, any and with top-k topn, tops, feas); hosts / feasible: K1's
    picks; top: K3's (top_nodes, top_scores, feasible count) or None;
    nom_lists: (nominated NominatedState, order, start) or None;
    spread_match: f32[B, B] for a batch with per-pod spread counts, None
    for a spread-lean one; scratch: round_commit_scratch's dict; cond:
    the WHILE node's conditional handle, or 0; aff: None, or for a batch
    with in-batch pod affinity (the affinity mode) a dict of the round's
    mask bool[B, N] "mask", "rel" bool[B, B] (pods related through
    required terms), "node_pair" i32[N, KT], "anti_slot" i32[B, AT] and
    the BatchAffinityState's "anti_match" and "anti_own"."""
    args = RoundCommitArgs()
    lean = spread_match is None
    tops = top if top is not None else (None, None, None)
    rows = [("hosts", hosts, _I32, "B"),
            ("feasible", feasible, _BOOL, "B"),
            ("top_nodes", tops[0], _I32, "B TK"),
            ("top_scores", tops[1], _F32, "B TK"),
            ("top_feas", tops[2], _I32, "B"),
            ("req", pods.req, _F32, "B R"),
            ("pod_nonzero", pods.nonzero_req, _F32, "B 2"),
            ("priority", pods.priority, _I32, "B"),
            ("pod_ports", ports.pod_ports, _BOOL, "B PV"),
            ("conflict", ports.conflict, _BOOL, "PV PV"),
            ("group_ids", pods.group_ids, _I32, "B GP"),
            ("group_valid", pods.group_valid, _BOOL, "B GP"),
            ("spread_match", spread_match, _F32, "B B"),
            ("allocatable", cluster.allocatable, _F32, "N R"),
            ("c_hosts", c["hosts"], _I32, "B"),
            ("c_req", c["req"], _F32, "N R"),
            ("c_nz", c["nz"], _F32, "N 2"),
            ("c_spread", c["spread"], _F32, "G N" if lean else "B N"),
            ("c_claimed", c["claimed"], _BOOL, "N PV"),
            ("c_emask", c["emask"], _BOOL, "B N"),
            ("c_active", c["active"], _BOOL, "B"),
            ("c_li", c["li_dev"], _I32, ""),
            ("c_inv", c["inv"], _BOOL, ""),
            ("c_rounds", c["rounds"], _I32, ""),
            ("c_any", c["any"], _BOOL, ""),
            ("c_topn", c.get("topn"), _I32, "B TK"),
            ("c_tops", c.get("tops"), _F32, "B TK"),
            ("c_feas", c.get("feas"), _I32, "B"),
            ("prop", scratch["prop"], _BOOL, "B"),
            ("accept", scratch["accept"], _BOOL, "B"),
            ("node_req", scratch["node_req"], _F32, "B R"),
            ("claimed_h", scratch["claimed_h"], _BOOL, "B PV"),
            ("prior", scratch["prior"], _I32, "B B"),
            ("ticket", scratch["ticket"], _I32, "")]
    if nom_lists is not None:
        nom, order, start = nom_lists
        rows += [("nom_prio", nom.prio, _I32, "K"),
                 ("nom_req", nom.req, _F32, "K R"),
                 ("nom_order", order, _I32, "K"),
                 ("nom_start", start, _I32, "N1")]
    if aff is not None:
        rows += [("round_mask", aff["mask"], _BOOL, "B N"),
                 ("rel", aff["rel"], _BOOL, "B B"),
                 ("node_pair", aff["node_pair"], _I32, "N KT"),
                 ("anti_slot", aff["anti_slot"], _I32, "B AT"),
                 ("anti_match", aff["anti_match"], _BOOL, "B B AT"),
                 ("anti_own", aff["anti_own"], _BOOL, "B AT B"),
                 ("any_acc", scratch["any_acc"], _I32, ""),
                 ("first_inf", scratch["first_inf"], _I32, "")]
    dims, dev, keep = _bind("round_commit", args, rows)
    B, N, R, PV = (dims[k] for k in ("B", "N", "R", "PV"))
    if nom_lists is not None and dims["N1"] != N + 1:
        raise ValueError("round_commit: the nominated lists do not fit N")
    for name, t in c.items():
        if isinstance(t, torch.Tensor) and not t.is_contiguous():
            raise ValueError(f"round_commit updates the carry in place: "
                             f"{name} must be contiguous")
    if not (0 < B < (1 << 31) and 0 < N and B * max(B, N) < (1 << 62)):
        raise ValueError(f"round_commit: sizes B={B} N={N} out of range")
    args.b, args.n, args.r, args.pv = B, N, R, PV
    args.g = dims.get("G", 0)
    args.gp, args.tk = dims["GP"], dims.get("TK", 0)
    args.kt, args.at = dims.get("KT", 0), dims.get("AT", 0)
    args.cond = int(cond)
    return args, keep


def round_commit_scratch(B: int, R: int, PV: int, device) -> dict:
    """The scratch K14's two launches share, allocated once a batch (the
    ticket and the affinity mode's "any accepted" flag zeroed, its first
    infeasible pod at INT32_MAX; each round's last block sets them
    back)."""
    return {"prop": torch.empty(B, dtype=torch.bool, device=device),
            "accept": torch.empty(B, dtype=torch.bool, device=device),
            "node_req": torch.empty((B, R), dtype=torch.float32,
                                    device=device),
            "claimed_h": torch.empty((B, PV), dtype=torch.bool,
                                     device=device),
            "prior": torch.empty((B, B), dtype=torch.int32, device=device),
            "ticket": torch.zeros((), dtype=torch.int32, device=device),
            "any_acc": torch.zeros((), dtype=torch.int32, device=device),
            "first_inf": torch.full((), (1 << 31) - 1, dtype=torch.int32,
                                    device=device)}


def round_commit_launch(args) -> None:
    """Queue one prepared K14 round (round_commit_prepare) on the current
    stream: two kernel launches, counted once.  Raises on a refused
    launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "round_commit", lib.round_commit_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("round_commit")


def round_commit(c, hosts, feasible, top, pods, ports, cluster, nom_lists,
                 spread_match, scratch, aff=None) -> None:
    """K14: the acceptance and the carry update of one round, in place on
    the carry c, on its CUDA device.  See models/speculative.py
    round_commit_plain, its twin, and round_commit_prepare for the
    arguments.  Raises on anything the kernels do not take and on a
    refused launch."""
    args, keep = round_commit_prepare(c, hosts, feasible, top, pods, ports,
                                      cluster, nom_lists, spread_match,
                                      scratch, aff=aff)
    with torch.cuda.device(hosts.device):
        round_commit_launch(args)


class RoundPairsArgs(ctypes.Structure):
    """round_pairs.cu's RoundPairsArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "hosts", "accept", "active", "node_pair", "aff_slot", "anti_slot",
        "pref_slot", "aff_self", "aff_match", "anti_match", "anti_own",
        "aff_own", "pref_match", "pref_own", "pref_weight", "u_aff",
        "u_anti", "u_forb", "u_pref", "self_eff")]
        + [("hard_w", ctypes.c_float)]
        + [(name, ctypes.c_int) for name in ("b", "tp", "kt", "pt", "at",
                                             "pp")])


def round_pairs_prepare(c, hosts, accept, pods, aff, pairs,
                        hard_w: float):
    """The arguments of one K16 launch and the tensors they point into:
    (RoundPairsArgs, keep).  c: the round carry of a batch with in-batch
    pod affinity, updated in place (its unions "uaff", "uanti", "uforb",
    "upref" and the gated "self"; "active" read); hosts / accept: K1's
    picks and K14's acceptance, or None for the gate alone (the first
    round's); aff: the dense BatchAffinityState; pairs: the batch's
    ops/predicates.py BatchPairs; hard_w: the hard pod affinity weight."""
    args = RoundPairsArgs()
    rows = [("hosts", hosts, _I32, "B"),
            ("accept", accept, _BOOL, "B"),
            ("active", c["active"], _BOOL, "B"),
            ("node_pair", pairs.node_pair, _I32, "N KT"),
            ("aff_slot", pairs.aff_slot, _I32, "B PT"),
            ("anti_slot", pairs.anti_slot, _I32, "B AT"),
            ("pref_slot", pairs.pref_slot, _I32, "B PP"),
            ("aff_self", pods.aff_term_self, _BOOL, "B PT"),
            ("aff_match", aff.aff_match, _BOOL, "B B PT"),
            ("anti_match", aff.anti_match, _BOOL, "B B AT"),
            ("anti_own", aff.anti_own, _BOOL, "B AT B"),
            ("aff_own", aff.aff_own, _BOOL, "B PT B"),
            ("pref_match", aff.pref_match, _BOOL, "B B PP"),
            ("pref_own", aff.pref_own, _BOOL, "B PP B"),
            ("pref_weight", aff.pref_weight, _F32, "B PP"),
            ("u_aff", c["uaff"], _BOOL, "B PT TP"),
            ("u_anti", c["uanti"], _BOOL, "B AT TP"),
            ("u_forb", c["uforb"], _BOOL, "B TP"),
            ("u_pref", c["upref"], _F32, "B TP"),
            ("self_eff", c["self"], _BOOL, "B PT")]
    if (hosts is None) != (accept is None):
        raise ValueError("round_pairs wants both hosts and accept, or "
                         "neither")
    dims, dev, keep = _bind("round_pairs", args, rows)
    for k in ("uaff", "uanti", "uforb", "upref", "self"):
        if not c[k].is_contiguous():
            raise ValueError(f"round_pairs updates the carry in place: {k} "
                             f"must be contiguous")
    B = dims["B"]
    if not (0 < B < (1 << 31) and B * B < (1 << 62)):
        raise ValueError(f"round_pairs: B={B} out of range")
    args.hard_w = float(hard_w)
    args.b, args.tp, args.kt = B, dims["TP"], dims["KT"]
    args.pt, args.at, args.pp = dims["PT"], dims["AT"], dims["PP"]
    return args, keep


def round_pairs_launch(args) -> None:
    """Queue one prepared K16 launch (round_pairs_prepare) on the current
    stream; raises on a refused launch."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    _launch_error(lib, "round_pairs", lib.round_pairs_launch(
        args, torch.cuda.current_stream().cuda_stream))
    _count("round_pairs")


def round_pairs(c, hosts, accept, pods, aff, pairs,
                hard_w: float) -> None:
    """K16: the pair commit of one round's accepted pods and the next
    round's bootstrap gate (accept None: the gate alone), in place on the
    carry c, on its CUDA device.  See models/speculative.py
    round_pairs_plain, its twin, and round_pairs_prepare for the
    arguments.  Raises on anything the kernel does not take and on a
    refused launch."""
    args, keep = round_pairs_prepare(c, hosts, accept, pods, aff,
                                     pairs, hard_w)
    with torch.cuda.device(c["active"].device):
        round_pairs_launch(args)


def graph_versions() -> tuple:
    """(driver, runtime) CUDA versions as cudaDriverGetVersion and
    cudaRuntimeGetVersion give them (12040 = 12.4)."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    drv, rt = ctypes.c_int(0), ctypes.c_int(0)
    _launch_error(lib, "graph_versions",
                  lib.graph_versions(ctypes.byref(drv), ctypes.byref(rt)))
    return drv.value, rt.value


def graph_probe(count: int = 5) -> int:
    """Build and run a toy CUDA graph on the current stream: a WHILE node
    whose body counts a device counter down from `count`.  Returns the
    passes the body made (count, when the driver and runtime build
    conditional nodes); raises when they refuse."""
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    dev = torch.device("cuda", torch.cuda.current_device())
    counter = torch.full((), int(count), dtype=torch.int32, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    cap, body = graph_streams(dev)
    cap.wait_stream(torch.cuda.current_stream(dev))
    _launch_error(lib, "graph_probe", lib.graph_probe(
        counter.data_ptr(), steps.data_ptr(), cap.cuda_stream,
        body.cuda_stream))
    return int(steps)


@functools.lru_cache(maxsize=None)
def graph_streams(device) -> tuple:
    """Two streams of `device` for capturing a CUDA graph: the graph's own
    (the legacy default stream cannot capture) and its conditional
    bodies'.  Made once a process."""
    return torch.cuda.Stream(device), torch.cuda.Stream(device)


# Graph launches whose body kernels' counts wait on the card: (event after
# the launch, pinned host copy of [rounds, redo], the launches its capture
# recorded by section).  settle_launches() adds them; reset_launch_counts()
# drops them.
_GRAPH_PENDING: list = []
_PENDING_CAP = 256      # past this, graph_launched settles what has run


def graph_launched(rounds: torch.Tensor, redo: torch.Tensor,
                   launched: dict) -> None:
    """Record a graph launch just queued on the current stream, with the
    launches its capture recorded (capturing.launched): the "while"
    section's run `rounds` times (i32[]), the "if" section's once if `redo`
    (i32[]), the "once" section's once; only the card knows rounds and
    redo.  Both are copied to pinned host memory behind the launch (no
    host sync)."""
    host = torch.empty(2, dtype=torch.int32, pin_memory=True)
    host[0:1].copy_(rounds.view(1), non_blocking=True)
    host[1:2].copy_(redo.view(1), non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    _GRAPH_PENDING.append((done, host, launched))
    if len(_GRAPH_PENDING) > _PENDING_CAP:
        _settle(wait=False)


def _settle(wait: bool) -> None:
    keep = []
    for entry in _GRAPH_PENDING:
        done, host, launched = entry
        if not wait and not done.query():
            keep.append(entry)
            continue
        done.synchronize()
        times = {"once": 1, "while": int(host[0]), "if": int(host[1] != 0)}
        for section, names in launched.items():
            for name, n in names.items():
                LAUNCHES[name] += times[section] * n
    _GRAPH_PENDING[:] = keep


def settle_launches() -> dict:
    """Add the launches of the recorded graph launches to LAUNCHES
    (waiting for those still running) and return a copy of LAUNCHES."""
    _settle(wait=True)
    return dict(LAUNCHES)


# graphs built by the speculative engine in this process, and the host
# seconds their build took: in all, and by part (the launches' preparation,
# the capture, the end of the capture with the instantiation)
GRAPH_STATS = {"builds": 0, "seconds": 0.0, "prepare": 0.0, "capture": 0.0,
               "instantiate": 0.0}
# one capture at a time in a process: the capture streams are shared
GRAPH_LOCK = threading.Lock()


class capturing:
    """Context: this thread's launches queue graph nodes and count
    nothing; the names the wrappers count are recorded instead, in
    `launched` by the section into() last named ("once" until then):
    "while" for a WHILE node's body, "if" for an IF node's."""

    def __init__(self):
        self.launched = {"once": {}, "while": {}, "if": {}}
        self.section = "once"

    def into(self, section: str) -> None:
        if section not in self.launched:
            raise ValueError(f"no capture section {section!r}")
        self.section = section

    def record(self, name: str) -> None:
        names = self.launched[self.section]
        names[name] = names.get(name, 0) + 1

    def __enter__(self):
        _CAPTURE.on = self
        return self

    def __exit__(self, *exc):
        _CAPTURE.on = None


def library():
    """The kernel library (kernels/_build.py), built at the first call."""
    from kubernetes_tpu_torch.kernels._build import library as build

    return build()


def check_graph(lib, err: int) -> None:
    """Raise on a graph API error code."""
    _launch_error(lib, "graph", err)


def graph_handle(lib, stream) -> int:
    """A conditional handle of the graph capturing on `stream` (a torch
    stream)."""
    h = ctypes.c_uint64(0)
    check_graph(lib, lib.graph_handle(stream.cuda_stream, ctypes.byref(h)))
    return h.value
