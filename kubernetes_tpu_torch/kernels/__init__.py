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

Each wrapper counts its launches in `LAUNCHES` (one each time it launches
its kernels, nowhere else), so a run can show that its main path went
through the kernels; `select_hosts_b1` also counts K1's one-row launches (the
sequential engine's steps) on their own.  A preempt_one call puts one
kernel launch on the stream, no memset and no copy (chip_smoke.py counts
them under torch.profiler); the first call on a stream also zeroes that
stream's ticket.  K3, K4, K6 and K7 put one kernel launch each on the
stream; K5 one up to K5_ONE_LAUNCH_ROWS snapshot rows and, above, a
sequence of launches (cluster_analytics.cu launch_wide), counted once a
call.  K8 and K10 put one kernel launch each on the stream, K9 one per
K9_MAX_LANES lanes (counted once a call).
The kernels are built from source at the first launch
(kernels/_build.py); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import torch

LAUNCHES = {"select_hosts": 0, "select_hosts_b1": 0, "preempt_one": 0,
            "select_topk": 0, "select_topk_b1": 0, "binpack_ffd": 0,
            "cluster_analytics": 0, "commit_group_counts": 0,
            "fold_predicates": 0, "ffd_order": 0, "binpack_counts": 0,
            "reconcile_admit": 0}

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


def reset_launch_counts() -> None:
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


def select_hosts(scores: torch.Tensor, mask: torch.Tensor,
                 last_index0: int):
    """K1: (scores f32[B, N], mask bool[B, N], last_index0 int) ->
    (hosts i32[B], feasible bool[B]) on the tensors' CUDA device; row b
    rotates its tie-break by last_index0 + b.  The variant follows from
    (B, N, alignment), see k1_variant.  Raises on anything the kernel does
    not take and on a refused launch."""
    _check_rows("select_hosts", scores, mask)
    B, N = scores.shape
    if N == 0 or N >= (1 << 31):
        raise ValueError(f"select_hosts wants 0 < N < 2^31, got {N}")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    scores = scores.contiguous()
    mask = mask.contiguous()
    hosts = torch.empty(B, dtype=torch.int32, device=scores.device)
    feasible = torch.empty(B, dtype=torch.bool, device=scores.device)
    variant = k1_variant(B, N, scores.data_ptr(), mask.data_ptr())
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.select_hosts_launch(
            scores.data_ptr(), mask.data_ptr(), B, N, wrap_i32(last_index0),
            hosts.data_ptr(), feasible.data_ptr(), variant, stream)
    if err != 0:
        raise RuntimeError("select_hosts launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    if B:
        LAUNCHES["select_hosts"] += 1
        if B == 1:
            LAUNCHES["select_hosts_b1"] += 1
    return hosts, feasible


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


def select_topk(scores: torch.Tensor, mask: torch.Tensor,
                hosts: torch.Tensor, feasible: torch.Tensor, k: int):
    """K3: (scores f32[B, N], mask bool[B, N], hosts i32[B], feasible
    bool[B], k) -> (top_nodes i32[B, K], top_scores f32[B, K],
    feasible_count i32[B]) with K = min(k, N), on the tensors' CUDA
    device; hosts and feasible are the selector's verdict on the same
    rows (see ops/select.py select_topk_batch_plain).  Raises on anything
    the kernel does not take and on a refused launch."""
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
    top_nodes = torch.empty((B, K), dtype=torch.int32, device=dev)
    top_scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    count = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return top_nodes, top_scores, count
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (scores, mask, hosts, feasible)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.select_topk_launch(
            *(t.data_ptr() for t in ts), B, N, K, top_nodes.data_ptr(),
            top_scores.data_ptr(), count.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("select_topk launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    LAUNCHES["select_topk"] += 1
    if B == 1:
        LAUNCHES["select_topk_b1"] += 1
    return top_nodes, top_scores, count


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


def binpack_counts(reqs: torch.Tensor, counts: torch.Tensor,
                   caps: torch.Tensor, order: torch.Tensor, n_bins: int,
                   per_bin: bool, want_loads: bool = False):
    """K8: the count-carrying first-fit scan of classes reqs f32[C, R] with
    counts i32[C], in order i32[S, C], on one CUDA device.  Uniform
    (per_bin False): lane s packs into n_bins bins of caps[s] (caps
    f32[S, R]).  Per-bin (per_bin True, S 1): bin b has capacity caps[b]
    (caps f32[n_bins, R]).  Returns (used i32[S], placed i32[S, C] in scan
    positions, loads f32[S, n_bins, R] or None, touched bool[n_bins] in
    per-bin mode else None); see models/binpack.py binpack_counts_plain.
    Raises on anything the kernel does not take and on a refused launch."""
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
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in (reqs, counts, caps, order)]
    used = torch.empty(S, dtype=torch.int32, device=dev)
    placed = torch.empty((S, C), dtype=torch.int32, device=dev)
    loads = (torch.empty((S, n_bins, R), dtype=torch.float32, device=dev)
             if want_loads else None)
    touched = (torch.empty(n_bins, dtype=torch.bool, device=dev)
               if per_bin else None)
    work = torch.empty(int(lib.binpack_counts_workspace_floats(S, n_bins, R)),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _launch_error(lib, "binpack_counts", lib.binpack_counts_launch(
            ts[0].data_ptr(), ts[1].data_ptr(), C, R, ts[2].data_ptr(),
            int(per_bin), int(n_bins), ts[3].data_ptr(), S, work.data_ptr(),
            used.data_ptr(), placed.data_ptr(),
            loads.data_ptr() if loads is not None else None,
            touched.data_ptr() if touched is not None else None, stream))
    LAUNCHES["binpack_counts"] += 1
    return used, placed, loads, touched


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
