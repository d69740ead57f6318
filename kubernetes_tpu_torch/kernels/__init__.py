"""Hand-written CUDA kernels of the port, and their launch wrappers.

K1 `select_hosts` (select_hosts.cu) replaces the JAX package's
ops/select.py select_host / select_hosts_batch.  Its plain PyTorch twin is
ops/select.py `select_hosts_batch_plain`; ops/select.py dispatches to the
kernel for CUDA tensors.

K2 `preempt_one` (preempt_one.cu) replaces the JAX package's
models/preemption.py preempt_one and _exact_prio_sum.  Its plain twin is
models/preemption.py `preempt_one_plain`; models/preemption.py
`preempt_one` dispatches to the kernel for CUDA tensors.

Each wrapper counts its launches in `LAUNCHES` (one each time it launches
its kernels, nowhere else), so a run can show that its main path went
through the kernels; `select_hosts_b1` also counts K1's one-row launches (the
sequential engine's steps) on their own.  A preempt_one call puts one
kernel launch on the stream, no memset and no copy (chip_smoke.py counts
them under torch.profiler); the first call on a stream also zeroes that
stream's ticket.  The kernels are built from source at the first launch
(kernels/_build.py); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import torch

LAUNCHES = {"select_hosts": 0, "select_hosts_b1": 0, "preempt_one": 0}

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
K2_MAX_COLS = 64          # extended resource columns
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


def select_hosts(scores: torch.Tensor, mask: torch.Tensor,
                 last_index0: int):
    """K1: (scores f32[B, N], mask bool[B, N], last_index0 int) ->
    (hosts i32[B], feasible bool[B]) on the tensors' CUDA device; row b
    rotates its tie-break by last_index0 + b.  The variant follows from
    (B, N, alignment), see k1_variant.  Raises on anything the kernel does
    not take and on a refused launch."""
    if not (scores.is_cuda and mask.is_cuda):
        raise ValueError("select_hosts launches on CUDA tensors only")
    if scores.dtype != torch.float32 or mask.dtype != torch.bool:
        raise TypeError(f"select_hosts wants f32 scores and a bool mask, "
                        f"got {scores.dtype} and {mask.dtype}")
    if scores.dim() != 2 or mask.shape != scores.shape:
        raise ValueError(f"select_hosts wants matching [B, N] scores and "
                         f"mask, got {tuple(scores.shape)} and "
                         f"{tuple(mask.shape)}")
    if scores.device != mask.device:
        raise ValueError("scores and mask lie on different devices")
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
    if not (0 < E <= K2_MAX_COLS and VT <= E):
        raise ValueError(f"preempt_one takes 1 to {K2_MAX_COLS} columns "
                         f"with VT <= E, got E={E} VT={VT}")
    from kubernetes_tpu_torch.kernels._build import library

    lib = library()
    ts = [t.contiguous() for t in tensors]
    workspace = torch.empty(lib.preempt_one_workspace_ints(N, K, V),
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
