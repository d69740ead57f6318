"""Host selection and the node-sampling knob (PyTorch port).

select_host reproduces the reference's argmax-with-round-robin-tie-break
(core/generic_scheduler.go:268-296 selectHost/findMaxScores): among the
feasible nodes with the maximum score, pick the (lastIndex % numTies)-th in
node order, and advance lastIndex each cycle so repeated ties rotate.

On CUDA tensors `select_hosts_batch` and `select_host` launch kernel K1
(kernels/select_hosts.cu).  `select_hosts_batch_plain` is K1's plain
PyTorch twin: tensors on the CPU take it, and on the card only a caller
that asks for it by name (select_impl="plain") does.

num_feasible_nodes_to_find reproduces the adaptive sampling formula
(generic_scheduler.go:434-453).
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch import kernels

MIN_FEASIBLE_NODES_TO_FIND = 100          # generic_scheduler.go:52-57
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5  # generic_scheduler.go:58-63
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 50  # api/types.go:40

SELECT_IMPLS = ("kernel", "plain")
_NEG = -3.4e38


def num_feasible_nodes_to_find(num_all_nodes: int, percentage: int = 0) -> int:
    """generic_scheduler.go:434-453 numFeasibleNodesToFind."""
    if num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND or percentage >= 100:
        return num_all_nodes
    adaptive = percentage
    if adaptive == 0:
        adaptive = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num_nodes = num_all_nodes * adaptive // 100
    if num_nodes < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num_nodes


def num_feasible_nodes_device(num_all: torch.Tensor, percentage: int):
    """num_feasible_nodes_to_find with a device node count (i32 tensor)."""
    if percentage == 0:
        adaptive = torch.clamp_min(
            DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE - num_all // 125,
            MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND)
    else:
        adaptive = percentage
    num = torch.clamp_min(num_all * adaptive // 100, MIN_FEASIBLE_NODES_TO_FIND)
    return torch.where(num_all < MIN_FEASIBLE_NODES_TO_FIND, num_all,
                       num).to(torch.int32)


def _wrap_i32_tensor(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor -> the int32 values two's-complement wrap gives."""
    return (torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)).to(torch.int32)


def rotation_counters(last_index0: int, B: int, device) -> torch.Tensor:
    """i32[B]: last_index0 + b with the reference's int32 wrap."""
    idx = torch.arange(B, dtype=torch.int64, device=device)
    return _wrap_i32_tensor(idx + kernels.wrap_i32(last_index0))


def limit_feasible(mask, limit, start):
    """Keep only the first `limit` feasible nodes in round-robin order from
    `start` — the device form of findNodesThatFit's adaptive early exit
    (generic_scheduler.go:457-556).

    mask bool[..., N]; limit i32 (tensor or int); start i32 scalar or i32[...]
    (one start per row) -> bool[..., N]."""
    n = mask.shape[-1]
    start = torch.as_tensor(start, device=mask.device).to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=mask.device)
    # (idx - start) in int32 as the reference computes it, then floor mod n
    rot = torch.remainder(_wrap_i32_tensor(idx - start[..., None]), n)
    rot = rot.expand(mask.shape)
    order = torch.argsort(rot, dim=-1, stable=True)   # node ids in scan order
    feas_sorted = torch.gather(mask, -1, order)
    rank = torch.cumsum(feas_sorted.to(torch.int32), dim=-1) - 1
    keep_sorted = feas_sorted & (rank < torch.as_tensor(limit, device=mask.device))
    inv = torch.argsort(order, dim=-1, stable=True)
    return torch.gather(keep_sorted, -1, inv)


def select_hosts_batch_plain(scores, mask, last_index0: int):
    """K1's plain twin: (scores f32[B, N], mask bool[B, N], last_index0) ->
    (hosts i32[B], feasible bool[B]); pod b rotates by last_index0 + b."""
    B = scores.shape[0]
    s = torch.where(mask, scores, _NEG)
    best = torch.amax(s, dim=-1, keepdim=True)        # NaN propagates
    feasible = torch.any(mask, dim=-1)
    is_tie = mask & (s == best)
    num_ties = torch.sum(is_tie, dim=-1, dtype=torch.int32)
    li = rotation_counters(last_index0, B, scores.device)
    k = torch.where(num_ties > 0,
                    torch.remainder(li, torch.clamp_min(num_ties, 1)), 0)
    rank = torch.cumsum(is_tie.to(torch.int32), dim=-1) - 1   # rank among ties
    pick = is_tie & (rank == k[:, None])
    # index of the (k+1)-th tie in node order (first max of the pick row;
    # 0 for a row without ties)
    host = torch.argmax(pick.to(torch.uint8), dim=-1)
    return host.to(torch.int32), feasible


def select_hosts_batch(scores, mask, last_index0: int, impl: str = "kernel"):
    """Vectorized independent selection for a [B, N] grid: pod b uses
    rotation counter last_index0 + b.  CUDA tensors launch K1 unless
    impl == "plain"; CPU tensors take the plain twin."""
    if impl not in SELECT_IMPLS:
        raise ValueError(f"select impl {impl!r} not in {SELECT_IMPLS}")
    if scores.is_cuda and impl == "kernel":
        return kernels.select_hosts(scores, mask, last_index0)
    return select_hosts_batch_plain(scores, mask, last_index0)


def select_host(scores, mask, last_index: int, impl: str = "kernel"):
    """(scores f32[N], mask bool[N], last_index) -> (host i32, feasible bool)
    as 0-d tensors: the B=1 case of select_hosts_batch.  host is 0 when
    nothing is feasible — check `feasible`."""
    hosts, feasible = select_hosts_batch(scores[None], mask[None], last_index,
                                         impl)
    return hosts[0], feasible[0]
