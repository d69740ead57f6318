"""Host selection and the node-sampling knob (PyTorch port).

select_host reproduces the reference's argmax-with-round-robin-tie-break
(core/generic_scheduler.go:268-296 selectHost/findMaxScores): among the
feasible nodes with the maximum score, pick the (lastIndex % numTies)-th in
node order, and advance lastIndex each cycle so repeated ties rotate.

On CUDA tensors `select_hosts_batch` and `select_host` launch kernel K1
(kernels/select_hosts.cu).  `select_hosts_batch_plain` is K1's plain
PyTorch twin: tensors on the CPU take it, and on the card only a caller
that asks for it by name (select_impl="plain") does.  `select_topk_batch`
(the quality observatory's winner-pinned top-k) launches kernel K3
(kernels/select_topk.cu) on CUDA tensors the same way; its twin is
`select_topk_batch_plain`.

num_feasible_nodes_to_find reproduces the adaptive sampling formula
(generic_scheduler.go:434-453).
"""

from __future__ import annotations

from typing import Any, NamedTuple

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


class TopKQuality(NamedTuple):
    """Per-pod decision-quality outputs of the engines' `quality_topk`
    variant (the placement-quality observatory's raw signal,
    runtime/quality.py).

    top_nodes[..., K]: the K best-scoring feasible node rows with the
    WINNER PINNED AT COLUMN 0 (select_host's rotating-tie winner, not
    top-k's first-occurrence order, so column 0 always equals the
    committed placement); -1 where fewer than K nodes were feasible (and
    the whole row when the pod was unschedulable).
    top_scores[..., K]: those rows' total scores (0 in -1 slots).
    feasible[...]: how many candidate nodes the selector considered for
    the pod, the population of the post-sampling mask."""

    top_nodes: Any   # i32[..., K]
    top_scores: Any  # f32[..., K]
    feasible: Any    # i32[...]


def topk_width(k: int, n: int) -> int:
    """The top-k width of a [.., n] row: k clamped to n (k >= 1)."""
    if k < 1:
        raise ValueError(f"top-k wants k >= 1, got {k}")
    return min(int(k), int(n))


def order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 values in the total order the reference's top_k
    ranks by: -0.0 below 0.0, a positive NaN above +inf and a negative NaN
    below -inf (the f32 bits, with the low 31 bits flipped on a set sign
    bit)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def select_topk_batch_plain(scores, mask, hosts, feasible,
                            k: int) -> TopKQuality:
    """K3's plain twin: the winner-pinned top-k of each row of a [B, N]
    grid, given the SAME (scores, mask) the selector saw and its verdict
    (hosts i32[B], feasible bool[B]).  Column 0 is the winner (-1 when the
    row is infeasible); the other k-1 columns are the best of the row with
    the winner masked out, in the reference's top_k order (higher value
    first in the total order of `order_key`, the lower node first among
    equal values); a slot whose value is not above -1.7e38 (masked out)
    reads node -1 and score 0.  feasible is the mask's popcount; k is
    clamped to N.  A host outside [0, N) is read as the reference indexes
    (negative wraps once, then clamps) and masks out no column.

    Runner-ups come from k-1 passes of one argmax each over int64 keys
    (order key, then the complement of the node index) strictly below the
    previous pick's key: kernel K3's arithmetic."""
    B, N = scores.shape
    K = topk_width(k, N)
    dev = scores.device
    s = torch.where(mask, scores, _NEG)
    hosts = hosts.to(torch.int64)
    feasible = feasible.to(torch.bool)
    h_read = torch.where(hosts < 0, hosts + N, hosts).clamp(0, N - 1)
    win_val = torch.where(feasible, s.gather(1, h_read[:, None])[:, 0],
                          _NEG)
    vals = [win_val]
    idx = [torch.where(feasible, hosts, -1)]
    if K > 1:
        cols = torch.arange(N, dtype=torch.int64, device=dev)
        s2 = torch.where((cols[None, :] == hosts[:, None])
                         & feasible[:, None], _NEG, s)
        packed = (order_key(s2).to(torch.int64) * (1 << 31)
                  + ((1 << 31) - 1 - cols)[None, :])
        lowest = torch.iinfo(torch.int64).min
        thr = torch.full((B, 1), torch.iinfo(torch.int64).max,
                         dtype=torch.int64, device=dev)
        for _ in range(K - 1):
            cand = torch.where(packed < thr, packed, lowest)
            pos = torch.argmax(cand, dim=1, keepdim=True)
            thr = cand.gather(1, pos)
            vals.append(s2.gather(1, pos)[:, 0])
            idx.append(pos[:, 0])
    vals = torch.stack(vals, dim=1)
    idx = torch.stack(idx, dim=1)
    ok = vals > _NEG / 2
    return TopKQuality(
        top_nodes=torch.where(ok, idx, -1).to(torch.int32),
        top_scores=torch.where(ok, vals, 0.0),
        feasible=torch.sum(mask, dim=-1, dtype=torch.int32),
    )


def select_topk_plain(scores, mask, host, feasible, k: int) -> TopKQuality:
    """The one-row form of select_topk_batch_plain: (scores f32[N], mask
    bool[N], host i32, feasible bool) -> leaves of shape [K], [K], []."""
    q = select_topk_batch_plain(scores[None], mask[None],
                                torch.as_tensor(host).reshape(1),
                                torch.as_tensor(feasible).reshape(1), k)
    return TopKQuality(q.top_nodes[0], q.top_scores[0], q.feasible[0])


def select_topk_batch(scores, mask, hosts, feasible, k: int) -> TopKQuality:
    """Winner-pinned top-k over a [B, N] grid (see select_topk_batch_plain):
    CUDA tensors launch K3, CPU tensors take the plain twin."""
    if scores.is_cuda:
        return TopKQuality(*kernels.select_topk(scores, mask, hosts,
                                                feasible, k))
    return select_topk_batch_plain(scores, mask, hosts, feasible, k)


def select_topk(scores, mask, host, feasible, k: int) -> TopKQuality:
    """The one-row select_topk_batch: (scores f32[N], mask bool[N], host
    i32, feasible bool) -> leaves of shape [K], [K], []: the B=1 launch of
    K3 on CUDA tensors."""
    q = select_topk_batch(scores[None], mask[None],
                          torch.as_tensor(host).reshape(1),
                          torch.as_tensor(feasible).reshape(1), k)
    return TopKQuality(q.top_nodes[0], q.top_scores[0], q.feasible[0])
