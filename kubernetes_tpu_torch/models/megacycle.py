"""Device-resident megacycle: K pre-encoded windows in one dispatch
(PyTorch port of the JAX package's models/megacycle.py).

The live cycle pays one host round trip a window: dispatch, fence, fetch
the winners, commit.  The megacycle chains K windows through the cluster
state on the device instead, window k + 1 filtering and scoring against
the state window k committed, and returns all K winner vectors at once,
so the host pays one dispatch, one fence and one winners fetch per K
windows and commits them behind the next megacycle's dispatch
(runtime/scheduler.py).

What chains between windows (the carry, kept on the device):

  requested[N, R] / nonzero_req[N, 2]   resource commits, the engine's own
                                        returned state
  group_counts[N, G]                    SelectorSpread per-group counts:
                                        each committed pod adds one to
                                        every group it matches at its
                                        landing node (kernel K6,
                                        commit_group_counts); integer
                                        counts in f32, bit-identical to the
                                        host commit's recount

Everything else comes from the dispatch snapshot unchanged, which is exact
only for windows whose cross-window coupling is resources and spread: the
scheduler's gates (Scheduler._megacycle_ready / _megacycle_safe) admit
only those, as in the reference.

Each window runs the port's single-cycle engine as it is
(models/speculative.py or models/batched.py), so a megacycle of K windows
places exactly as K chained single cycles by construction.  Where the JAX
reference scans the windows inside one jitted program, the port's windows
are a host loop over device work: between windows nothing is fetched and
nothing is copied to the host (a plain window of the speculative engine is
one CUDA graph, its rounds and redo decided on the card).  The carry never
aliases a tensor that is written in place: the engines return new
requested/nonzero tensors and K6 writes a fresh group_counts, so the live
scheduler's resident snapshot (refreshed in place by the dirty-row
scatter) is only ever read.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.codec import transfer
from kubernetes_tpu_torch.codec.schema import (
    FilterConfig,
    PodBatch,
    ScoreConfig,
)
from kubernetes_tpu_torch.kernels import wrap_i32
from kubernetes_tpu_torch.models.batched import (
    BatchPortState,
    check_exact_matmul,
    make_sequential_scheduler,
)
from kubernetes_tpu_torch.models.speculative import make_speculative_scheduler
from kubernetes_tpu_torch.ops.select import TopKQuality


def stack_windows(trees: Sequence):
    """Stack K same-shaped dataclasses of host arrays (PodBatch,
    BatchPortState) along a new leading K axis, field by field in numpy:
    what the megacycle uploads once and slices per window.  Shapes must
    already agree (the scheduler re-encodes once after a sticky-dim
    growth to guarantee it)."""
    cls = type(trees[0])
    return cls(**{
        f.name: np.stack([np.asarray(getattr(t, f.name)) for t in trees])
        for f in dataclasses.fields(cls)
    })


def _window(stacked, cls, k: int):
    """Window k of a stacked dataclass of tensors (views, no copy)."""
    return cls(**{f.name: getattr(stacked, f.name)[k]
                  for f in dataclasses.fields(cls)})


def commit_group_counts_plain(gc: torch.Tensor, hosts: torch.Tensor,
                              group_ids: torch.Tensor,
                              group_valid: torch.Tensor) -> torch.Tensor:
    """K6's plain twin, the reference's formula: gc f32[N, G] plus the
    window's node one-hot [B, N] transposed times its pods' group one-hot
    [B, G] (ops/priorities.py pod_group_onehot: a group in two valid slots
    counts twice), as a new tensor.  hosts < 0 adds nothing.  Exact: the
    product's entries are small integers."""
    N, G = gc.shape
    dev = gc.device
    groups = torch.arange(G, device=dev)
    onehot_g = ((group_ids[:, :, None] == groups[None, None])
                & group_valid[..., None]).to(torch.float32).sum(dim=1)
    node_oh = ((hosts[:, None] == torch.arange(N, device=dev)[None, :])
               & (hosts >= 0)[:, None]).to(torch.float32)     # [B, N]
    return gc + torch.matmul(node_oh.T, onehot_g)


def commit_group_counts(gc: torch.Tensor, hosts: torch.Tensor,
                        pods: PodBatch) -> torch.Tensor:
    """Fold one window's placements into the carried spread counts: K6 on
    CUDA tensors (it launches or raises), its plain twin on CPU tensors.
    Returns a new tensor; gc is not written."""
    if gc.is_cuda:
        from kubernetes_tpu_torch import kernels

        return kernels.commit_group_counts(gc, hosts, pods.group_ids,
                                           pods.group_valid)
    return commit_group_counts_plain(gc, hosts, pods.group_ids,
                                     pods.group_valid)


_MEGA_CACHE: "OrderedDict" = OrderedDict()
_MEGA_CACHE_CAP = 16


def make_megacycle_scheduler(
    cfg: FilterConfig = FilterConfig(),
    weights=None,
    unsched_taint_key: int = 0,
    zone_key_id: int = 5,
    score_cfg: Optional[ScoreConfig] = None,
    percentage_of_nodes_to_score: int = 100,
    engine: str = "sequential",
    quality_topk: int = 0,
    device="cuda",
    select_impl: str = "kernel",
):
    """Build (or fetch the memoized) megacycle driver.

    Returns fn(cluster, pods_k, ports_k, last_index0_k) -> (hosts i32[K, B]
    on the device, new_cluster) where pods_k / ports_k carry a leading K
    axis on every field (stack_windows) and last_index0_k holds the K
    windows' selectHost rotation bases (the scheduler passes the base plus
    the cumulative raw pod counts, the values K separate cycles would have
    seen; each is taken as an int32 and wraps).  new_cluster carries the
    final chained requested / nonzero_req / group_counts and shares every
    other field with `cluster`.

    quality_topk=K' > 0 (output-only): the call returns (hosts,
    new_cluster, TopKQuality) whose leaves carry a leading K axis ([K, B,
    K'] and [K, B]): each window's winner-pinned top-k against exactly the
    chained state its placements saw.

    `engine` picks each window's program: the exact sequential engine or
    the speculative one (with its contention redo).  Memoized like the
    reference's _MEGA_CACHE: one driver per configuration."""
    device = torch.device(device)
    key = (
        cfg,
        (tuple(np.asarray(weights, np.float32)) if weights is not None
         else None),
        unsched_taint_key,
        zone_key_id,
        score_cfg,
        percentage_of_nodes_to_score,
        engine,
        quality_topk,
        str(device),
        select_impl,
    )
    hit = _MEGA_CACHE.get(key)
    if hit is not None:
        _MEGA_CACHE.move_to_end(key)
        return hit

    engine_kw = dict(
        cfg=cfg, weights=weights, unsched_taint_key=unsched_taint_key,
        zone_key_id=zone_key_id, score_cfg=score_cfg,
        percentage_of_nodes_to_score=percentage_of_nodes_to_score,
        quality_topk=quality_topk, device=device, select_impl=select_impl,
    )
    one = (make_speculative_scheduler(**engine_kw) if engine == "speculative"
           else make_sequential_scheduler(**engine_kw))

    def schedule_mega(cluster, pods_k, ports_k, last_index0_k):
        """Host entry: the stacked windows go up in one upload (a tensor a
        field, sliced per window on the device), then the K windows run
        back to back against the chained carry."""
        check_exact_matmul(device)
        cluster = transfer.upload_cluster(cluster, device)
        pods_k = transfer._dc_to(pods_k, PodBatch, device, "batch")
        ports_k = transfer._dc_to(ports_k, BatchPortState, device, "batch")
        bases = [wrap_i32(x) for x in np.asarray(last_index0_k).reshape(-1)]
        req, nz = cluster.requested, cluster.nonzero_req
        gc = cluster.group_counts
        hosts_k, qual_k = [], []
        for k, li0 in enumerate(bases):
            pods = _window(pods_k, PodBatch, k)
            cl = dataclasses.replace(cluster, requested=req, nonzero_req=nz,
                                     group_counts=gc)
            out = one(cl, pods, _window(ports_k, BatchPortState, k), li0)
            hosts, new_cl = out[0], out[1]
            req, nz = new_cl.requested, new_cl.nonzero_req
            gc = commit_group_counts(gc, hosts, pods)
            hosts_k.append(hosts)
            if quality_topk:
                qual_k.append(out[2])
        new_cluster = dataclasses.replace(cluster, requested=req,
                                          nonzero_req=nz, group_counts=gc)
        hosts_k = torch.stack(hosts_k)
        if quality_topk:
            return hosts_k, new_cluster, TopKQuality(
                *(torch.stack(leaf) for leaf in zip(*qual_k)))
        return hosts_k, new_cluster

    schedule_mega.engine_kind = engine
    schedule_mega.quality_topk = quality_topk
    _MEGA_CACHE[key] = schedule_mega
    while len(_MEGA_CACHE) > _MEGA_CACHE_CAP:
        _MEGA_CACHE.popitem(last=False)
    return schedule_mega
