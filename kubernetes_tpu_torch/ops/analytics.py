"""Device-resident cluster analytics (PyTorch port of the JAX package's
ops/analytics.py).

The cluster snapshot already lives on the device (codec/transfer.py
DeviceSnapshotCache keeps `allocatable` / `requested` / `valid` resident
and scatter-refreshed every cycle), so fleet-level analytics — utilization
percentiles, fragmentation, imbalance, occupancy — are one launch away.
`cluster_analytics` is that launch: kernel K5
(kernels/cluster_analytics.cu) on CUDA tensors, its plain twin
`cluster_analytics_plain` on CPU tensors.  It returns the ~50 outputs
packed in one 40-word buffer, so that one small D2H copy brings a sample
back to the telemetry hub (runtime/telemetry.py); `unpack` turns the
buffer into a ClusterAnalytics.

Bit-exactness contract (tests/test_torch_telemetry.py holds the twin to
the jitted JAX `cluster_analytics`, chip_smoke.py holds K5 to the twin):

  * every float sum is the order-pinned pairwise fold `_fold_sum`
    (zero-pad to a power of two, add halves until one row remains), so
    the sequence of IEEE adds is the reference's whichever device runs
    it; no multiply feeds an add through a fused multiply-add;
  * percentiles are sort + gather (nearest rank, the index rounded half
    to even), with the reference's stable sort in which -0.0 and 0.0 tie;
  * the masked maxima order -0.0 below 0.0, as XLA's max does (numpy's
    np.max returns whichever zero it meets first, so the numpy reference
    `cluster_analytics_np` and the jitted JAX function can disagree on the
    sign of a zero maximum; the port follows the jitted function);
  * divide and sqrt are correctly rounded.

`cluster_analytics_np` (the tests' reference; the port's hub never takes
it) and `analytics_to_dict` are kept numpy, as in the reference.  NaN inputs are outside the contract.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any

import numpy as np
import torch

from kubernetes_tpu_torch.codec.schema import (
    RES_EPHEMERAL,
    RES_MEMORY,
    RES_MILLICPU,
    RES_PODS,
)

# the core resource columns the analytics reduce over, in output order
RESOURCE_NAMES = ("cpu", "memory", "ephemeral", "pods")
_RES_COLS = (RES_MILLICPU, RES_MEMORY, RES_EPHEMERAL, RES_PODS)
# per-resource utilization statistics, in output order
STAT_NAMES = ("mean", "max", "p50", "p90", "p99")
_QUANTILES = (0.5, 0.9, 0.99)
# pods-per-node occupancy histogram bins: fraction of the node's pod
# capacity in use, [i/10, (i+1)/10) with the last bin catching 100%
OCC_BINS = 10
# the packed layout of one sample (kernel K5's output buffer): 32-bit words,
# float fields as their f32 bits, integer fields as int32
PACKED_LAYOUT = (
    ("utilization", 0, (4, 5), torch.float32),
    ("largest_free", 20, (4,), torch.float32),
    ("stranded", 24, (2,), torch.float32),
    ("fragmentation", 26, (), torch.float32),
    ("imbalance", 27, (), torch.float32),
    ("occupancy", 28, (OCC_BINS,), torch.int32),
    ("nodes", 38, (), torch.int32),
    ("pods_running", 39, (), torch.float32),
)
PACKED_WORDS = 40


@dataclass
class ClusterAnalytics:
    """One telemetry sample's device outputs (~50 numbers).

    utilization[r, s]: resource RESOURCE_NAMES[r] x stat STAT_NAMES[s],
    where a node's utilization is requested/allocatable (0 when the node
    allocates none of that resource); invalid (padding/recycled) rows are
    excluded from every statistic."""

    utilization: Any      # f32[4, 5]
    largest_free: Any     # f32[4]  max free capacity on any single node
    stranded: Any         # f32[2]  (cpu stranded by memory, memory
    #                       stranded by cpu)
    fragmentation: Any    # f32[]   stranded fraction of total free
    imbalance: Any        # f32[]   stddev of per-node dominant share
    occupancy: Any        # i32[OCC_BINS] nodes per pod-occupancy decile
    nodes: Any            # i32[]   valid nodes in the snapshot
    pods_running: Any     # f32[]   committed pods (sum of the pods col)


def _fold_sum(x, xp):
    """Order-pinned pairwise sum over axis 0: zero-pad to a pow2 length,
    add halves until one row remains.  The same sequence of IEEE adds in
    numpy, in torch and in kernel K5."""
    n = x.shape[0]
    if n == 0:
        if xp is torch:
            return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        return xp.zeros(x.shape[1:], x.dtype)
    k = 1 << (n - 1).bit_length()
    if k != n:
        if xp is torch:
            pad = torch.zeros((k - n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            x = torch.cat([x, pad], dim=0)
        else:
            x = xp.concatenate(
                [x, xp.zeros((k - n,) + x.shape[1:], x.dtype)], axis=0
            )
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = x[:h] + x[h:]
    return x[0]


def _analytics_np(allocatable, requested, valid):
    """The reference's shared implementation with xp = numpy, kept as the
    reference has it (the numpy reference the JAX package tests against)."""
    xp = np
    assert _RES_COLS == (0, 1, 2, 3)
    alloc = allocatable[:, :4].astype(np.float32)          # [N, 4]
    used = requested[:, :4].astype(np.float32)             # [N, 4]
    vmask = valid.astype(bool)                             # [N]
    zero, one = np.float32(0.0), np.float32(1.0)
    cap_ok = alloc > zero
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = used / alloc
    util = xp.where(vmask[:, None] & cap_ok, ratio, zero)
    free = xp.where(
        vmask[:, None], xp.maximum(alloc - used, zero), zero
    )
    free_cpu, free_mem = free[:, 0], free[:, 1]
    no_mem = vmask & ~(free_mem > zero)
    no_cpu = vmask & ~(free_cpu > zero)
    dom = xp.max(util, axis=1)                             # [N]
    occ = util[:, 3]
    bin_idx = xp.clip(
        xp.floor(occ * np.float32(OCC_BINS)).astype(np.int32),
        0, OCC_BINS - 1,
    )
    counted = vmask & cap_ok[:, 3]
    onehot = (
        (bin_idx[:, None] == xp.arange(OCC_BINS, dtype=np.int32)[None, :])
        & counted[:, None]
    ).astype(np.float32)                                   # [N, OCC_BINS]
    packed = xp.concatenate(
        [
            util,
            free,
            vmask.astype(np.float32)[:, None],
            xp.where(no_mem, free_cpu, zero)[:, None],
            xp.where(no_cpu, free_mem, zero)[:, None],
            xp.where(vmask, dom, zero)[:, None],
            xp.where(vmask, used[:, 3], zero)[:, None],
            onehot,
        ],
        axis=1,
    )
    S = _fold_sum(packed, xp)                              # [23]
    sum_util, sum_free = S[0:4], S[4:8]
    countf = S[8]
    stranded = S[9:11]
    sum_dom, pods_running = S[11], S[12]
    occupancy = S[13:23].astype(np.int32)
    count_i = countf.astype(np.int32)
    has_nodes = count_i > 0
    denom = xp.maximum(countf, one)
    neg_inf = np.float32(-np.inf)
    maxes = (
        xp.max(
            xp.where(
                vmask[:, None], xp.concatenate([util, free], axis=1),
                neg_inf,
            ),
            axis=0,
        )
        if util.shape[0] else xp.full((8,), neg_inf, np.float32)
    )
    maxes = xp.where(maxes == neg_inf, zero, maxes)
    max_util, largest_free = maxes[0:4], maxes[4:8]
    mean = xp.where(has_nodes, sum_util / denom, zero)
    if util.shape[0]:
        sorted_util = xp.sort(
            xp.where(vmask[:, None], util, np.float32(np.inf)), axis=0
        )
        qs = np.asarray(_QUANTILES, np.float32)
        idx = xp.round(qs * (countf - one)).astype(np.int32)
        idx = xp.clip(idx, 0, sorted_util.shape[0] - 1)
        quants = xp.where(has_nodes, sorted_util[idx], zero)  # [3, 4]
    else:
        quants = xp.zeros((len(_QUANTILES), 4), np.float32)
    utilization = xp.concatenate(
        [mean[None, :], max_util[None, :], quants], axis=0
    ).T                                                    # [4, 5]
    frag_dir = xp.where(
        sum_free[0:2] > zero,
        stranded / xp.maximum(sum_free[0:2], one),
        zero,
    )
    fragmentation = (
        np.float32(0.5) * frag_dir[0] + np.float32(0.5) * frag_dir[1]
    )
    mean_dom = xp.where(has_nodes, sum_dom / denom, zero)
    diff = xp.where(vmask, dom - mean_dom, zero)
    var = xp.where(has_nodes, _fold_sum(diff * diff, xp) / denom, zero)
    imbalance = xp.sqrt(var)
    return ClusterAnalytics(
        utilization=utilization,
        largest_free=largest_free,
        stranded=stranded,
        fragmentation=fragmentation,
        imbalance=imbalance,
        occupancy=occupancy,
        nodes=count_i,
        pods_running=pods_running,
    )


def cluster_analytics_np(allocatable, requested, valid) -> ClusterAnalytics:
    """The numpy reference (the JAX package's degraded-mode fallback)."""
    return _analytics_np(
        np.asarray(allocatable), np.asarray(requested), np.asarray(valid),
    )


def _order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of f32 values in their total order (-0.0 below 0.0)."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _key_value(k: torch.Tensor) -> torch.Tensor:
    return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)


def _masked_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max over `dim` in the total order of _order_key: the maximum XLA's
    max gives, +0.0 above -0.0 whatever their order."""
    return _key_value(torch.amax(_order_key(x), dim=dim))


def cluster_analytics_plain(allocatable: torch.Tensor,
                            requested: torch.Tensor,
                            valid: torch.Tensor) -> ClusterAnalytics:
    """K5's plain twin: the reference's `_analytics` in torch, on the
    tensors' device.  allocatable, requested f32[N, R >= 4], valid
    bool[N]."""
    dev = allocatable.device
    f32 = torch.float32
    alloc = allocatable[:, :4].to(f32)
    used = requested[:, :4].to(f32)
    vmask = valid.to(torch.bool)
    zero = torch.zeros((), dtype=f32, device=dev)
    n = alloc.shape[0]
    cap_ok = alloc > 0
    # the quotient is taken where alloc > 0 and selected away elsewhere
    util = torch.where(vmask[:, None] & cap_ok, used / alloc, zero)
    d = alloc - used
    # the reference's maximum(d, 0): +0.0 for -0.0, a NaN kept
    free = torch.where(vmask[:, None],
                       torch.where((d > 0) | torch.isnan(d), d, zero), zero)
    free_cpu, free_mem = free[:, 0], free[:, 1]
    no_mem = vmask & ~(free_mem > 0)
    no_cpu = vmask & ~(free_cpu > 0)
    dom = (_masked_max(util, 1) if n
           else torch.zeros(0, dtype=f32, device=dev))
    occ = util[:, 3]
    # floor(occ * 10) clipped to [0, 9] before the cast: what the
    # reference's saturating convert and clip give
    bin_idx = torch.clamp(torch.floor(occ * OCC_BINS), 0,
                          OCC_BINS - 1).to(torch.int32)
    counted = vmask & cap_ok[:, 3]
    onehot = ((bin_idx[:, None] == torch.arange(
        OCC_BINS, dtype=torch.int32, device=dev)[None, :])
        & counted[:, None]).to(f32)
    packed = torch.cat([
        util,
        free,
        vmask.to(f32)[:, None],
        torch.where(no_mem, free_cpu, zero)[:, None],
        torch.where(no_cpu, free_mem, zero)[:, None],
        torch.where(vmask, dom, zero)[:, None],
        torch.where(vmask, used[:, 3], zero)[:, None],
        onehot,
    ], dim=1)
    S = _fold_sum(packed, torch)                           # [23]
    sum_util, sum_free = S[0:4], S[4:8]
    countf = S[8]
    stranded = S[9:11]
    sum_dom, pods_running = S[11], S[12]
    occupancy = S[13:23].to(torch.int32)
    count_i = countf.to(torch.int32)
    has_nodes = count_i > 0
    denom = torch.clamp_min(countf, 1.0)
    neg_inf = torch.full((), float("-inf"), dtype=f32, device=dev)
    if n:
        maxes = _masked_max(torch.where(
            vmask[:, None], torch.cat([util, free], dim=1), neg_inf), 0)
    else:
        maxes = neg_inf.expand(8)
    maxes = torch.where(maxes == neg_inf, zero, maxes)
    max_util, largest_free = maxes[0:4], maxes[4:8]
    mean = torch.where(has_nodes, sum_util / denom, zero)
    if n:
        # a stable sort in which -0.0 and 0.0 tie, as the reference's
        sorted_util = torch.sort(
            torch.where(vmask[:, None], util, float("inf")), dim=0,
            stable=True).values
        qs = torch.tensor(_QUANTILES, dtype=f32, device=dev)
        idx = torch.round(qs * (countf - 1.0)).to(torch.int64)
        idx = torch.clamp(idx, 0, n - 1)
        quants = torch.where(has_nodes, sorted_util[idx], zero)   # [3, 4]
    else:
        quants = torch.zeros((len(_QUANTILES), 4), dtype=f32, device=dev)
    utilization = torch.cat([mean[None, :], max_util[None, :], quants],
                            dim=0).T.contiguous()          # [4, 5]
    half = torch.full((), 0.5, dtype=f32, device=dev)
    frag_dir = torch.where(sum_free[0:2] > 0,
                           stranded / torch.clamp_min(sum_free[0:2], 1.0),
                           zero)
    fragmentation = half * frag_dir[0] + half * frag_dir[1]
    mean_dom = torch.where(has_nodes, sum_dom / denom, zero)
    diff = torch.where(vmask, dom - mean_dom, zero)
    var = torch.where(has_nodes, _fold_sum(diff * diff, torch) / denom, zero)
    imbalance = torch.sqrt(var)
    return ClusterAnalytics(
        utilization=utilization,
        largest_free=largest_free.contiguous(),
        stranded=stranded.contiguous(),
        fragmentation=fragmentation,
        imbalance=imbalance,
        occupancy=occupancy.contiguous(),
        nodes=count_i,
        pods_running=pods_running,
    )


def pack(a: ClusterAnalytics) -> torch.Tensor:
    """A sample of tensors -> one int32[PACKED_WORDS] buffer (f32 fields
    as their bits), K5's output layout."""
    out = torch.empty(PACKED_WORDS, dtype=torch.int32,
                      device=torch.as_tensor(a.utilization).device)
    for name, off, shape, dtype in PACKED_LAYOUT:
        v = torch.as_tensor(getattr(a, name)).reshape(-1).to(dtype)
        if dtype == torch.float32:
            v = v.view(torch.int32)
        out[off:off + v.numel()] = v
    return out


def unpack(buf) -> ClusterAnalytics:
    """One int32[PACKED_WORDS] buffer (a tensor or a numpy array) -> the
    sample, views of the buffer of the same kind."""
    if isinstance(buf, torch.Tensor):
        words, f32 = buf, buf.view(torch.float32)
    else:
        words = np.asarray(buf, np.int32)
        f32 = words.view(np.float32)
    out = {}
    for name, off, shape, dtype in PACKED_LAYOUT:
        size = int(np.prod(shape)) if shape else 1
        src = f32 if dtype == torch.float32 else words
        out[name] = src[off:off + size].reshape(shape)
    return ClusterAnalytics(**out)


def cluster_analytics(allocatable: torch.Tensor, requested: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """The analytics of one snapshot as one int32[PACKED_WORDS] buffer on
    the inputs' device (`unpack` reads it): kernel K5 for CUDA tensors (a
    build or launch failure raises), the plain twin, packed, for CPU
    tensors.  The single-device form of the reference's
    cluster_analytics_auto (the mesh form waits for ROADMAP A11)."""
    if allocatable.is_cuda:
        from kubernetes_tpu_torch import kernels

        return kernels.cluster_analytics(allocatable, requested, valid)
    return pack(cluster_analytics_plain(allocatable, requested, valid))


def analytics_to_dict(a: ClusterAnalytics) -> dict:
    """Host-materialized sample -> the plain-JSON shape recorded in the
    telemetry ring."""
    a = ClusterAnalytics(**{
        f.name: (getattr(a, f.name).cpu().numpy()
                 if isinstance(getattr(a, f.name), torch.Tensor)
                 else getattr(a, f.name))
        for f in fields(a)})
    util = np.asarray(a.utilization, np.float32)
    return {
        "utilization": {
            RESOURCE_NAMES[r]: {
                STAT_NAMES[s]: float(util[r, s])
                for s in range(len(STAT_NAMES))
            }
            for r in range(len(RESOURCE_NAMES))
        },
        "largest_free": {
            RESOURCE_NAMES[r]: float(np.asarray(a.largest_free)[r])
            for r in range(len(RESOURCE_NAMES))
        },
        "stranded": {
            "cpu": float(np.asarray(a.stranded)[0]),
            "memory": float(np.asarray(a.stranded)[1]),
        },
        "fragmentation": float(np.asarray(a.fragmentation)),
        "imbalance": float(np.asarray(a.imbalance)),
        "occupancy": [int(x) for x in np.asarray(a.occupancy)],
        "nodes": int(np.asarray(a.nodes)),
        "pods_running": float(np.asarray(a.pods_running)),
    }
