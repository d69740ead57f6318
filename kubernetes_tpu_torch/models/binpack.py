"""First-fit binpack (PyTorch port of the JAX package's models/binpack.py).

  * `binpack_ffd`: one step per pod, in `order`; state = the bin load
    matrix [max_bins, R]; per step the pod goes into the FIRST bin whose
    loads plus its request stay within capacity (opening a new bin is
    fitting into a zero row).  The quality observatory's regret
    counterfactual (runtime/quality.py) and the per-pod what-if sweep
    (`binpack_shapes`) run it.
  * `ffd_order`: the shape-relative first-fit-decreasing order (dominant
    fraction of the shape's capacity, then the fraction vector column by
    column, then the input index), which the per-pod and the
    class-compressed sweeps share.
  * `binpack_ffd_counts`: the count-carrying first-fit, one step a class
    of identical pods: each bin admits floor(free / req) of them, and the
    class fills bins by a prefix sum.  Bins-needed identical to the per-pod
    scan in the same class order when every value is an integer below
    2**24 (INT_EXACT_LIMIT): the admission runs in int32.
  * `binpack_shapes` / `binpack_shapes_compressed`: the what-if sweep over
    candidate shapes, per pod or per class; `what_if` is the autoscaler's
    entry, and the capacity planner (runtime/capacity.py) runs the two
    stages on the count scan.

On CUDA tensors `binpack_ffd` launches kernel K4 (kernels/binpack_ffd.cu),
`ffd_order_batch` K9 (kernels/ffd_order.cu) and `binpack_counts` K8
(kernels/binpack_counts.cu); `binpack_ffd_plain`, `ffd_order_plain` and
`binpack_counts_plain` are their plain twins, which CPU tensors take.
`what_if_sharded` (the shape axis over a device mesh) waits for ROADMAP
A11.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch import kernels

# integer-exactness ceiling of the reference's count-carrying kernel: all
# request / capacity values integer-valued and strictly below this
INT_EXACT_LIMIT = float(2 ** 24)


def _bins(pod_reqs, capacity, max_bins):
    """(capacity as [max_bins, R], max_bins) as the reference reads them:
    a 2-D capacity is one row a bin (max_bins must equal its rows), a 1-D
    one is every bin's."""
    if capacity.dim() == 2:
        if max_bins is not None and max_bins != capacity.shape[0]:
            raise ValueError(f"max_bins {max_bins} != capacity rows "
                             f"{capacity.shape[0]}")
        return capacity, capacity.shape[0]
    nb = 1024 if max_bins is None else int(max_bins)
    return capacity[None, :].expand(nb, pod_reqs.shape[1]), nb


def _order(pod_reqs, order):
    if order is None:
        return torch.arange(pod_reqs.shape[0], dtype=torch.int32,
                            device=pod_reqs.device)
    return order.to(torch.int32)


def binpack_ffd_plain(pod_reqs, capacity, max_bins=None, order=None):
    """K4's plain twin: first-fit of pod_reqs f32[P, R] into bins of
    `capacity`, f32[max_bins, R] (per-bin: a zero row is a full bin) or
    f32[R] (every bin; max_bins bins, 1,024 if not given).  Pods are taken
    in `order` i32[P] (default: their own order; a negative entry wraps
    once and an entry out of range clamps, as the reference indexes); zero
    rows are skipped.  Returns (n_bins i32[], loads f32[max_bins, R],
    placed bool[P]); placed[k] refers to pod order[k] (see
    placed_by_pod)."""
    cap, nb = _bins(pod_reqs, capacity, max_bins)
    P = pod_reqs.shape[0]
    loads = torch.zeros((nb, pod_reqs.shape[1]), dtype=torch.float32,
                        device=pod_reqs.device)
    # a pod without a positive request is skipped (placed, nothing added)
    real = torch.any(pod_reqs > 0, dim=-1).tolist()
    placed = []
    for oi in _order(pod_reqs, order).tolist():
        oi = min(max(oi + P if oi < 0 else oi, 0), P - 1)
        if not real[oi]:
            placed.append(True)
            continue
        req = pod_reqs[oi]
        fits = torch.all(loads + req[None, :] <= cap, dim=-1)
        idx = int(torch.argmax(fits.to(torch.uint8)))   # the first fit
        ok = bool(fits[idx])
        if ok:
            loads[idx] = loads[idx] + req
        placed.append(ok)
    placed = torch.tensor(placed, dtype=torch.bool, device=pod_reqs.device)
    used = torch.sum(torch.any(loads > 0, dim=-1), dtype=torch.int32)
    return used, loads, placed


def binpack_ffd(pod_reqs, capacity, max_bins=None, order=None):
    """binpack_ffd_plain's contract: CUDA tensors launch K4, CPU tensors
    take the plain twin."""
    if pod_reqs.is_cuda:
        if capacity.dim() != 2 and max_bins is None:
            max_bins = 1024
        return kernels.binpack_ffd(pod_reqs, capacity,
                                   _order(pod_reqs, order), max_bins)
    return binpack_ffd_plain(pod_reqs, capacity, max_bins, order)


def placed_by_pod(placed, order=None):
    """Scatter binpack_ffd's scan-position-aligned `placed` flags back to
    POD indices: out[p] says whether pod p (row p of pod_reqs) was placed.
    With the default identity order the flags pass through unchanged."""
    placed = np.asarray(placed)
    if order is None:
        return placed.copy()
    order = np.asarray(order)
    if order.shape[0] != placed.shape[0]:
        raise ValueError(
            f"order length {order.shape[0]} != placed length "
            f"{placed.shape[0]} (placed is scan-position aligned)"
        )
    out = np.empty_like(placed)
    out[order] = placed
    return out


# ------------------------------------------------------------ FFD order

_NAN_KEY = 0x7FC00000


def _desc_keys(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of -x in the order the reference's sort comparator uses:
    every zero canonicalised to +0.0, every NaN to one +NaN (last), the
    rest in IEEE total order, so ascending keys are descending x."""
    v = -x
    v = torch.where(v == 0, torch.zeros_like(v), v).contiguous()
    bits = v.view(torch.int32)
    bits = torch.where(torch.isnan(v), torch.full_like(bits, _NAN_KEY), bits)
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def ffd_order_plain(reqs: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """K9's plain twin: the FFD order of items reqs f32[C, R] under each
    lane's capacity caps f32[S, R] -> i32[S, C].  frac = reqs /
    max(cap, 1e-30) (IEEE f32); the primary key is max(frac) descending,
    then frac[:, 0], frac[:, 1], ... descending, then the input index:
    jnp.lexsort's stable order, as a chain of stable sorts from the least
    significant key up."""
    S, (C, R) = caps.shape[0], reqs.shape
    capm = torch.maximum(caps, torch.tensor(1e-30, dtype=torch.float32,
                                            device=caps.device))
    frac = reqs[None, :, :] / capm[:, None, :]
    keys = [_desc_keys(frac[..., r]) for r in range(R - 1, -1, -1)]
    keys.append(_desc_keys(frac.amax(-1)))
    order = torch.arange(C, device=reqs.device).expand(S, C)
    for k in keys:
        idx = torch.sort(k.gather(1, order), dim=1, stable=True).indices
        order = order.gather(1, idx)
    return order.to(torch.int32)


def ffd_order_batch(reqs: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """ffd_order_plain's contract: CUDA tensors launch K9, CPU tensors take
    the plain twin."""
    if reqs.is_cuda:
        return kernels.ffd_order(reqs, caps)
    return ffd_order_plain(reqs, caps)


def ffd_order(reqs: torch.Tensor, capacity: torch.Tensor) -> torch.Tensor:
    """The reference's ffd_order: the order i32[C] of reqs f32[C, R] under
    one capacity f32[R]."""
    return ffd_order_batch(reqs, capacity[None, :])[0]


# ------------------------------------------------- count-carrying scan

_I32_MAX = 2 ** 31 - 1


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to what int32 two's-complement arithmetic
    gives (still int64)."""
    return torch.remainder(x + 2 ** 31, 2 ** 32) - 2 ** 31


def binpack_counts_plain(reqs: torch.Tensor, counts: torch.Tensor,
                         caps: torch.Tensor, order: torch.Tensor,
                         n_bins: int, per_bin: bool,
                         want_loads: bool = False, work=None):
    """K8's plain twin: lane s packs counts[c] items of each class reqs[c]
    (f32[C, R], counts i32[C]) in order[s] (i32[S, C]) into n_bins bins:
    of caps[s] each (uniform, caps f32[S, R]), or of caps[b] (per_bin,
    caps f32[n_bins, R], S 1; a zero row is a full node).  The reference's
    step, in int32 arithmetic (emulated in int64, wrapped): admission a_b =
    clip(min over requested columns of floor((cap - int(load)) / req), 0,
    m), an exclusive prefix sum, the fill n_b = clip(m - c_b, 0, a_b), loads
    += float(n_b * req).  Returns (used i32[S], placed i32[S, C] in scan
    positions, loads f32[S, n_bins, R] or None, touched bool[n_bins] in
    per-bin mode else None); want_loads only decides whether loads are
    returned, so the twin and the kernel share a signature.  work: a dict
    whose "bin_columns" gains, for every step, (the last bin the step
    fills + 1) x the class's requested columns — the admissions first-fit
    must evaluate on this data (a step need not look past its last fill).
    """
    S, C = order.shape
    R = reqs.shape[1]
    dev = reqs.device
    cap_i = caps.to(torch.int32).to(torch.int64)
    cap_i = cap_i[None, :, :] if per_bin else cap_i[:, None, :]
    loads = torch.zeros((S, n_bins, R), dtype=torch.float32, device=dev)
    placed = torch.empty((S, C), dtype=torch.int32, device=dev)
    oi = order.to(torch.int64)
    oi = torch.where(oi < 0, oi + C, oi).clamp(0, C - 1)
    counts = counts.to(torch.int64)
    for k in range(C):
        o = oi[:, k]
        req = reqs[o]
        req_i = req.to(torch.int32).to(torch.int64)
        m = counts[o]
        real = (req > 0).any(-1)
        rem = _wrap32(cap_i - loads.to(torch.int32).to(torch.int64))
        q = torch.div(rem, req_i.clamp(min=1)[:, None, :],
                      rounding_mode="floor")
        per = torch.where(req_i[:, None, :] > 0, q,
                          torch.full_like(q, _I32_MAX))
        a = torch.minimum(per.amin(-1).clamp(min=0), m[:, None])
        c = _wrap32(torch.cumsum(a, -1) - a)
        n = torch.minimum(_wrap32(m[:, None] - c).clamp(min=0), a)
        n = torch.where((real & (m > 0))[:, None], n, torch.zeros_like(n))
        if work is not None:
            reach = ((n > 0) * torch.arange(1, n_bins + 1, device=dev)).amax(
                -1)
            work["bin_columns"] = work.get("bin_columns", 0) + int(
                (reach * (req_i > 0).sum(-1)).sum())
        loads = loads + _wrap32(n[:, :, None] * req_i[:, None, :]).to(
            torch.float32)
        placed[:, k] = torch.where(real, _wrap32(n.sum(-1)), m).to(
            torch.int32)
    used = (loads > 0).any(-1).sum(-1).to(torch.int32)
    touched = (loads[0] > 0).any(-1) if per_bin else None
    return used, placed, (loads if want_loads else None), touched


def binpack_counts(reqs, counts, caps, order, n_bins: int, per_bin: bool,
                   want_loads: bool = False):
    """binpack_counts_plain's contract: CUDA tensors launch K8, CPU tensors
    take the plain twin."""
    if reqs.is_cuda:
        return kernels.binpack_counts(reqs, counts, caps, order, n_bins,
                                      per_bin, want_loads)
    return binpack_counts_plain(reqs, counts, caps, order, n_bins, per_bin,
                                want_loads)


def binpack_ffd_counts(class_reqs, counts, capacity, max_bins: int = 1024,
                       order=None):
    """The reference's binpack_ffd_counts: pack counts[c] pods of each
    class class_reqs f32[C, R] into bins of `capacity` (f32[R]: max_bins
    uniform bins; f32[N, R]: one bin a row, max_bins ignored), classes in
    `order` i32[C] (default: their own order).  Returns (n_bins i32[],
    loads f32[bins, R], placed_counts i32[C] in scan positions)."""
    per_bin = capacity.dim() == 2
    nb = capacity.shape[0] if per_bin else int(max_bins)
    C = class_reqs.shape[0]
    if order is None:
        order = torch.arange(C, dtype=torch.int32, device=class_reqs.device)
    used, placed, loads, _ = binpack_counts(
        class_reqs, counts.to(torch.int32),
        capacity if per_bin else capacity[None, :],
        order.to(torch.int32)[None, :], nb, per_bin, want_loads=True)
    return used[0], loads[0], placed[0]


# ---------------------------------------------------- what-if sweeps


def binpack_shapes(pod_reqs, capacities, max_bins: int = 1024):
    """The per-pod what-if over candidate shapes capacities f32[S, R] ->
    (bins_needed i32[S], all_placed bool[S]): each lane's FFD order (K9 on
    CUDA tensors), then the per-pod first-fit (K4) in that order, one lane
    at a time."""
    orders = ffd_order_batch(pod_reqs, capacities)
    bins, ok = [], []
    for s in range(capacities.shape[0]):
        used, _, placed = binpack_ffd(pod_reqs, capacities[s], max_bins,
                                      orders[s])
        bins.append(used.to(torch.int32))
        ok.append(placed.all())
    return torch.stack(bins), torch.stack(ok)


def binpack_shapes_compressed(class_reqs, counts, capacities,
                              max_bins: int = 1024):
    """The class-compressed what-if: classes f32[C, R] with counts i32[C]
    over candidate shapes f32[S, R] -> (bins_needed i32[S], all_placed
    bool[S]): each lane's FFD order of the classes (K9), then the count
    scan of every lane in one call (K8).  all_placed compares the int32
    sums, as the reference does."""
    counts = counts.to(torch.int32)
    order = ffd_order_batch(class_reqs, capacities)
    used, placed, _, _ = binpack_counts(class_reqs, counts, capacities,
                                        order, int(max_bins), False)
    total = _wrap32(counts.to(torch.int64).sum())
    ok = _wrap32(placed.to(torch.int64).sum(-1)) == total
    return used, ok


def compress_classes(pod_reqs: np.ndarray, pad_to_pow2: bool = False,
                     weights=None):
    """Dedupe a backlog's request matrix [P, R] into (class_reqs f32[C, R],
    counts i32[C]) in np.unique's lexicographic order; all-zero rows are
    dropped.  pad_to_pow2 pads the class axis with zero rows and zero
    counts to a power of two.  `weights` i[P] counts row p as weights[p]
    pods (equal rows merge, weights sum).  A host function: the
    reference's, unchanged."""
    reqs = np.ascontiguousarray(np.asarray(pod_reqs, np.float32))
    real = np.any(reqs > 0, axis=-1)
    if weights is None:
        classes, counts = np.unique(reqs[real], axis=0, return_counts=True)
    else:
        w = np.asarray(weights)[real]
        classes, inverse = np.unique(reqs[real], axis=0, return_inverse=True)
        counts = (
            np.bincount(inverse, weights=w).astype(np.int64)
            if classes.size else np.zeros(0, np.int64)
        )
    if classes.size == 0:
        classes = np.zeros((1, reqs.shape[1]), np.float32)
        counts = np.zeros(1, np.int64)
    if pad_to_pow2:
        c = 1
        while c < classes.shape[0]:
            c *= 2
        if c != classes.shape[0]:
            classes = np.concatenate(
                [classes, np.zeros((c - classes.shape[0], classes.shape[1]),
                                   np.float32)])
            counts = np.concatenate(
                [counts, np.zeros(c - counts.shape[0], np.int64)])
    return classes.astype(np.float32), counts.astype(np.int32)


def int_exact(*arrays) -> bool:
    """True when every value is a non-negative integer below
    INT_EXACT_LIMIT: the count scan's exactness domain."""
    for a in arrays:
        a = np.asarray(a)
        if a.size and (
            float(a.min()) < 0.0
            or float(a.max()) >= INT_EXACT_LIMIT
            or not np.array_equal(a, np.floor(a))
        ):
            return False
    return True


def what_if(pod_reqs: np.ndarray, shapes: np.ndarray, max_bins: int = 1024,
            compress: bool = True, device="cuda"):
    """The autoscaler's entry: pending pod requests [P, R] x candidate
    shapes [S, R] -> [(shape index, nodes needed)] for the shapes that fit
    every pod.  compress=True dedupes the backlog into classes and runs
    the count scan (one K9 and one K8 launch on the card) when the inputs
    lie in its integer-exact domain; other inputs, and compress=False,
    take the per-pod sweep."""
    dev = torch.device(device)
    shapes_t = torch.from_numpy(np.ascontiguousarray(
        shapes, np.float32)).to(dev)
    if compress and int_exact(pod_reqs, shapes):
        classes, counts = compress_classes(pod_reqs, pad_to_pow2=True)
        bins, ok = binpack_shapes_compressed(
            torch.from_numpy(classes).to(dev),
            torch.from_numpy(counts).to(dev), shapes_t, max_bins=max_bins)
    else:
        bins, ok = binpack_shapes(
            torch.from_numpy(np.ascontiguousarray(
                pod_reqs, np.float32)).to(dev), shapes_t, max_bins=max_bins)
    bins = bins.cpu().numpy()
    ok = ok.cpu().numpy()
    return [(int(s), int(bins[s])) for s in range(shapes.shape[0]) if ok[s]]
