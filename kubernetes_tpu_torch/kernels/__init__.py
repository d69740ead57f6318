"""Hand-written CUDA kernels of the port, and their launch wrappers.

K1 `select_hosts` (select_hosts.cu) replaces the JAX package's
ops/select.py select_host / select_hosts_batch.  Its plain PyTorch twin is
ops/select.py `select_hosts_batch_plain`; ops/select.py dispatches to the
kernel for CUDA tensors.

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch,
nowhere else), so a run can show that its main path went through the
kernels; `select_hosts_b1` also counts K1's one-row launches (the
sequential engine's steps) on their own.  The kernels are built from source at the first launch
(kernels/_build.py); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import torch

LAUNCHES = {"select_hosts": 0, "select_hosts_b1": 0}

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
