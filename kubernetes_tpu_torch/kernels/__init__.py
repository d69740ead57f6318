"""Hand-written CUDA kernels of the port, and their launch wrappers.

K1 `select_hosts` (select_hosts.cu) replaces the JAX package's
ops/select.py select_host / select_hosts_batch.  Its plain PyTorch twin is
ops/select.py `select_hosts_batch_plain`; ops/select.py dispatches to the
kernel for CUDA tensors.

Each wrapper counts its launches in `LAUNCHES` (one per kernel launch,
nowhere else), so a run can show that its main path went through the
kernels.  The kernels are built from source at the first launch
(kernels/_build.py); importing this module needs neither nvcc nor a card.
"""

from __future__ import annotations

import torch

LAUNCHES = {"select_hosts": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def wrap_i32(x: int) -> int:
    """A Python int reduced to the int32 value two's-complement arithmetic
    gives (the reference's rotation counters are int32 and wrap)."""
    return ((int(x) + (1 << 31)) % (1 << 32)) - (1 << 31)


def select_hosts(scores: torch.Tensor, mask: torch.Tensor,
                 last_index0: int):
    """K1: (scores f32[B, N], mask bool[B, N], last_index0 int) ->
    (hosts i32[B], feasible bool[B]) on the tensors' CUDA device; row b
    rotates its tie-break by last_index0 + b.  Raises on anything the
    kernel does not take and on a refused launch."""
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
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.select_hosts_launch(
            scores.data_ptr(), mask.data_ptr(), B, N, wrap_i32(last_index0),
            hosts.data_ptr(), feasible.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("select_hosts launch failed: "
                           + lib.select_hosts_error_string(err).decode())
    if B:
        LAUNCHES["select_hosts"] += 1
    return hosts, feasible
