"""Build the port's CUDA kernels from the sources in this directory.

`library()` compiles every `.cu` file here with nvcc for sm_90a through
`torch.utils.cpp_extension.load`, into `<repo>/.torch_ext_build/`, at the
first call (the caller is a wrapper about to launch on a CUDA tensor), and
returns the shared library opened with ctypes.  The sources expose plain C
entry points and include no PyTorch headers, so the build takes seconds.
A failed build raises; nothing falls back to a plain version.

`BUILD_STATS` records what library() did in this process: "builds" (the
library compiled here), "loads" (a library an earlier process built under
the same sources was opened) and the seconds they took; the telemetry
hub reports them (runtime/telemetry.py compile_stats).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         ".torch_ext_build")
NAME = "kubernetes_tpu_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
BUILD_STATS = {"builds": 0, "loads": 0, "seconds": 0.0}
# binpack_counts_launch's (argtypes, restype): the sizes, the launch shape
# (block, grid), then the workspace, the outputs and the stream
BINPACK_COUNTS_SIGNATURE = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7, ctypes.c_int)


def sources() -> list:
    return sorted(glob.glob(os.path.join(_HERE, "*.cu"))
                  + glob.glob(os.path.join(_HERE, "*.cpp")))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per process) and open the kernel library."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    built = os.path.join(BUILD_DIR, NAME + ".so")
    fresh = os.path.exists(built) and os.path.getmtime(built) >= max(
        os.path.getmtime(s) for s in sources())
    t0 = time.perf_counter()
    path = load(
        name=NAME,
        sources=sources(),
        extra_cuda_cflags=CUDA_FLAGS,
        build_directory=BUILD_DIR,
        is_python_module=False,
        verbose=False,
    )
    BUILD_STATS["loads" if fresh else "builds"] += 1
    BUILD_STATS["seconds"] += time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.select_hosts_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.select_hosts_launch.restype = ctypes.c_int
    lib.select_hosts_noop_launch.argtypes = [ctypes.c_void_p]
    lib.select_hosts_noop_launch.restype = ctypes.c_int
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.preempt_one_launch.argtypes = [p] * 15 + [i] * 7 + [p] * 7
    lib.preempt_one_launch.restype = ctypes.c_int
    lib.preempt_one_workspace_ints.argtypes = [i] * 4
    lib.preempt_one_workspace_ints.restype = ctypes.c_int
    lib.select_topk_launch.argtypes = [p] * 4 + [i] * 3 + [p] * 4
    lib.select_topk_launch.restype = ctypes.c_int
    lib.select_topk_smem_max_n.argtypes = []
    lib.select_topk_smem_max_n.restype = ctypes.c_int
    lib.binpack_ffd_launch.argtypes = [p, i, i, p, i, p, i] + [p] * 5
    lib.binpack_ffd_launch.restype = ctypes.c_int
    lib.binpack_ffd_smem_bytes.argtypes = [i, i]
    lib.binpack_ffd_smem_bytes.restype = ctypes.c_int
    lib.binpack_ffd_floor_launch.argtypes = [i, p]
    lib.binpack_ffd_floor_launch.restype = ctypes.c_int
    lib.cluster_analytics_launch.argtypes = [p, p, p, i, i, p, p, p]
    lib.cluster_analytics_launch.restype = ctypes.c_int
    lib.cluster_analytics_max_rows.argtypes = []
    lib.cluster_analytics_max_rows.restype = ctypes.c_int
    lib.cluster_analytics_workspace_ints.argtypes = [i]
    lib.cluster_analytics_workspace_ints.restype = ctypes.c_int
    lib.commit_group_counts_launch.argtypes = [p] * 4 + [i] * 4 + [p] * 2
    lib.commit_group_counts_launch.restype = ctypes.c_int
    lib.fold_predicates_launch.argtypes = [p] * 3 + [i] * 4 + [p] * 3
    lib.fold_predicates_launch.restype = ctypes.c_int
    lib.ffd_order_launch.argtypes = [p, i, i, p, i, p, p]
    lib.ffd_order_launch.restype = ctypes.c_int
    lib.binpack_counts_launch.argtypes = BINPACK_COUNTS_SIGNATURE[0]
    lib.binpack_counts_launch.restype = BINPACK_COUNTS_SIGNATURE[1]
    lib.reconcile_admit_launch.argtypes = [p] * 6 + [i, i] + [p] * 4
    lib.reconcile_admit_launch.restype = ctypes.c_int
    lib.reconcile_admit_workspace_floats.argtypes = [i, i]
    lib.reconcile_admit_workspace_floats.restype = ctypes.c_longlong
    from kubernetes_tpu_torch.kernels import FilterPassArgs, ScorePassArgs

    lib.filter_pass_launch.argtypes = [FilterPassArgs, p]
    lib.filter_pass_launch.restype = ctypes.c_int
    lib.node_pair_build_launch.argtypes = [p, p, i, i, i, p, p]
    lib.node_pair_build_launch.restype = ctypes.c_int
    lib.score_pass_launch.argtypes = [ScorePassArgs, p]
    lib.score_pass_launch.restype = ctypes.c_int
    from kubernetes_tpu_torch.kernels import SeqScanArgs

    lib.seq_scan_launch.argtypes = [SeqScanArgs, p]
    lib.seq_scan_launch.restype = ctypes.c_int
    lib.seq_scan_workspace_size.argtypes = [SeqScanArgs]
    lib.seq_scan_workspace_size.restype = ctypes.c_longlong
    lib.seq_scan_paths.argtypes = [i] * 8
    lib.seq_scan_paths.restype = ctypes.c_int
    from kubernetes_tpu_torch.kernels import (RoundCommitArgs, RoundFoldArgs,
                                              RoundPairsArgs)

    lib.round_fold_launch.argtypes = [RoundFoldArgs, p]
    lib.round_fold_launch.restype = ctypes.c_int
    lib.round_fold_workspace_bytes.argtypes = [i, i, i, i]
    lib.round_fold_workspace_bytes.restype = ctypes.c_longlong
    lib.round_commit_launch.argtypes = [RoundCommitArgs, p]
    lib.round_commit_launch.restype = ctypes.c_int
    lib.round_pairs_launch.argtypes = [RoundPairsArgs, p]
    lib.round_pairs_launch.restype = ctypes.c_int
    lib.select_hosts_launch_dev.argtypes = [p, p, i, i, p, p, p, i, p]
    lib.select_hosts_launch_dev.restype = ctypes.c_int
    u64 = ctypes.c_uint64
    for name, args in (
            ("graph_versions", [p, p]), ("graph_begin", [p]),
            ("graph_handle", [p, p]), ("graph_init_launch", [u64, p, i, p]),
            ("graph_flag_launch", [u64, p, p, p, i, p, p]),
            ("graph_cond_begin", [p, p, u64, i]), ("graph_cond_end", [p]),
            ("graph_end", [p, p]), ("graph_launch", [p, p]),
            ("graph_destroy", [p]), ("graph_probe", [p, p, p, p]),
            ("graph_abort", [p, p])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    lib.select_hosts_error_string.argtypes = [ctypes.c_int]
    lib.select_hosts_error_string.restype = ctypes.c_char_p
    return lib
