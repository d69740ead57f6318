"""Build the port's CUDA kernels from the sources in this directory.

`library()` compiles every `.cu` file here with nvcc for sm_90a through
`torch.utils.cpp_extension.load`, into `<repo>/.torch_ext_build/`, at the
first call (the caller is a wrapper about to launch on a CUDA tensor), and
returns the shared library opened with ctypes.  The sources expose plain C
entry points and include no PyTorch headers, so the build takes seconds.
A failed build raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import os

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)),
                         ".torch_ext_build")
NAME = "kubernetes_tpu_torch_kernels"
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]


def sources() -> list:
    return sorted(glob.glob(os.path.join(_HERE, "*.cu"))
                  + glob.glob(os.path.join(_HERE, "*.cpp")))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Compile (once per process) and open the kernel library."""
    from torch.utils.cpp_extension import load

    os.makedirs(BUILD_DIR, exist_ok=True)
    path = load(
        name=NAME,
        sources=sources(),
        extra_cuda_cflags=CUDA_FLAGS,
        build_directory=BUILD_DIR,
        is_python_module=False,
        verbose=False,
    )
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
    lib.preempt_one_workspace_ints.argtypes = [i] * 3
    lib.preempt_one_workspace_ints.restype = ctypes.c_int
    lib.select_hosts_error_string.argtypes = [ctypes.c_int]
    lib.select_hosts_error_string.restype = ctypes.c_char_p
    return lib
