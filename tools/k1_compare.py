"""Time kernel K1's variants, or K1 against another K1 source, in one process.

    python3 tools/k1_compare.py [--variants block_vec4,warp_vec4]
        [--against OLD.cu] [--shapes 2048x6144,1x6144] [--reps 50]
        [--out RESULT.json]

For each shape [B, N] (rows from kubernetes_tpu_torch/kernels/k1_cases.py)
every kernel in the list is first held against K1's plain twin, bit for bit,
on four rotation counters, and then timed with L2 cold and warm
(kernels/k1_bench.py) in turns: the list, then the list reversed, so each
kernel has two samples and drift between them shows.

The list is K1 as the wrapper picks its variant (`this`), or with
--variants the named entries of kernels.K1_VARIANTS, each launched as that
variant whatever the wrapper would pick; with --against, also another K1
source, built here with nvcc.  That source must export the entry point of
K1's first version,

    int select_hosts_launch(const float* scores, const uint8_t* mask,
                            int rows, int n, int li0, int32_t* hosts,
                            uint8_t* feasible, cudaStream_t stream)

as `git show 51b3542:kubernetes_tpu_torch/kernels/select_hosts.cu` does.
At B = 1 the record also holds an empty launch's time.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kubernetes_tpu_torch import kernels  # noqa: E402
from kubernetes_tpu_torch.kernels import _build, k1_bench, k1_cases  # noqa: E402
from kubernetes_tpu_torch.ops.select import select_hosts_batch_plain  # noqa: E402

COUNTERS = (0, 11, 2**31 - 1, -3)


def build_other(src: str) -> ctypes.CDLL:
    """nvcc another K1 source (the first version's entry point) into a
    shared library in the port's build directory, and open it."""
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, "k1_other.so")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.CUDA_FLAGS,
                    "-shared", "-Xcompiler", "-fPIC", "-o", out, src],
                   check=True)
    lib = ctypes.CDLL(out)
    lib.select_hosts_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.select_hosts_launch.restype = ctypes.c_int
    return lib


def launcher(lib, variant):
    """A select function that calls lib's select_hosts_launch directly:
    with this variant code, or (variant None) with the first version's
    arguments.  Counts nothing."""
    def select(scores, mask, li0):
        B, N = scores.shape
        hosts = torch.empty(B, dtype=torch.int32, device=scores.device)
        feasible = torch.empty(B, dtype=torch.bool, device=scores.device)
        args = [scores.data_ptr(), mask.data_ptr(), B, N,
                kernels.wrap_i32(li0), hosts.data_ptr(), feasible.data_ptr()]
        if variant is not None:
            args.append(variant)
        err = lib.select_hosts_launch(
            *args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"select_hosts_launch refused: error {err}")
        return hosts, feasible
    return select


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", help="comma-separated K1_VARIANTS names")
    ap.add_argument("--against", help="another K1 source to time as well")
    ap.add_argument("--shapes", default="2048x6144,1x6144")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k1_compare needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if args.variants:
        lib = _build.library()
        fns = {v: launcher(lib, kernels.K1_VARIANTS.index(v))
               for v in args.variants.split(",")}
    else:
        fns = {"this": kernels.select_hosts}
    if args.against:
        fns["other"] = launcher(build_other(args.against), None)
    rows = []
    for shape in args.shapes.split(","):
        B, N = (int(x) for x in shape.split("x"))
        s, m = (torch.from_numpy(a).cuda() for a in k1_cases.rows(B, N))
        for name, fn in fns.items():
            for li in COUNTERS:
                hk, fk = fn(s, m, li)
                hp, fp = select_hosts_batch_plain(s, m, li)
                if not (torch.equal(hk, hp) and torch.equal(fk, fp)):
                    raise SystemExit(f"{name} differs from the twin at "
                                     f"[{B},{N}] li {li}")
        row = {"shape": [B, N], "bound_ms": k1_bench.bound_ms(B, N)}
        order = list(fns) + list(reversed(fns))
        for cold in (True, False):
            key = "cold" if cold else "warm"
            for name in order:
                row.setdefault(f"{name}_ms_{key}", []).append(k1_bench.time_ms(
                    lambda: fns[name](s, m, 11), args.reps, cold))
        if B == 1:
            row["empty_launch_ms"] = k1_bench.time_ms(
                kernels.noop_launch, args.reps, False)
        rows.append(row)
        print(f"[k1_compare] {json.dumps(row)}", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "kernels": list(fns), "against": args.against,
              "reps": args.reps, "rows": rows}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(smi)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
