"""Time kernel K2 (preempt_one) against another K2 source, in one process.

    python3 tools/k2_compare.py [--against OLD.cu] [--reps 50]
        [--out RESULT.json]

Prints `nvcc -Xptxas -v` for the port's K2 source and, with --against, for
the other source, which it builds with nvcc into a shared library of its
own.  Every kernel is then held against K2's plain twin
(models/preemption.py preempt_one_plain) on every case of
kubernetes_tpu_torch/kernels/k2_cases.py, all four outputs equal, and timed
at the full-width case with L2 cold and warm (kernels/k1_bench.py) in turns:
this, other, other, this, so each has two samples and drift between them
shows.  Beside them: an empty launch's time (the launch floor of one stream
operation), each kernel's stream operations in one call (kernel launches,
memsets and copies, counted by torch.profiler) and K2's bytes bound.

The other source must export the entry point of K2's first version,

    int preempt_one_launch(<15 input pointers>, int n, int e, int m_total,
                           int n_slots, int vmax, int n_vids, int vt,
                           int* workspace, int32_t* node_out,
                           uint8_t* victim_mask, int32_t* n_victims_out,
                           int32_t* n_viol_out, cudaStream_t stream)

with a workspace of int32[8 * n + n_slots + n_vids], as `git show
be79edc:kubernetes_tpu_torch/kernels/preempt_one.cu` does.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kubernetes_tpu_torch import kernels  # noqa: E402
from kubernetes_tpu_torch.kernels import (  # noqa: E402
    _build,
    k1_bench,
    k2_cases,
)
from kubernetes_tpu_torch.models.preemption import (  # noqa: E402
    preempt_one_plain,
)

THIS_SRC = os.path.join(ROOT, "kubernetes_tpu_torch", "kernels",
                        "preempt_one.cu")


def nvcc(src: str, out: str) -> str:
    """Compile src into the shared library out with -Xptxas -v; the
    compiler's report."""
    from torch.utils.cpp_extension import CUDA_HOME

    os.makedirs(os.path.dirname(out), exist_ok=True)
    res = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "nvcc"), *_build.CUDA_FLAGS,
         "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC", "-o", out, src],
        capture_output=True, text=True, check=True)
    return (res.stdout + res.stderr).strip()


def build_other(src: str):
    """The other K2 source as a library, and nvcc's report."""
    out = os.path.join(_build.BUILD_DIR, "k2_other.so")
    report = nvcc(src, out)
    lib = ctypes.CDLL(out)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.preempt_one_launch.argtypes = [p] * 15 + [i] * 7 + [p] * 6
    lib.preempt_one_launch.restype = ctypes.c_int
    return lib, report


def first_version(lib):
    """A preempt_one function that calls lib's first-version entry point
    directly.  Counts nothing."""
    def pick(*a):
        N, E = a[0].shape
        M, K = a[4].shape[0], a[9].shape[0]
        VM, V, VT = a[10].shape[1], a[11].shape[0], a[14].shape[1]
        dev = a[0].device
        ws = torch.empty(8 * N + K + V, dtype=torch.int32, device=dev)
        node = torch.empty((), dtype=torch.int32, device=dev)
        mask = torch.empty(M, dtype=torch.bool, device=dev)
        n_vic = torch.empty((), dtype=torch.int32, device=dev)
        n_viol = torch.empty((), dtype=torch.int32, device=dev)
        err = lib.preempt_one_launch(
            *(t.data_ptr() for t in a), N, E, M, K, VM, V, VT, ws.data_ptr(),
            node.data_ptr(), mask.data_ptr(), n_vic.data_ptr(),
            n_viol.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"preempt_one_launch refused: error {err}")
        return node, mask, n_vic, n_viol
    return pick


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", help="another K2 source to time as well")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", help="also write the record to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_compare needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    reports = {"this": nvcc(THIS_SRC, os.path.join(_build.BUILD_DIR,
                                                   "k2_this_ptxas.so"))}
    fns = {"this": kernels.preempt_one}
    if args.against:
        lib, reports["other"] = build_other(args.against)
        fns["other"] = first_version(lib)
    for name, rep in reports.items():
        print(f"[k2_compare] nvcc -Xptxas -v, {name}:\n{rep}", flush=True)
    dev = torch.device("cuda")
    picks = {}
    for case, c in k2_cases.cases():
        a = [torch.from_numpy(np.ascontiguousarray(c[k])).to(dev)
             for k in k2_cases.ARGS]
        want = preempt_one_plain(*a[:10], tuple(a[10:]))
        for name, fn in fns.items():
            got = fn(*a)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("node", "victim_mask",
                                              "n_victims",
                                              "n_pdb_violations")):
                if not torch.equal(g, w):
                    raise SystemExit(
                        f"{name}: {what} differs from the twin on case "
                        f"{case}: kernel {g.cpu().reshape(-1)[:8].tolist()} "
                        f"twin {w.cpu().reshape(-1)[:8].tolist()}")
        picks[case] = [int(want[0]), int(want[2])]
    print(f"[k2_compare] {list(fns)} equal to the twin on {len(picks)} "
          f"cases (case: [node, victims]) {picks}", flush=True)
    # a is the last case, full-width
    row = {"shape": {"N": int(a[0].shape[0]), "E": int(a[0].shape[1]),
                     "M": int(a[4].shape[0]), "Kv": int(a[9].shape[0])},
           "bound_ms": k1_bench.k2_bound_ms(a),
           "empty_launch_ms": k1_bench.time_ms(kernels.noop_launch,
                                               args.reps, False)}
    order = list(fns) + list(reversed(fns))
    for cold in (True, False):
        key = "cold" if cold else "warm"
        for name in order:
            row.setdefault(f"{name}_ms_{key}", []).append(k1_bench.time_ms(
                lambda: fns[name](*a), args.reps, cold))
    for name, fn in fns.items():
        ops = k1_bench.stream_ops(lambda: fn(*a))
        row[f"{name}_stream_ops"] = sum(ops.values())
        row[f"{name}_device_ops"] = ops
        row[f"{name}_launch_floor_ms"] = (row["empty_launch_ms"]
                                          * sum(ops.values()))
    print(f"[k2_compare] {json.dumps(row)}", flush=True)
    record = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "kernels": list(fns), "against": args.against,
              "reps": args.reps, "ptxas": reports, "row": row,
              "picks": picks}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(smi)
    print(json.dumps({k: v for k, v in record.items() if k != "ptxas"}))


if __name__ == "__main__":
    main()
