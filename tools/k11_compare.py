"""Time kernel K11 (filter_pass) against the parent commit's K11, in one process.

    python3 tools/k11_compare.py --fetch REV      # where git is: copies
        REV's filter_pass.cu and the headers it includes into .k11_parent/
    python3 tools/k11_compare.py [--reps 20] [--phases] [--rows]
        [--parent-rows]
        [--threads 64,128] [--per-thread 1,2] [--tiles 16,32]
        [--out RESULT.json]                      # on the card

The second form builds both sources with nvcc into shared libraries of
their own (`-Xptxas -v` printed for each): the port's
kernels/filter_pass.cu and the copy in .k11_parent/.  On six full-width
shapes of chip_smoke.py (the bench fleet, 6,144 node rows: its plain
2,048-pod batch in mask mode, the engines' route; the pod-anti-affinity
batch in mask mode, its pair terms gathered; one plain pod in stack mode,
the sidecar's route; phase 13's and phase 13b's preemptors in candidates
mode, on the preemption fleet with its 20,500 running pods; and, not
among the aims, the pod-affinity batch in mask mode, whose every pod has a
required affinity term whose rows the kernel scans), each library's
launch is held against K11's plain twin (ops/predicates.py
filter_batch_plain / predicate_stack_plain, models/preemption.py
preempt_eval_plain) bit for bit and then timed (kernels/k1_bench.py, L2
cold and warm) in turns: this, parent, parent, this, so each has two
samples and drift between them shows.  The parent is driven through its
own struct (ParentArgs here, the fields of K11 before the path), the port
through kernels.filter_pass_prepare.

--threads, --per-thread and --tiles time the port's source at each
other path (threads a block, nodes a thread, pods a tile, set on the
arguments kernels.filter_pass_prepare made: repath), each held to the
twin after it is timed.  --phases builds the port's
source with -DK11_PHASE_CLOCKS and prints where a launch's time goes:
thread 0's SM clocks in every block between the kernel's phase marks, as
shares and as microseconds of the cold launch.  --rows (--parent-rows)
splits the port's (the parent's) launch by predicate: its cold time with
each enabled row alone (`enabled` one bit) and with none (the prologues,
the grid and the writes).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kcompare  # noqa: E402

KDIR = kcompare.KDIR
PARENT_DIR = os.path.join(ROOT, ".k11_parent")
SOURCE = "filter_pass.cu"
NUM_PREDICATES = 23


def fetch(rev: str) -> None:
    """REV's filter_pass.cu and every header it includes, into PARENT_DIR."""
    kcompare.fetch(rev, SOURCE, PARENT_DIR)


@functools.lru_cache(maxsize=None)
def parent_args_class():
    """The parent's FilterPassArgs: the _K11_ARGS pointers, its other
    pointers, then its sizes and flags (no path)."""
    from kubernetes_tpu_torch.kernels import _K11_ARGS

    class ParentArgs(ctypes.Structure):
        _fields_ = ([(spec[0], ctypes.c_void_p) for spec in _K11_ARGS]
                    + [(name, ctypes.c_void_p) for name in (
                        "forbidden_pairs", "anti_term_pairs",
                        "vol_zone_pairs", "vol_bind_pairs", "node_pair",
                        "aff_slot", "max_vols", "presence_keys",
                        "svc_labels", "out")]
                    + [(name, ctypes.c_int) for name in (
                        "b", "n", "r", "l", "t", "p", "q", "tt", "ns", "s",
                        "e", "v", "vt", "dv", "dvn", "sa", "at", "pt", "vz",
                        "vb", "tp", "kt", "aff_on", "vz_on", "vb_on",
                        "n_presence", "presence_present", "n_svc",
                        "unsched_key", "enabled", "unresolvable",
                        "stack_mode", "vec")])

    return ParentArgs


def load(path: str, parent: bool, phases: bool = False):
    from kubernetes_tpu_torch.kernels import FilterPassArgs

    p, i = ctypes.c_void_p, ctypes.c_int
    args = parent_args_class() if parent else FilterPassArgs
    sig = {"filter_pass_launch": ([args, p], i)}
    if phases:
        sig.update(filter_pass_phase_names=([], ctypes.c_char_p),
                   filter_pass_phase_reset=([], i),
                   filter_pass_phase_clocks=([p], i))
    return kcompare.load(path, sig)


def shapes():
    """(label, ct, pb, cfg, key, mode, unresolvable, the twin's output) of
    the six shapes."""
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import FilterConfig
    from kubernetes_tpu_torch.models import preemption as pp
    from kubernetes_tpu_torch.ops import predicates as tp

    bench = cs._bench_batches()
    cfg = FilterConfig()
    out = []
    for label, batch in (("b2048-mask", 2048),
                         ("anti-mask", "pod-anti-affinity")):
        ct, pb, key, _ = bench[batch]
        out.append((label, ct, pb, cfg, key, kernels.K11_MASK, 0,
                    tp.filter_batch_plain(ct, pb, cfg, key,
                                          need_per=False)[0]))
    ct, pb, key, _ = bench[1]
    out.append(("b1-stack", ct, pb, cfg, key, kernels.K11_STACK, 0,
                tp.predicate_stack_plain(ct, pb, cfg, key)))
    for name, (ct, pb, key) in cs._preempt_batches().items():
        out.append((f"candidates-13{'b' * (name != 'plain')}", ct, pb, cfg,
                    key, kernels.K11_CANDIDATES, pp.UNRESOLVABLE_MASK,
                    pp.preempt_eval_plain(ct, pb, cfg, key)))
    ct, pb, key, _ = bench["pod-affinity"]
    out.append(("affinity-mask", ct, pb, cfg, key, kernels.K11_MASK, 0,
                tp.filter_batch_plain(ct, pb, cfg, key, need_per=False)[0]))
    torch.cuda.synchronize()
    return out


def repath(a, B: int, N: int, threads=None, per_thread=None, tile=None):
    """Put another path on the port's prepared arguments `a`: its threads a
    block, nodes a thread or pods a tile where given (the tile no more
    than B, halved while its affinity flags pass K11_SMEM_BUDGET, as
    kernels.filter_pass_paths halves it); a.path follows.  The kernel
    refuses a path it does not take."""
    from kubernetes_tpu_torch import kernels

    p = a.path
    T, k = threads or p.threads, per_thread or p.per_thread
    P = min(tile or p.tile, B)
    flags = p.smem // p.tile
    while P > 1 and P * flags > kernels.K11_SMEM_BUDGET:
        P //= 2
    S = T * k
    a.path = kernels.FilterPassPath(T, k, S, P, -(-N // S), -(-B // P),
                                    P * flags)
    a.threads, a.per_thread, a.tile, a.slice = T, k, P, S


def prepared(lib, parent: bool, shape, enabled=None, **path):
    """One launch of `lib` on a fresh output: (launch(), out); `path`:
    repath's overrides."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops import predicates as tp

    label, ct, pb, cfg, key, mode, unres, _ = shape
    node_pair, aff_slot = tp.pair_inputs(ct, pb)
    a, keep, out = kernels.filter_pass_prepare(ct, pb, cfg, key, node_pair,
                                               aff_slot, mode, unres)
    if path:
        repath(a, pb.n_pods, ct.n_nodes, **path)
    if parent:
        pa = parent_args_class()()
        for name, _ in pa._fields_:
            if hasattr(a, name):
                setattr(pa, name, getattr(a, name))
        # the parent's uchar4 stores where N and the output allow them
        pa.vec = int(ct.n_nodes % 4 == 0 and out.data_ptr() % 4 == 0)
        a = pa
    if enabled is not None:
        a.enabled = enabled

    def launch():
        err = lib.filter_pass_launch(a, torch.cuda.current_stream()
                                     .cuda_stream)
        if err:
            raise RuntimeError(f"{'parent ' * parent}filter_pass launch "
                               f"failed on {label}: cudaError {err}")
        return keep

    launch.args = a
    return launch, out


def checked(launch, out, want, what: str) -> None:
    import torch

    launch()
    torch.cuda.synchronize()
    if not kcompare.same(out, want):
        sys.exit(f"k11_compare: {what} differs from the twin")


def phase_split(lib, shape, ms: float) -> dict:
    """One launch of the instrumented build: each phase's share of thread
    0's clocks summed over the blocks, and its microseconds of the cold
    launch."""
    import numpy as np

    launch, out = prepared(lib, False, shape)
    names = lib.filter_pass_phase_names().decode().split(",")
    if lib.filter_pass_phase_reset():
        sys.exit("k11_compare: phase clocks not reset")
    checked(launch, out, shape[-1], f"the instrumented build on {shape[0]}")
    clocks = np.zeros(len(names), np.uint64)
    if lib.filter_pass_phase_clocks(clocks.ctypes.data):
        sys.exit("k11_compare: phase clocks unread")
    share = clocks.astype(float) / max(float(clocks.sum()), 1.0)
    split = {name: {"share": float(share[i]),
                    "us": float(share[i] * ms * 1e3)}
             for i, name in enumerate(names)}
    print(f"[phases {shape[0]}] " + " | ".join(
        f"{name} {d['us']:.3f} us ({100 * d['share']:.1f}%)"
        for name, d in split.items()), flush=True)
    return split


def row_split(lib, parent: bool, shape, reps: int) -> dict:
    """A launch split by predicate: cold ms with each enabled row alone
    and with none."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import PREDICATE_ORDER
    from kubernetes_tpu_torch.kernels import k1_bench

    enabled = kernels._filter_config(shape[3], shape[1].vol_counts.shape[1])[0]
    out = {}
    for k in [None] + [k for k in range(NUM_PREDICATES) if enabled >> k & 1]:
        launch, _ = prepared(lib, parent, shape, 0 if k is None else 1 << k)
        out["none" if k is None else PREDICATE_ORDER[k]] = k1_bench.time_ms(
            launch, reps=reps)
    print(f"[{'parent' if parent else 'this'} rows {shape[0]}] cold ms, one "
          f"row alone: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--threads", default="")
    ap.add_argument("--per-thread", default="")
    ap.add_argument("--tiles", default="")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--rows", action="store_true")
    ap.add_argument("--parent-rows", action="store_true")
    ap.add_argument("--out")
    opt = ap.parse_args()
    if opt.fetch:
        fetch(opt.fetch)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("k11_compare: no CUDA card")
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench

    t0 = time.monotonic()
    if not os.path.exists(os.path.join(PARENT_DIR, SOURCE)):
        sys.exit(f"k11_compare: no {PARENT_DIR}/{SOURCE}; run --fetch REV "
                 "where git is")
    sweeps = {name: [int(x) for x in getattr(opt, attr).split(",") if x]
              for name, attr in (("threads", "threads"),
                                 ("per_thread", "per_thread"),
                                 ("tile", "tiles"))}
    port = os.path.join(KDIR, SOURCE)
    builds = [("this", port, KDIR, False, ())]
    if opt.phases:
        builds.append(("phases", port, KDIR, False, ("-DK11_PHASE_CLOCKS",)))
    builds.append(("parent", os.path.join(PARENT_DIR, SOURCE), PARENT_DIR,
                   True, ()))
    libs = {}
    for name, src, inc, parent, defines in builds:
        so = kcompare.build(f"k11_{name}", src, inc, defines, "k11_")
        libs[name] = (load(so, parent, name == "phases"), parent)
    smi = kcompare.card()
    print(f"[card] {smi}", flush=True)
    result = {"card": smi, "shapes": {}}
    order = ("this", "parent", "parent", "this")
    for shape in shapes():
        label, ct, pb = shape[:3]
        want = shape[-1]
        row = {"B": pb.n_pods, "N": ct.n_nodes,
               "TP": int(ct.topo_pairs.shape[1]),
               "mode": ("mask", "stack", "candidates")[shape[5]]}
        runs = {}
        for name in dict.fromkeys(order):
            lib, parent = libs[name]
            launch, out = prepared(lib, parent, shape)
            checked(launch, out, want, f"{name} on {label}")
            runs[name] = launch
        for name in order:
            for cold in (True, False):
                ms = k1_bench.time_ms(runs[name], reps=opt.reps, cold=cold)
                row.setdefault(f"{name}_{'cold' if cold else 'warm'}",
                               []).append(ms)
        path = getattr(runs["this"].args, "path", None)
        if path is not None:
            row["path"] = path._asdict()
        for field, values in sweeps.items():
            for v in values:
                launch, out = prepared(libs["this"][0], False, shape,
                                       **{field: v})
                key = f"{field}{v}"
                row[key + "_cold"] = k1_bench.time_ms(launch, reps=opt.reps)
                checked(launch, out, want, f"{key} on {label}")
                row[key + "_path"] = launch.args.path._asdict()
        if opt.phases:
            row["phases"] = phase_split(libs["phases"][0], shape,
                                        min(row["this_cold"]))
        if opt.rows:
            row["rows"] = row_split(libs["this"][0], False, shape, opt.reps)
        if opt.parent_rows:
            row["parent_rows"] = row_split(libs["parent"][0], True, shape,
                                           opt.reps)
        row["speedup_cold"] = min(row["parent_cold"]) / min(row["this_cold"])
        result["shapes"][label] = row
        print(f"[K11 {label}] B {row['B']} N {row['N']} TP {row['TP']} "
              f"{row['mode']}: both equal the twin | " + " | ".join(
                  f"{k} {v}" for k, v in row.items()
                  if k.endswith(("_cold", "_warm")) or k == "speedup_cold")
              + (f" | path {row['path']}" if "path" in row else ""),
              flush=True)
    result["seconds"] = time.monotonic() - t0
    if opt.out:
        os.makedirs(os.path.dirname(os.path.abspath(opt.out)), exist_ok=True)
        with open(opt.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if "cold" in kk or "warm" in kk}
                      for k, v in result["shapes"].items()}))


if __name__ == "__main__":
    main()
