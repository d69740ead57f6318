"""Time kernel K12 (score_pass) against the parent commit's K12, in one process.

    python3 tools/k12_compare.py --fetch REV      # where git is: copies
        REV's score_pass.cu and the headers it includes into .k12_parent/
    python3 tools/k12_compare.py [--reps 20] [--clusters 16,8]
        [--tiles 8,16] [--per-thread 1,2,3] [--variants "D=1;D=2"]
        [--phases] [--parent-rows] [--out RESULT.json]   # on the card

The second form builds both sources with nvcc into shared libraries of
their own (`-Xptxas -v` printed for each): the port's
kernels/score_pass.cu and the copy in .k12_parent/.  On phase K12's
full-width batches of chip_smoke.py (the bench fleet, 6,144 node rows:
one pod at the stock weights, the sidecar's; 2,048 pods at the round's
weights, SelectorSpread zeroed for the spread-lean batch, skip_zero_weight;
the 2,048-pod pod-anti-affinity and pod-affinity batches at the stock
weights, their InterPodAffinity sums gathered), the total alone, each
library's launch is held against K12's plain twin (ops/priorities.py
score_batch_plain) bit for bit and then timed (kernels/k1_bench.py, L2
cold and warm) in turns: this, parent, parent, this, so each has two
samples and drift between them shows.  The parent is driven through its
own interface (the zone index's buffer and its three extra arguments, its
shared-memory tile), the port through kernels.score_pass_prepare.

--clusters adds a build of the port's source at each other cluster size
(-DK12_CLUSTER=c); each cluster size is timed at the port's path and,
with --tiles and --per-thread, at each pod tile (on the 2,048-pod
batches) and nodes a thread, each held to the twin after it is timed,
beside the clusters the card holds at once.  --variants builds the
port's source with each set of -D definitions (K12_MIN_BLOCKS=1: the
blocks an SM the compiler plans registers for) and times it at the
port's path.  --phases
builds the port's source with -DK12_PHASE_CLOCKS and prints where a
launch's time goes: the SM clocks of every block between the kernel's
phase marks (pass 1 by priority, the barriers, the folds, pass 2), as
shares and as microseconds of the cold launch.  --parent-rows splits the
parent's launch by priority: its time with each priority's row alone and
with none (the walks, the block reductions and the writes), and its two
kernels' device times (the zone index, the pass) under torch.profiler.
Needs one CUDA card.
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
PARENT_DIR = os.path.join(ROOT, ".k12_parent")
SOURCE = "score_pass.cu"
PARENT_SMEM_MAX = 96 * 1024   # the parent's kSmemMax


def fetch(rev: str) -> None:
    """REV's score_pass.cu and every header it includes, into PARENT_DIR."""
    kcompare.fetch(rev, SOURCE, PARENT_DIR)


@functools.lru_cache(maxsize=None)
def parent_args_class():
    """The parent's ScorePassArgs: the _K12_ARGS pointers, then its own
    (the zone index's buffer first), the weights, its sizes and its
    shared-memory tile."""
    from kubernetes_tpu_torch.kernels import _K12_ARGS

    class ParentArgs(ctypes.Structure):
        _fields_ = ([(spec[0], ctypes.c_void_p) for spec in _K12_ARGS]
                    + [(name, ctypes.c_void_p) for name in (
                        "zone_of_node", "ipa_w", "node_pair", "prefs_key",
                        "prefs_presence", "prefs_weight", "rtc_xs", "rtc_ys",
                        "work", "total", "per")]
                    + [("w", ctypes.c_float * 12)]
                    + [(name, ctypes.c_int) for name in (
                        "b", "n", "r", "l", "t", "tt", "i", "c", "a", "g",
                        "gp", "ps", "e", "v", "tp", "kt", "n_prefs", "n_rtc",
                        "rows", "smem_mode", "region", "na_off", "zs_off")])

    return ParentArgs


def load(path: str, parent: bool, phases: bool = False):
    from kubernetes_tpu_torch.kernels import ScorePassArgs

    p, i = ctypes.c_void_p, ctypes.c_int
    if parent:
        sig = {"score_pass_launch": ([parent_args_class(), p, p, i, p], i)}
    else:
        sig = {"score_pass_launch": ([ScorePassArgs, p], i),
               "score_pass_cluster": ([], i),
               "score_pass_active_clusters": ([ScorePassArgs], i)}
    if phases:
        sig.update(score_pass_phase_names=([], ctypes.c_char_p),
                   score_pass_phase_count=([], i),
                   score_pass_phase_reset=([], i),
                   score_pass_phase_clocks=([p], i))
    return kcompare.load(path, sig)


def batches():
    """(label, ct, pb, weights, skip_zero_weight, zone key, the twin's
    total) of phase K12's four full-width batches."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch.ops.priorities import (DEFAULT_PRIORITY_WEIGHTS,
                                                     score_batch_plain)

    bench = cs._bench_batches()
    stock = np.asarray(DEFAULT_PRIORITY_WEIGHTS, np.float32)
    out = []
    for label, key, skip in (("b1-stock", 1, False),
                             ("b2048-round", 2048, True),
                             ("anti-stock", "pod-anti-affinity", False),
                             ("affinity-stock", "pod-affinity", False)):
        ct, pb, _, zk = bench[key]
        w = cs._round_weights(ct, pb, False) if skip else stock
        want, _ = score_batch_plain(ct, pb, weights=w, zone_key_id=zk,
                                    skip_zero_weight=skip, need_per=False)
        out.append((label, ct, pb, w, skip, zk, want))
    torch.cuda.synchronize()
    return out


def path_of(ct, pb, w, zk, **kw):
    """The ScorePassPath the port's launch takes on this batch."""
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import ScoreConfig
    from kubernetes_tpu_torch.ops.priorities import ipa_gathers

    a, _, _ = kernels.score_pass_prepare(ct, pb, w, False, False,
                                         ScoreConfig(), zk,
                                         ipa_gathers(ct, pb, w, False), **kw)
    return a.path


def prepared(lib, parent: bool, ct, pb, w, skip, zk, tile=None,
             cluster=None, per_thread=None):
    """One launch of `lib` on fresh outputs: (launch(), total)."""
    import torch

    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.codec.schema import ScoreConfig
    from kubernetes_tpu_torch.ops.priorities import ipa_gathers

    kw = {}
    if tile is not None:
        kw["tile"] = tile
    if cluster is not None:
        kw["cluster_size"] = cluster
    if per_thread is not None:
        kw["per_thread"] = per_thread
    a, keep, (total, _) = kernels.score_pass_prepare(
        ct, pb, w, False, False, ScoreConfig(), zk,
        ipa_gathers(ct, pb, w, False), **kw)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    if not parent:
        def launch():
            err = lib.score_pass_launch(a, stream())
            if err:
                raise RuntimeError(f"score_pass launch failed: cudaError "
                                   f"{err}")
            return keep
        launch.args = a
        return launch, total
    pa = parent_args_class()()
    for name, _ in pa._fields_:
        if hasattr(a, name) and name != "w":
            setattr(pa, name, getattr(a, name))
    pa.w = a.w
    N, B, TP = a.n, a.b, a.tp
    na = N if (a.rows >> 5) & 1 and a.ps > 0 else 0
    zs = TP if a.rows & 1 else 0
    pa.region, pa.na_off, pa.zs_off = na + zs, 0, na
    pa.smem_mode = int((na + zs) * 4 <= PARENT_SMEM_MAX)
    zone = torch.empty(N, dtype=torch.int32, device="cuda")
    pa.zone_of_node = zone.data_ptr()
    work = None
    if not pa.smem_mode:
        work = torch.empty(B * (na + zs), dtype=torch.float32, device="cuda")
        pa.work = work.data_ptr()
    topo = ct.topo_pairs.contiguous()
    ptk = ct.pair_topo_key.contiguous()
    keep = keep + [zone, work, topo, ptk]

    def launch():
        err = lib.score_pass_launch(pa, topo.data_ptr(), ptk.data_ptr(),
                                    int(zk), stream())
        if err:
            raise RuntimeError(f"parent score_pass launch failed: "
                               f"cudaError {err}")
        return keep

    return launch, total


same = kcompare.same


def checked(launch, total, want, what: str) -> None:
    import torch

    launch()
    torch.cuda.synchronize()
    if not same(total, want):
        sys.exit(f"k12_compare: {what} differs from the twin")


def phase_split(lib, batch, ms: float) -> dict:
    """One launch of the instrumented build: each phase's share of a
    block's clocks (rank 0's, the mean over ranks, the slowest rank's on
    rank 0's scale), and its microseconds of the cold launch."""
    import numpy as np

    label, ct, pb, w, skip, zk, want = batch
    launch, total = prepared(lib, False, ct, pb, w, skip, zk)
    names = lib.score_pass_phase_names().decode().split(",")
    if lib.score_pass_phase_reset():
        sys.exit("k12_compare: phase clocks not reset")
    checked(launch, total, want, f"the instrumented build on {label}")
    C = lib.score_pass_cluster()
    clocks = np.zeros((C, len(names)), np.uint64)
    if lib.score_pass_phase_clocks(clocks.ctypes.data):
        sys.exit("k12_compare: phase clocks unread")
    clocks = clocks.astype(float)
    share0 = clocks[0] / clocks[0].sum()
    mean = clocks.mean(0) / clocks.mean(0).sum()
    top = clocks.max(0) / clocks[0].sum()
    split = {name: {"share_rank0": float(share0[i]),
                    "share_mean": float(mean[i]),
                    "share_max": float(top[i]),
                    "us": float(share0[i] * ms * 1e3)}
             for i, name in enumerate(names)}
    print(f"[phases {label}] " + " | ".join(
        f"{name} {d['us']:.3f} us ({100 * d['share_rank0']:.1f}%, ranks' "
        f"mean {100 * d['share_mean']:.1f}%, max {100 * d['share_max']:.1f}%)"
        for name, d in split.items() if d["share_mean"] > 0.0005),
        flush=True)
    return split


def parent_rows(lib, batch, reps: int) -> dict:
    """The parent's launch split by priority: cold ms with each active
    row alone and with none, and its kernels' device ms under
    torch.profiler (one warm call)."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubernetes_tpu_torch.codec.schema import PRIO_INDEX
    from kubernetes_tpu_torch.kernels import k1_bench

    label, ct, pb, w, skip, zk, want = batch
    names = {i: n for n, i in PRIO_INDEX.items()}
    out = {}
    for k in [None] + [i for i in range(12) if w[i] != 0.0]:
        wk = np.zeros(12, np.float32)
        if k is not None:
            wk[k] = w[k]
        launch, _ = prepared(lib, True, ct, pb, wk, skip, zk)
        out["none" if k is None else names[k]] = k1_bench.time_ms(
            launch, reps=reps)
    launch, _ = prepared(lib, True, ct, pb, w, skip, zk)
    launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        launch()
        torch.cuda.synchronize()
    kern = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kern[e.name] = kern.get(e.name, 0.0) + e.time_range.elapsed_us()
    out["kernels_us"] = kern
    print(f"[parent rows {label}] cold ms, one row alone: " + ", ".join(
        f"{k} {v:.4f}" for k, v in out.items() if k != "kernels_us")
        + " | device us by kernel: " + ", ".join(
        f"{k} {v:.2f}" for k, v in kern.items()), flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--clusters", default="16")
    ap.add_argument("--tiles", default="")
    ap.add_argument("--per-thread", default="")
    ap.add_argument("--variants", default="",
                    help="builds of the port's source with these -D "
                         "definitions, ';' between builds, timed at the "
                         "port's paths")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--parent-rows", action="store_true")
    ap.add_argument("--out")
    opt = ap.parse_args()
    if opt.fetch:
        fetch(opt.fetch)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("k12_compare: no CUDA card")
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k1_bench

    t0 = time.monotonic()
    if not os.path.exists(os.path.join(PARENT_DIR, SOURCE)):
        sys.exit(f"k12_compare: no {PARENT_DIR}/{SOURCE}; run --fetch REV "
                 "where git is")
    clusters = [int(c) for c in opt.clusters.split(",") if c]
    tiles = [int(t) for t in opt.tiles.split(",") if t]
    per_threads = [int(k) for k in opt.per_thread.split(",") if k] or [None]
    variants = [v for v in opt.variants.split(";") if v]
    port = os.path.join(KDIR, SOURCE)
    builds = [("this", port, KDIR, False, ())]
    builds += [(f"c{c}", port, KDIR, False, (f"-DK12_CLUSTER={c}",))
               for c in clusters if c != kernels.K12_CLUSTER]
    if opt.phases:
        builds.append(("phases", port, KDIR, False, ("-DK12_PHASE_CLOCKS",)))
    builds += [(f"v{i}", port, KDIR, False,
                tuple(f"-D{d}" for d in v.split()))
               for i, v in enumerate(variants)]
    builds.append(("parent", os.path.join(PARENT_DIR, SOURCE), PARENT_DIR,
                   True, ()))
    libs = {}
    for name, src, inc, parent, defines in builds:
        so = kcompare.build(f"k12_{name}", src, inc, defines, "k12_")
        libs[name] = (load(so, parent, name == "phases"), parent)
    smi = kcompare.card()
    print(f"[card] {smi}", flush=True)
    result = {"card": smi, "batches": {}}
    order = ("this", "parent", "parent", "this")
    for batch in batches():
        label, ct, pb, w, skip, zk, want = batch
        row = {"B": pb.n_pods, "N": ct.n_nodes,
               "TP": int(ct.topo_pairs.shape[1])}
        runs = {}
        for name in dict.fromkeys(order):
            lib, parent = libs[name]
            launch, total = prepared(lib, parent, ct, pb, w, skip, zk)
            checked(launch, total, want, f"{name} on {label}")
            runs[name] = launch
        for name in order:
            for cold in (True, False):
                ms = k1_bench.time_ms(runs[name], reps=opt.reps, cold=cold)
                row.setdefault(f"{name}_{'cold' if cold else 'warm'}",
                               []).append(ms)
        row["path"] = path_of(ct, pb, w, zk)._asdict()
        for c in clusters:
            lib = libs["this" if c == kernels.K12_CLUSTER else f"c{c}"][0]
            for t in [None] + (tiles if pb.n_pods > 1 else []):
                for k in per_threads:
                    launch, total = prepared(lib, False, ct, pb, w, skip, zk,
                                             tile=t, cluster=c, per_thread=k)
                    key = (f"c{c}" + (f"_tile{t}" if t else "")
                           + (f"_k{k}" if k else ""))
                    row[key + "_cold"] = k1_bench.time_ms(launch,
                                                          reps=opt.reps)
                    checked(launch, total, want, f"{key} on {label}")
                    row[key + "_active_clusters"] = (
                        lib.score_pass_active_clusters(launch.args))
        for i, v in enumerate(variants):
            launch, total = prepared(libs[f"v{i}"][0], False, ct, pb, w,
                                     skip, zk)
            row[f"v{i}_cold"] = k1_bench.time_ms(launch, reps=opt.reps)
            checked(launch, total, want, f"variant {v} on {label}")
            row[f"v{i}"] = v
        if opt.phases:
            row["phases"] = phase_split(libs["phases"][0], batch,
                                        min(row["this_cold"]))
        if opt.parent_rows:
            row["parent_rows"] = parent_rows(libs["parent"][0], batch,
                                             opt.reps)
        row["speedup_cold"] = min(row["parent_cold"]) / min(row["this_cold"])
        result["batches"][label] = row
        print(f"[K12 {label}] B {row['B']} N {row['N']} TP {row['TP']}: "
              f"equal to the twin | " + " | ".join(
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
                      for k, v in result["batches"].items()}))


if __name__ == "__main__":
    main()
