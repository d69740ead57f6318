"""Time kernel K13 (seq_scan) against the parent commit's K13, in one process.

    python3 tools/k13_compare.py --fetch REV      # where git is: copies
        REV's seq_scan.cu and the headers it includes into .k13_parent/
    python3 tools/k13_compare.py [--reps 5] [--clusters 16,8]
        [--out RESULT.json]                       # on the card

The second form builds both sources with nvcc into shared libraries of
their own (`-Xptxas -v` printed for each): the port's
kernels/seq_scan.cu and the copy in .k13_parent/.  On four full-width
batches, each library's launch is held against K13's plain twin
(models/batched.py scan_plain) on the same inputs, every output bit for
bit, and then timed (kernels/k1_bench.py, L2 cold and warm) in turns: this,
parent, parent, this, so each has two samples and drift between them
shows.  The batches are chip_smoke.py's: phase K13's three (a 2-slot
fleet, 256 nominated claims, host ports with quality top-3 at R = 32) and
phase K13 affinity's (2,048 pod-anti-affinity pods on the 2-slot fleet, the
affinity mode, its pair rows put back before each launch outside the
events); and a fifth, the 2-slot fleet under pods whose requests change
from each pod to the next (seven CPU sizes in turn), where K13's memo of
the previous pod's terms never holds.  Each cluster size in --clusters
other than the port's 16 blocks is a build of its own (-DK13_CLUSTER=c),
held to the twin after it is timed.  With --phases a build of the port's
source with -DK13_PHASE_CLOCKS runs each batch once more and prints where
a step's time goes: each block's SM clocks between the kernel's phase
marks, summed over the batch, as shares of the step and as microseconds
(the step's cold time split by the shares).  The port's builds here take
-DK13_TOOLS, which adds the cluster-barrier floor's kernel and
seq_scan_shape.  Both sources take the same SeqScanArgs; the parent's
workspace is seq_scan_workspace_bytes(n, pv, tp), the entry point of K13's
one-block design.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import kcompare  # noqa: E402

KDIR = kcompare.KDIR
PARENT_DIR = os.path.join(ROOT, ".k13_parent")
SOURCE = "seq_scan.cu"


def fetch(rev: str) -> None:
    """REV's seq_scan.cu and every header it includes, into PARENT_DIR."""
    kcompare.fetch(rev, SOURCE, PARENT_DIR)


PHASES = ("pass 1", "its block max", "cluster A", "zone sums, IPA",
          "cluster I", "pass 2", "the sample", "select", "ties",
          "the window", "cluster S", "the host", "commit", "step start")


def load(path: str, parent: bool, phases: bool = False):
    from kubernetes_tpu_torch.kernels import SeqScanArgs

    p, i = ctypes.c_void_p, ctypes.c_int
    sig = {"seq_scan_launch": ([SeqScanArgs, p], i)}
    if parent:
        sig["seq_scan_workspace_bytes"] = ([i, i, i], ctypes.c_longlong)
        return kcompare.load(path, sig)
    sig.update(seq_scan_workspace_size=([SeqScanArgs], ctypes.c_longlong),
               seq_scan_shape=([i, p], i),
               seq_scan_barrier_floor_launch=([i, i, i, p], i))
    if phases:
        sig["seq_scan_phase_clocks"] = ([p, i], i)
    return kcompare.load(path, sig)


def _mixed_pod(i: int):
    """A plain pending pod whose CPU request differs from the pod before
    it: 100m-700m in turn."""
    from kubernetes_tpu_torch.api.factory import make_pod

    d = i % 20
    return make_pod(f"pod-{i}", cpu=f"{100 * (1 + i % 7)}m", mem="256Mi",
                    labels={"app": f"dep-{d}"}, owner=("ReplicaSet", f"rs-{d}"))


def batches():
    """(label, kernels.seq_scan args, kwargs, the twin's outputs, put_back
    or None, sizes) of the four batches, as chip_smoke.py builds them."""
    import chip_smoke as cs
    import torch

    from kubernetes_tpu_torch import loop
    from kubernetes_tpu_torch.codec.schema import (
        DEFAULT_PRIORITY_WEIGHTS, FilterConfig, PRIO_INDEX, ScoreConfig)
    from kubernetes_tpu_torch.models.batched import scan_plain, static_pass
    from kubernetes_tpu_torch.ops.predicates import batch_pairs, union_rows
    from kubernetes_tpu_torch.ops.priorities import pod_spread_match

    out = []
    for label, fleet, pods, noms, tk in (
            ("2-slot", loop.bench_nodes(cs.NODES, pods_per_node=2),
             [loop.pending_pod(i) for i in range(cs.BATCH)], (), 0),
            ("nominated", loop.bench_nodes(cs.NODES),
             [loop.pending_pod(i) for i in range(cs.BATCH)],
             loop.nominated_preemptors(cs.NODES, cs.NOMINATED), 0),
            ("ports-top3-r32", loop.bench_nodes(cs.NODES, extended=13),
             [cs._port_pod(i) for i in range(cs.BATCH)], (), 3),
            ("2-slot-mixed-requests",
             loop.bench_nodes(cs.NODES, pods_per_node=2),
             [_mixed_pod(i) for i in range(cs.BATCH)], (), 0)):
        inp = cs._scan_batch(fleet, pods, noms, tk)
        want = scan_plain(*inp["twin"])
        out.append((label, inp["args"], inp["kw"], want, None,
                    {k: inp[k] for k in ("B", "N", "R", "PV", "tk")}))
    st = cs._aff_batch(loop.bench_nodes(cs.NODES, pods_per_node=2),
                       [loop.pending_pod(i, "pod-anti-affinity")
                        for i in range(cs.BATCH)])
    ct, pb, ports, aff = st["ct"], st["pb"], st["ports"], st["aff"]
    w = DEFAULT_PRIORITY_WEIGHTS
    smask, sscore = static_pass(ct, pb, FilterConfig(), st["key"], w,
                                ScoreConfig(), in_batch_affinity=True)
    w5 = tuple(float(w[PRIO_INDEX[k]]) for k in (
        "LeastRequestedPriority", "MostRequestedPriority",
        "BalancedResourceAllocation", "SelectorSpreadPriority",
        "RequestedToCapacityRatioPriority"))
    ipa = (float(w[PRIO_INDEX["InterPodAffinityPriority"]]),
           float(FilterConfig().hard_pod_affinity_weight))
    args = (ct, pb, ports, smask, sscore,
            pod_spread_match(pb, ct.group_counts.shape[1]), None, None,
            None, w5, st["zone_key"], 0, 0)
    want = scan_plain(*args, "plain", aff, ipa)
    rows = union_rows(pb, ct.topo_pairs.shape[1])
    unions = {k: v.clone() for k, v in rows.items()}

    def put_back():
        for k, v in rows.items():
            unions[k].copy_(v)

    kw = {"aff": aff, "pairs": batch_pairs(ct, pb, aff.pref_topo_key),
          "unions": unions, "ipa": ipa}
    out.append(("affinity-redo", args, kw, want, put_back,
                {"B": pb.n_pods, "N": ct.n_nodes, "R": ct.requested.shape[1],
                 "PV": ports.pod_ports.shape[1], "tk": 0,
                 "TP": ct.topo_pairs.shape[1]}))
    torch.cuda.synchronize()
    return out


def prepared(lib, parent: bool, args, kw):
    """One launch of `lib` on fresh outputs: (launch(), outputs)."""
    import torch

    from kubernetes_tpu_torch import kernels

    (ct, pods, ports, smask, sscore, match, nom, feas, rtc, w5, zk, li,
     tk) = args
    a, keep, out = kernels.seq_scan_prepare(
        ct, pods, ports, smask, sscore, kw.get("extra_mask"),
        kw.get("extra_score"), match, nom, feas, rtc, w5, zk, li, tk,
        aff=kw.get("aff"), pairs=kw.get("pairs"), unions=kw.get("unions"),
        ipa=kw.get("ipa", (0.0, 0.0)))
    size = (lib.seq_scan_workspace_bytes(a.n, a.pv, a.tp) if parent
            else lib.seq_scan_workspace_size(a))
    work = torch.empty(size, dtype=torch.uint8, device="cuda")
    a.work = work.data_ptr()
    keep = keep + [work]

    def launch():
        err = lib.seq_scan_launch(a, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"seq_scan launch failed: cudaError {err}")
        return keep   # the tensors the arguments point into stay alive

    return launch, out


def phase_split(lib, args, kw, want, put_back, sizes, ms) -> dict:
    """One launch of the instrumented build: each phase's share of a step
    (block 0's clocks, and the mean over the blocks) and its microseconds
    at `ms` for the batch."""
    import numpy as np
    import torch

    launch, out = prepared(lib, False, args, kw)
    if put_back:
        put_back()
    launch()
    torch.cuda.synchronize()
    if not same(out, want):
        sys.exit("k13_compare: the instrumented build differs from the twin")
    threads = ctypes.c_int(0)
    blocks = lib.seq_scan_shape(sizes["N"], ctypes.byref(threads))
    clocks = np.zeros((16, len(PHASES)), np.int64)
    err = lib.seq_scan_phase_clocks(clocks.ctypes.data, blocks)
    if err:
        sys.exit(f"k13_compare: phase clocks unread (cudaError {err})")
    clocks = clocks[:blocks].astype(float)
    share0 = clocks[0] / clocks[0].sum()
    mean = clocks.mean(0) / clocks.mean(0).sum()
    top = clocks.max(0) / clocks[0].sum()   # the slowest block's, on block 0's scale
    us = ms * 1e3 / sizes["B"]
    split = {name: {"share_block0": float(share0[i]),
                    "share_mean": float(mean[i]),
                    "share_max": float(top[i]),
                    "us_a_step": float(share0[i] * us)}
             for i, name in enumerate(PHASES)}
    print("[phases] " + " | ".join(
        f"{name} {d['us_a_step']:.3f} us ({100 * d['share_block0']:.1f}%, "
        f"blocks' mean {100 * d['share_mean']:.1f}%, max "
        f"{100 * d['share_max']:.1f}%)"
        for name, d in split.items() if d["share_mean"] > 0.0005),
        flush=True)
    return split


same = kcompare.same


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--clusters", default="16,8")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--out")
    opt = ap.parse_args()
    if opt.fetch:
        fetch(opt.fetch)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("k13_compare: no CUDA card")
    from kubernetes_tpu_torch.kernels import k1_bench

    t0 = time.monotonic()
    if not os.path.exists(os.path.join(PARENT_DIR, SOURCE)):
        sys.exit(f"k13_compare: no {PARENT_DIR}/{SOURCE}; run --fetch REV "
                 "where git is")
    clusters = [int(c) for c in opt.clusters.split(",") if c]
    port = os.path.join(KDIR, SOURCE)
    libs = {}
    builds = [("this", port, KDIR, False, ("-DK13_TOOLS",)),
              ("parent", os.path.join(PARENT_DIR, SOURCE), PARENT_DIR, True,
               ())]
    builds += [(f"c{c}", port, KDIR, False,
                ("-DK13_TOOLS", f"-DK13_CLUSTER={c}"))
               for c in clusters if c != 16]
    if opt.phases:
        builds.append(("phases", port, KDIR, False,
                       ("-DK13_TOOLS", "-DK13_PHASE_CLOCKS")))
    for name, src, inc, parent, defines in builds:
        so = kcompare.build(f"k13_{name}", src, inc, defines, "k13_seq_scan")
        libs[name] = (load(so, parent, name == "phases"), parent)
    by_size = {c: libs["this" if c == 16 else f"c{c}"][0] for c in clusters}
    smi = kcompare.card()
    print(f"[card] {smi}", flush=True)
    result = {"card": smi, "batches": {}, "barrier_us": {}}
    this = libs["this"][0]
    steps = 4096
    for c in clusters:
        for t in (32, 384):
            def floor(c=c, t=t):
                err = this.seq_scan_barrier_floor_launch(
                    steps, c, t, torch.cuda.current_stream().cuda_stream)
                if err:
                    sys.exit(f"k13_compare: barrier floor refused ({err})")
            us = k1_bench.time_ms(floor, reps=10, cold=False) / steps * 1e3
            result["barrier_us"][f"c{c}_t{t}"] = us
    print("[cluster barrier] " + ", ".join(
        f"{k}: {v:.4f} us" for k, v in result["barrier_us"].items()),
        flush=True)
    for label, args, kw, want, put_back, sizes in batches():
        row = dict(sizes)
        runs = {}
        for name in ("this", "parent"):
            lib, parent = libs[name]
            launch, out = prepared(lib, parent, args, kw)
            if put_back:
                put_back()
            launch()
            torch.cuda.synchronize()
            if not same(out, want):
                sys.exit(f"k13_compare: {name} differs from the twin on "
                         f"{label}")
            runs[name] = launch
        for name in ("this", "parent", "parent", "this"):
            for cold in (True, False):
                ms = k1_bench.time_ms(runs[name], reps=opt.reps, cold=cold,
                                      before=put_back)
                row.setdefault(f"{name}_{'cold' if cold else 'warm'}",
                               []).append(ms)
        for c, lib in by_size.items():
            threads = ctypes.c_int(0)
            lib.seq_scan_shape(sizes["N"], ctypes.byref(threads))
            row[f"c{c}_threads"] = threads.value
            launch, out = prepared(lib, False, args, kw)
            row[f"c{c}_cold"] = k1_bench.time_ms(launch, reps=opt.reps,
                                                 before=put_back)
            # the timed build equals the twin at this size too
            if put_back:
                put_back()
            launch()
            torch.cuda.synchronize()
            if not same(out, want):
                sys.exit(f"k13_compare: the {c}-block build differs from "
                         f"the twin on {label}")
        if opt.phases:
            row["phases"] = phase_split(libs["phases"][0], args, kw, want,
                                        put_back, sizes, min(row["this_cold"]))
        for k in ("this_cold", "parent_cold"):
            row[k + "_us_a_step"] = min(row[k]) / sizes["B"] * 1e3
        row["speedup_cold"] = min(row["parent_cold"]) / min(row["this_cold"])
        result["batches"][label] = row
        print(f"[K13 {label}] B {sizes['B']} N {sizes['N']} R {sizes['R']} "
              f"tk {sizes['tk']}: both equal the twin | this cold "
              f"{row['this_cold']} warm {row['this_warm']} ms | parent cold "
              f"{row['parent_cold']} warm {row['parent_warm']} ms | this "
              f"{row['this_cold_us_a_step']:.3f} us a step, parent "
              f"{row['parent_cold_us_a_step']:.3f}, {row['speedup_cold']:.2f}x"
              " | " + ", ".join(f"cluster {c} ({row[f'c{c}_threads']} "
                                f"threads): {row[f'c{c}_cold']:.4f} ms"
                                for c in clusters), flush=True)
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
