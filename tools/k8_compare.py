"""Time kernel K8 (binpack_counts) against the parent commit's K8, in one process.

    python3 tools/k8_compare.py --fetch REV      # where git is: copies
        REV's binpack_counts.cu into .k8_parent/
    python3 tools/k8_compare.py [--reps 10] [--phases] [--parent-only]
        [--block 0,1] [--defines "A=1;B=2"]
        [--out RESULT.json]                      # on the card

The second form builds both sources with nvcc into shared libraries of
their own (`-Xptxas -v` printed for each): the port's
kernels/binpack_counts.cu and the copy in .k8_parent/.  On K8's launch
shapes, each library's launch is held against K8's plain twin
(models/binpack.py binpack_counts_plain: used, placed and, per-bin,
touched) bit for bit and then timed (kernels/k1_bench.py, L2 cold and
warm) in turns: this, parent, parent, this, so each has two samples and
drift between them shows.  The shapes:

  * what-if: BASELINE's fifth configuration (chip_smoke._baseline_sweep,
    in K9's order): S 10,000 lanes, C 256, 2,048 bins, R 8;
  * stage 1 / stage 2: every K8 launch of chip_smoke.py's live capacity
    cell (phase 21: per-bin over the 6,144 node rows, S 1; uniform over
    1,024 bins, S 64), their inputs captured from a run of the cell
    (chip_smoke.phase_live_capacity) and kept in .k8_parent/ (a copy
    beside --out's file) so a later run reads them instead; the slowest
    launch of each stage and the sum over its launches;
  * stage 1 at 16,385 rows: each stage-1 launch again with its node rows
    tiled to 16,385 (a cluster that wide: three held columns, the loads
    in the workspace);
  * per-bin-16385, per-bin-40000, per-bin-capacity-16385:
    kernels/k8_cases.py's cases whose loads both keep in the workspace
    (four held columns, four, and three as stage 1 holds them).

--phases builds both sources once more with -DK8_PHASE_CLOCKS (the
parent's copy gets the same marks, put in by `parent_with_marks`) and
prints where a launch's time goes: thread 0's SM clocks in every block
between the phase marks (the step's prologue; the admission walk, or the
summary test and the walk; the scan; the fill; the lane's prologue and
epilogue), as shares and as microseconds of the cold launch.  --block
times the port's source on another launch shape (1 a block a lane, 0 a
warp a lane), held to the twin after it is timed.  --defines "A=1;B"
builds the port's source once more for each -D setting (a variant kept
under #ifdef while it is measured) and times it the same way.
--parent-only times the parent alone.  Needs one CUDA card.
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
PARENT_DIR = os.path.join(ROOT, ".k8_parent")
SOURCE = "binpack_counts.cu"
CAPTURE = os.path.join(PARENT_DIR, "capacity_inputs.npz")
WIDE_ROWS = 16385   # stage 1's node rows tiled to a cluster this wide
PHASES = ("step prologue", "walk or summary test", "scan", "fill",
          "lane prologue and epilogue")
# the port's instrumented build also counts (thread 0's share of them)
COUNTS = ("steps walked", "candidate chunks", "chunks admitting",
          "chunks filled")

# The phase marks' machinery, as the port's source has it under
# K8_PHASE_CLOCKS; parent_with_marks puts it into the parent's copy.
MARKS = r"""
#ifdef K8_PHASE_CLOCKS
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_clocks[kPhases];
#define K8_CLOCKS_START                                               \
  long long clocks_[kPhases] = {};                                    \
  long long then_;                                                    \
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(then_) :: "memory");
#define K8_MARK(i)                                                    \
  if (threadIdx.x == 0) {                                             \
    long long now_;                                                   \
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(now_) :: "memory"); \
    clocks_[i] += now_ - then_;                                       \
    then_ = now_;                                                     \
  }
#define K8_CLOCKS_END                                                 \
  if (threadIdx.x == 0)                                               \
    for (int i_ = 0; i_ < kPhases; ++i_)                              \
      atomicAdd(&g_phase_clocks[i_], (unsigned long long)clocks_[i_]);
#else
#define K8_CLOCKS_START
#define K8_MARK(i)
#define K8_CLOCKS_END
#endif
"""
EXPORTS = r"""
#ifdef K8_PHASE_CLOCKS
extern "C" const char* binpack_counts_phase_names() {
  return "step prologue,walk or summary test,scan,fill,"
         "lane prologue and epilogue";
}
extern "C" int binpack_counts_phase_reset() {
  const unsigned long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof zero);
}
extern "C" int binpack_counts_phase_clocks(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks,
                                   sizeof(unsigned long long) * kPhases);
}
#endif
"""
# (anchor in the parent's source, text put before it, text put after it)
PARENT_MARKS = (
    ("namespace {\n", "", MARKS),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "", "  K8_CLOCKS_START\n"),
    ("    int parity = 0;\n", "    K8_MARK(4);\n", ""),
    ("      const bool real = __syncthreads_or(pos) != 0;\n", "",
     "      K8_MARK(0);\n"),
    ("        // block-wide exclusive scan of a, in 64-bit\n",
     "        K8_MARK(1);\n", ""),
    ("        if (n != 0) {\n", "        K8_MARK(2);\n", ""),
    ("      if (tid == 0) placed[(size_t)s * C + k] = (int)s_sum;\n", "",
     "      K8_MARK(3);\n"),
    ("    __syncthreads();  // the next lane zeroes L and s_used\n  }\n}\n",
     "", ""),
)


def fetch(rev: str) -> None:
    """REV's binpack_counts.cu (and any header it includes) into
    PARENT_DIR."""
    kcompare.fetch(rev, SOURCE, PARENT_DIR)


def parent_with_marks() -> str:
    """The parent's source with the phase marks put in (a file beside
    it); raises where an anchor is missing or not unique."""
    with open(os.path.join(PARENT_DIR, SOURCE)) as f:
        text = f.read()
    for anchor, before, after in PARENT_MARKS:
        if text.count(anchor) != 1:
            raise RuntimeError(f"k8_compare: the parent's anchor "
                               f"{anchor!r} is not unique")
        if anchor.endswith("  }\n}\n"):       # the kernel's end
            after = anchor.replace("  }\n}\n", "    K8_MARK(4);\n  }\n"
                                   "  K8_CLOCKS_END\n}\n")
            text = text.replace(anchor, after)
            continue
        text = text.replace(anchor, before + anchor + after)
    out = os.path.join(PARENT_DIR, "binpack_counts_marks.cu")
    with open(out, "w") as f:
        f.write(text + EXPORTS)
    return out


def load(path: str, parent: bool, phases: bool = False):
    p, i = ctypes.c_void_p, ctypes.c_int
    if parent:
        sig = {"binpack_counts_launch": ([p, p, i, i, p, i, i, p, i]
                                         + [p] * 6, i),
               "binpack_counts_workspace_floats": ([i, i, i],
                                                   ctypes.c_longlong)}
    else:
        from kubernetes_tpu_torch.kernels import _build

        sig = {"binpack_counts_launch": _build.BINPACK_COUNTS_SIGNATURE}
    if phases:
        sig.update(binpack_counts_phase_names=([], ctypes.c_char_p),
                   binpack_counts_phase_reset=([], i),
                   binpack_counts_phase_clocks=([p], i))
        if not parent:
            sig["binpack_counts_phase_counts"] = ([p], i)
    return kcompare.load(path, sig)


def capacity_calls(copy_dir=None):
    """{stage: [(reqs, counts, caps, order, n_bins, per_bin)]} of the live
    capacity cell's K8 launches, on the card: from CAPTURE, else from a
    run of chip_smoke.py's phase 21 (saved to CAPTURE and, where given,
    into copy_dir as k8_capacity_inputs.npz)."""
    import numpy as np
    import torch

    keys = ("reqs", "counts", "caps", "order")
    if not os.path.exists(CAPTURE):
        import chip_smoke as cs

        seen: dict = {}
        real = cs._k8_capacity_shapes
        cs._k8_capacity_shapes = lambda label, calls: seen.update(calls) or {}
        try:
            cs.phase_live_capacity()
        finally:
            cs._k8_capacity_shapes = real
        flat = {}
        for stage, calls in seen.items():
            for j, call in enumerate(calls):
                tag = f"{stage.replace(' ', '')}_{j}"
                for k, t in zip(keys, call[:4]):
                    flat[f"{tag}_{k}"] = t.cpu().numpy()
                flat[f"{tag}_meta"] = np.array([call[4], int(call[5])])
        copies = [os.path.join(copy_dir, "k8_capacity_inputs.npz")] \
            if copy_dir else []
        for path in [CAPTURE] + copies:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            np.savez_compressed(path, **flat)
    data = np.load(CAPTURE)
    out: dict = {}
    tags = sorted({k.rsplit("_", 1)[0] for k in data.files},
                  key=lambda t: (t.split("_")[0], int(t.split("_")[1])))
    for tag in tags:
        stage = tag.split("_")[0].replace("stage", "stage ")
        nb, pb = (int(x) for x in data[f"{tag}_meta"])
        out.setdefault(stage, []).append(tuple(
            torch.from_numpy(data[f"{tag}_{k}"]).cuda() for k in keys)
            + (nb, bool(pb)))
    return out


def shapes(copy_dir=None):
    """[(label, (reqs, counts, caps, order, n_bins, per_bin), the twin's
    (used, placed, touched), admissions up to each step's last fill)];
    copy_dir: capacity_calls'."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.kernels import k8_cases
    from kubernetes_tpu_torch.models.binpack import binpack_counts_plain

    out = []

    def add(label, call):
        work: dict = {}
        used, placed, _, touched = binpack_counts_plain(*call, work=work)
        out.append((label, call, (used, placed, touched),
                    work["bin_columns"]))

    classes, counts, caps, _ = cs._baseline_sweep()
    add("what-if", (classes, counts, caps, kernels.ffd_order(classes, caps),
                    cs.WHAT_IF_BINS, False))
    captured = capacity_calls(copy_dir)
    for stage, calls in captured.items():
        for j, call in enumerate(calls):
            add(f"{stage} #{j}", call)
    for j, call in enumerate(captured["stage 1"]):
        reqs, counts, caps, order, _, _ = call
        rows = torch.from_numpy(np.resize(caps.cpu().numpy(),
                                          (WIDE_ROWS, caps.shape[1])))
        add(f"stage 1 at {WIDE_ROWS} rows #{j}",
            (reqs, counts, rows.cuda(), order, WIDE_ROWS, True))
    cases = dict(k8_cases.cases())
    for name in ("per-bin-16385", "per-bin-40000", "per-bin-capacity-16385"):
        c = cases[name]
        add(name, tuple(torch.from_numpy(c[k]).cuda() for k in (
            "reqs", "counts", "caps", "order")) + (c["n_bins"],
                                                   c["per_bin"]))
    torch.cuda.synchronize()
    return out


def repath(args, call, block: bool):
    """The port's launch arguments (kernels.binpack_counts_prepare's) on
    another launch shape: `block` (a block a lane, else a warp a lane) put
    in, and a workspace of every slot the kernel could want.  Returns
    (arguments, workspace)."""
    import torch

    from kubernetes_tpu_torch import kernels

    reqs, _, _, _, nb, pb = call
    R = reqs.shape[1]
    grid = args[10]
    slot = R * (nb * (2 if pb else 1) + -(-nb // kernels.K8_CHUNK))
    work = torch.empty(grid * kernels.K8_WORK_LANES * slot,
                       dtype=torch.float32, device=reqs.device)
    args = list(args)
    args[9] = int(block)
    args[11] = work.data_ptr()
    return tuple(args), work


def prepared(lib, parent: bool, call, **path):
    """One launch of `lib` on fresh outputs: (launch(), outputs); `path`:
    another launch shape for the port's (repath's block)."""
    import torch

    reqs, counts, caps, order, nb, pb = call
    S, (C, R) = order.shape[0], reqs.shape
    if parent:
        dev = reqs.device
        used = torch.empty(S, dtype=torch.int32, device=dev)
        placed = torch.empty((S, C), dtype=torch.int32, device=dev)
        touched = torch.empty(nb, dtype=torch.bool, device=dev) if pb \
            else None
        work = torch.empty(int(lib.binpack_counts_workspace_floats(S, nb, R)),
                           dtype=torch.float32, device=dev)
        args = (reqs.data_ptr(), counts.data_ptr(), C, R, caps.data_ptr(),
                int(pb), nb, order.data_ptr(), S, work.data_ptr(),
                used.data_ptr(), placed.data_ptr(), None,
                touched.data_ptr() if touched is not None else None)
        keep = (work,)
        outs = (used, placed, touched)
    else:
        from kubernetes_tpu_torch import kernels

        args, keep, (used, placed, _, touched) = \
            kernels.binpack_counts_prepare(reqs, counts, caps, order, nb, pb)
        if path:
            args, work = repath(args, call, **path)
            keep = (keep, work)
        outs = (used, placed, touched)

    def launch():
        err = lib.binpack_counts_launch(
            *args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{'parent ' * parent}binpack_counts launch "
                               f"failed: cudaError {err}")
        return keep

    return launch, outs


def checked(launch, outs, want, what: str) -> None:
    import torch

    launch()
    torch.cuda.synchronize()
    if not kcompare.same(tuple(outs), tuple(want)):
        sys.exit(f"k8_compare: {what} differs from the twin")


def phase_split(lib, parent: bool, shape, ms: float) -> dict:
    """One launch of an instrumented build: each phase's share of thread
    0's clocks summed over the blocks, and its microseconds of the cold
    launch."""
    import numpy as np

    label, call, want, _ = shape
    launch, outs = prepared(lib, parent, call)
    names = lib.binpack_counts_phase_names().decode().split(",")
    if lib.binpack_counts_phase_reset():
        sys.exit("k8_compare: phase clocks not reset")
    checked(launch, outs, want, f"the instrumented build on {label}")
    clocks = np.zeros(len(names), np.uint64)
    if lib.binpack_counts_phase_clocks(clocks.ctypes.data):
        sys.exit("k8_compare: phase clocks unread")
    share = clocks.astype(float) / max(float(clocks.sum()), 1.0)
    split = {name: {"share": float(share[i]),
                    "us": float(share[i] * ms * 1e3)}
             for i, name in enumerate(names)}
    if not parent:
        counts = np.zeros(4, np.uint64)
        if lib.binpack_counts_phase_counts(counts.ctypes.data):
            sys.exit("k8_compare: phase counts unread")
        split["counts"] = dict(zip(COUNTS, (int(x) for x in counts)))
        print(f"[counts {label}] {split['counts']}", flush=True)
    print(f"[{'parent ' * parent}phases {label}] " + " | ".join(
        f"{name} {d['us']:.3f} us ({100 * d['share']:.1f}%)"
        for name, d in split.items() if name in names), flush=True)
    return split


def stage_sums(result: dict) -> dict:
    """By stage: the launches, the sum of their best cold / warm ms of
    each library, and the slowest launch."""
    out: dict = {}
    for label, row in result["shapes"].items():
        if not label.startswith("stage"):
            continue
        d = out.setdefault(label.split(" #")[0], {"launches": 0})
        d["launches"] += 1
        for key, v in row.items():
            if key.endswith(("_cold", "_warm")) and isinstance(v, list):
                d[key + "_sum"] = d.get(key + "_sum", 0.0) + min(v)
                slow = d.setdefault("slowest_" + key, [None, -1.0])
                if min(v) > slow[1]:
                    d["slowest_" + key] = [label, min(v)]
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--parent-only", action="store_true")
    ap.add_argument("--block", default="")
    ap.add_argument("--defines", default="")
    ap.add_argument("--out")
    opt = ap.parse_args()
    if opt.fetch:
        fetch(opt.fetch)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("k8_compare: no CUDA card")
    from kubernetes_tpu_torch.kernels import k1_bench

    t0 = time.monotonic()
    if not os.path.exists(os.path.join(PARENT_DIR, SOURCE)):
        sys.exit(f"k8_compare: no {PARENT_DIR}/{SOURCE}; run --fetch REV "
                 "where git is")
    port = os.path.join(KDIR, SOURCE)
    builds = [] if opt.parent_only else [("this", port, KDIR, False, ())]
    builds.append(("parent", os.path.join(PARENT_DIR, SOURCE), PARENT_DIR,
                   True, ()))
    if opt.phases:
        if not opt.parent_only:
            builds.append(("this_phases", port, KDIR, False,
                           ("-DK8_PHASE_CLOCKS",)))
        builds.append(("parent_phases", parent_with_marks(), PARENT_DIR,
                       True, ("-DK8_PHASE_CLOCKS",)))
    variants = [d for d in opt.defines.split(";") if d]
    for d in variants:
        builds.append((f"this_{d}", port, KDIR, False, (f"-D{d}",)))
    libs = {}
    for name, src, inc, parent, defines in builds:
        so = kcompare.build(f"k8_{name}", src, inc, defines, "k8_")
        libs[name] = (load(so, parent, name.endswith("_phases")), parent)
    smi = kcompare.card()
    print(f"[card] {smi}", flush=True)
    result = {"card": smi, "shapes": {}}
    order = (("parent", "parent") if opt.parent_only
             else ("this", "parent", "parent", "this"))
    blocks = [bool(int(x)) for x in opt.block.split(",") if x]
    for shape in shapes(os.path.dirname(os.path.abspath(opt.out))
                        if opt.out else None):
        label, call, want, admissions = shape
        reqs, counts, caps, ordr, nb, pb = call
        row = {"S": ordr.shape[0], "C": reqs.shape[0], "R": reqs.shape[1],
               "bins": nb, "per_bin": pb, "admissions": admissions}
        runs = {}
        for name in dict.fromkeys(order):
            lib, parent = libs[name]
            launch, outs = prepared(lib, parent, call)
            checked(launch, outs, want, f"{name} on {label}")
            runs[name] = launch
        for name in order:
            for cold in (True, False):
                ms = k1_bench.time_ms(runs[name], reps=opt.reps, cold=cold)
                row.setdefault(f"{name}_{'cold' if cold else 'warm'}",
                               []).append(ms)
        if not opt.parent_only:
            from kubernetes_tpu_torch import kernels

            row["path"] = kernels.binpack_counts_path(
                reqs, caps, ordr, nb, pb)._asdict()
            for d in variants:
                launch, outs = prepared(libs[f"this_{d}"][0], False, call)
                row[f"{d}_cold"] = k1_bench.time_ms(launch, reps=opt.reps)
                checked(launch, outs, want, f"-D{d} on {label}")
            for block in blocks:
                launch, outs = prepared(libs["this"][0], False, call,
                                        block=block)
                key = f"block{int(block)}"
                row[key + "_cold"] = k1_bench.time_ms(launch, reps=opt.reps)
                checked(launch, outs, want, f"{key} on {label}")
            row["speedup_cold"] = (min(row["parent_cold"])
                                   / min(row["this_cold"]))
        if opt.phases:
            for name in ("this", "parent"):
                if f"{name}_phases" in libs:
                    row[f"{name}_phases"] = phase_split(
                        libs[f"{name}_phases"][0], name == "parent", shape,
                        min(row[f"{name}_cold"]))
        result["shapes"][label] = row
        print(f"[K8 {label}] S {row['S']} C {row['C']} R {row['R']} "
              f"{nb} bins {'per-bin' if pb else 'uniform'}, {admissions} "
              f"admissions: equal to the twin | " + " | ".join(
                  f"{k} {v}" for k, v in row.items()
                  if k.endswith(("_cold", "_warm")) or k == "speedup_cold")
              + (f" | path {row['path']}" if "path" in row else ""),
              flush=True)
    result["stages"] = stage_sums(result)
    for stage, d in result["stages"].items():
        print(f"[K8 {stage}] {d} | {smi}", flush=True)
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
