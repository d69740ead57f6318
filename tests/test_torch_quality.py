"""The placement-quality slice of the port against the JAX package, on CPU.

Everything here is bit for bit:
  * K3's plain twin (ops/select.py select_topk_batch_plain) against the
    jitted JAX select_topk_batch, and select_topk_plain against select_topk,
    on every CPU-sized case of kernels/k3_cases.py with every K;
  * K4's plain twin (models/binpack.py binpack_ffd_plain) against the
    jitted JAX binpack_ffd on every case of kernels/k4_cases.py, 1-D and
    2-D capacities, with and without an order;
  * the port's regret counterfactual (runtime/quality.py
    _ffd_counterfactual) against the JAX _regret_kernel();
  * both port engines with quality_topk=3 against the JAX engines:
    plain, in-batch affinity and the hybrid redo;
  * the port's Scheduler against the JAX Scheduler with quality_top_k=3
    and quality_interval_cycles=1 on tests/test_torch_live.py's scenarios:
    bindings, every cycle's top-k leaves, margin and feasible p50s and the
    regret samples; and quality on and off giving the same bindings.
K3 and K4 run only on the card: chip_smoke.py holds them against their
twins on the same cases, and the `cuda`-marked tests below do the same
where a card is present.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.models import binpack as jbin
from kubernetes_tpu.ops import select as jsel
from kubernetes_tpu.runtime import quality as jqual
from kubernetes_tpu_torch import kernels, loop
from kubernetes_tpu_torch.kernels import k3_cases, k4_cases
from kubernetes_tpu_torch.models import binpack as tbin
from kubernetes_tpu_torch.ops import select as tsel
from kubernetes_tpu_torch.runtime import quality as tqual

# the CPU cases leave out the shapes above this many cells; chip_smoke.py
# and the cuda test run those on the card
CPU_MAX_CELLS = 1_500_000
_jax_hosts = jax.jit(jsel.select_hosts_batch)
_jax_topk = jax.jit(jsel.select_topk_batch, static_argnums=4)
_jax_topk1 = jax.jit(jsel.select_topk, static_argnums=4)


def _i32(x):
    return jnp.int32(np.int32(np.int64(kernels.wrap_i32(x))))


def _k3_params():
    out = []
    for B, N in k3_cases.shapes():
        if B * N <= CPU_MAX_CELLS:
            out.append(pytest.param(B, N, id=f"B{B}-N{N}"))
    return out


def _assert_topk_equal(jq, tq, what):
    for name, j, t in zip(("top_nodes", "top_scores", "feasible"), jq, tq):
        j = np.asarray(j)
        t = t.numpy()
        assert j.dtype == t.dtype, (what, name, j.dtype, t.dtype)
        # bit for bit: compare the bytes (NaN and -0.0 included)
        np.testing.assert_array_equal(j.view(np.int32), t.view(np.int32),
                                      err_msg=f"{what} {name}")


@pytest.mark.parametrize("B,N", _k3_params())
def test_select_topk_batch_identical(B, N):
    """The twin against the JAX select_topk_batch on K1's verdict for the
    same rows, every case shift, rotation counter and K (K > N clamps)."""
    for shift in k3_cases.shifts(B):
        scores, mask = k3_cases.rows(B, N, shift)
        st, mt = torch.from_numpy(scores), torch.from_numpy(mask)
        for li in k3_cases.LAST_INDICES:
            jh, jf = _jax_hosts(scores, mask, _i32(li))
            th, tf = tsel.select_hosts_batch(st, mt, li)
            np.testing.assert_array_equal(np.asarray(jh), th.numpy())
            for k in k3_cases.KS:
                kk = tsel.topk_width(k, N)
                jq = _jax_topk(scores, mask, jh, jf, kk)
                tq = tsel.select_topk_batch(st, mt, th, tf, k)
                assert tq.top_nodes.shape == (B, kk)
                _assert_topk_equal(jq, tq, f"shift {shift} li {li} k {k}")


def test_select_topk_one_row_identical():
    """select_topk_plain / select_topk (B=1, the sequential step's form)
    against the JAX select_topk, row by row."""
    B = len(k3_cases.CASES)
    scores, mask = k3_cases.rows(B, 40)
    for li in k3_cases.LAST_INDICES:
        jh, jf = _jax_hosts(scores, mask, _i32(li))
        th, tf = tsel.select_hosts_batch(torch.from_numpy(scores),
                                         torch.from_numpy(mask), li)
        for b in range(B):
            s, m = torch.from_numpy(scores[b]), torch.from_numpy(mask[b])
            for k in (1, 3, 8):
                jq = _jax_topk1(scores[b], mask[b], jh[b], jf[b], k)
                for fn in (tsel.select_topk_plain, tsel.select_topk):
                    tq = fn(s, m, th[b], tf[b], k)
                    assert tq.top_nodes.shape == (k,)
                    _assert_topk_equal(jq, tq, f"row {b} li {li} k {k}")


def test_select_topk_winner_pinned_among_ties():
    """The reference's own case: a winner rotated off the first of its
    ties stays in column 0, and the runner-ups are the other ties, lower
    node first; -0.0 ranks below 0.0."""
    s = torch.tensor([[3.0, 1.0, 3.0, 3.0, 0.0, -0.0],
                      [-0.0, 0.0, -1.0, -0.0, 0.0, 2.0]])
    m = torch.ones_like(s, dtype=torch.bool)
    h, f = tsel.select_hosts_batch(s, m, 2)
    q = tsel.select_topk_batch(s, m, h, f, 4)
    assert h.tolist() == [3, 5]
    assert q.top_nodes.tolist() == [[3, 0, 2, 1], [5, 1, 4, 0]]
    assert q.top_scores[0].tolist() == [3.0, 3.0, 3.0, 1.0]
    assert q.feasible.tolist() == [6, 6]
    # fewer feasible nodes than K, and none
    m2 = torch.tensor([[False, True, False, False, False, False],
                       [False] * 6])
    h, f = tsel.select_hosts_batch(s, m2, 0)
    q = tsel.select_topk_batch(s, m2, h, f, 3)
    assert q.top_nodes.tolist() == [[1, -1, -1], [-1, -1, -1]]
    assert q.top_scores.tolist() == [[1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]
    assert q.feasible.tolist() == [1, 0]


def test_k3_cases_cover_every_case():
    for B in k3_cases.BATCHES:
        seen = {(b + sh) % len(k3_cases.CASES)
                for sh in k3_cases.shifts(B)
                for b in range(min(B, len(k3_cases.CASES)))}
        assert seen == set(range(len(k3_cases.CASES))), B
    assert any(n <= k3_cases.SMEM_MAX_N < m for n in k3_cases.WIDTHS
               for m in k3_cases.WIDTHS)
    assert max(k3_cases.KS) > min(k3_cases.WIDTHS)


def test_kernel_wrappers_refuse_cpu_tensors():
    """K3's and K4's wrappers launch or raise: a CPU tensor never reaches
    a fallback inside them (the dispatchers pick the twin for CPU)."""
    s = torch.zeros((2, 3))
    m = torch.ones((2, 3), dtype=torch.bool)
    h = torch.zeros(2, dtype=torch.int32)
    f = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError):
        kernels.select_topk(s, m, h, f, 3)
    with pytest.raises(ValueError):
        kernels.binpack_ffd(torch.zeros((4, 2)), torch.ones((3, 2)),
                            torch.arange(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tsel.topk_width(0, 5)


def _k4_args(c):
    order = None if c["order"] is None else c["order"]
    return c["reqs"], c["cap"], c["max_bins"], order


@pytest.mark.parametrize("name", [n for n, _ in k4_cases.cases()])
def test_binpack_ffd_identical(name):
    """The twin against the jitted JAX binpack_ffd on every case (per-bin
    and one-capacity forms, with and without an order): bins used, loads
    and placed flags, bit for bit."""
    c = dict(k4_cases.cases())[name]
    reqs, cap, max_bins, order = _k4_args(c)
    kw = {} if max_bins is None else {"max_bins": max_bins}
    if cap.ndim == 2:
        kw["max_bins"] = cap.shape[0]
    ju, jl, jp = jbin.binpack_ffd(reqs, cap, order=order, **kw)
    tu, tl, tp = tbin.binpack_ffd(
        torch.from_numpy(reqs), torch.from_numpy(cap), max_bins,
        None if order is None else torch.from_numpy(order))
    assert int(ju) == int(tu)
    np.testing.assert_array_equal(np.asarray(jl).view(np.int32),
                                  tl.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    if order is not None:
        np.testing.assert_array_equal(
            jbin.placed_by_pod(np.asarray(jp), order),
            tbin.placed_by_pod(tp.numpy(), order))


def test_k4_cases_cover_the_paths():
    cs = dict(k4_cases.cases())
    assert list(cs)[-1] == "full-width"
    fw = cs["full-width"]
    assert fw["cap"].shape == (6144, 8) and fw["reqs"].shape == (2048, 8)
    big = cs["workspace"]["cap"]
    assert big.size * 4 > 226 * 1024      # past K4's shared memory
    assert cs["one-capacity"]["cap"].ndim == 1
    assert any(c["order"] is None for c in cs.values())


def _regret_inputs(seed, n_real, n, P, placed_frac):
    rng = np.random.default_rng(seed)
    alloc = np.zeros((n, 8), np.float32)
    alloc[:n_real] = k4_cases._fleet_free(rng, n_real, n_real, 8, 0.0)
    used = np.zeros_like(alloc)
    k = rng.integers(0, 100, n_real).astype(np.float32)
    used[:n_real, 0] = 100.0 * k
    used[:n_real, 1] = 256 * k4_cases.MI * k
    used[:n_real, 3] = k
    valid = np.zeros(n, bool)
    valid[:n_real] = True
    valid[rng.integers(0, n_real, 3)] = False
    reqs = k4_cases._pods(P, 8, P)
    reqs[:, 0] = rng.integers(1, 30, P).astype(np.float32) * 100.0
    reqs[rng.random(P) > placed_frac] = 0.0
    return alloc, used, valid, reqs


@pytest.mark.parametrize("seed,n_real,n,P,frac", [
    (1, 200, 256, 64, 0.9), (2, 50, 64, 128, 0.5), (3, 700, 768, 256, 1.0),
    (4, 30, 32, 96, 0.0)])
def test_ffd_counterfactual_identical(seed, n_real, n, P, frac):
    """The port's regret counterfactual against the JAX _regret_kernel():
    the three i32 scalars (bins FFD touched, pods it placed, real pods)."""
    alloc, used, valid, reqs = _regret_inputs(seed, n_real, n, P, frac)
    want = [int(np.asarray(x)) for x in jqual._regret_kernel()(
        alloc, used, valid, reqs)]
    got = tqual._ffd_counterfactual(
        *(torch.from_numpy(a) for a in (alloc, used, valid, reqs)))
    assert [int(x) for x in got] == want
    assert all(x.dtype == torch.int32 for x in got)


@pytest.mark.cuda
def test_k3_k4_match_plain_twins_on_card():
    """K3 and K4 against their twins on every case (the lists
    chip_smoke.py checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 and K4 have no CPU mode")
    for B, N in k3_cases.shapes():
        for shift in k3_cases.shifts(B):
            s, m = (torch.from_numpy(a).cuda()
                    for a in k3_cases.rows(B, N, shift))
            for li in k3_cases.LAST_INDICES:
                h, f = kernels.select_hosts(s, m, li)
                for k in k3_cases.KS:
                    got = kernels.select_topk(s, m, h, f, k)
                    want = tsel.select_topk_batch_plain(s, m, h, f, k)
                    for g, w in zip(got, want):
                        assert torch.equal(g.view(torch.int32)
                                           if g.dtype == torch.float32
                                           else g,
                                           w.view(torch.int32)
                                           if w.dtype == torch.float32
                                           else w), (B, N, shift, li, k)
    for name, c in k4_cases.cases():
        reqs, cap = (torch.from_numpy(a).cuda() for a in (c["reqs"],
                                                          c["cap"]))
        order = (None if c["order"] is None
                 else torch.from_numpy(c["order"]).cuda())
        got = tbin.binpack_ffd(reqs, cap, c["max_bins"], order)
        want = tbin.binpack_ffd_plain(reqs, cap, c["max_bins"], order)
        assert int(got[0]) == int(want[0]), name
        assert torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32)), name
        assert torch.equal(got[2], want[2]), name


# ------------------------------------------------------------ the engines


def _engine_world(world):
    """(JAX encoder, batches of JAX pods, with in-batch affinity)."""
    from fixtures import make_node, make_pod
    from test_torch_affinity import SCENARIOS, _encoder
    from torch_port_helpers import twin_world

    if world in ("random", "random-affinity"):
        jenc, _, jpods, _ = twin_world(
            41 if world == "random" else 42, n_pending=96,
            with_affinity=world == "random-affinity")
        return jenc, [jpods[0:32], jpods[32:64], jpods[64:96]], False
    if world == "tight":
        from kubernetes_tpu.codec import SnapshotEncoder

        enc = SnapshotEncoder()
        for i in range(6):
            enc.add_node(make_node(f"n{i}", cpu="2", mem="8Gi", pods=6,
                                   labels={"disk": "ssd" if i % 2
                                           else "hdd"}))
        enc.add_spread_selector("default", {"app": "w"})
        rng = np.random.default_rng(2003)
        pods = [make_pod(f"p{i}", cpu=f"{int(rng.integers(3, 14)) * 100}m",
                         labels={"app": "w"},
                         node_selector={"disk": "ssd"} if i % 4 == 0
                         else None)
                for i in range(24)]
        return enc, [pods[:12], pods[12:]], False
    nodes, batches, _ = SCENARIOS[world]()
    return _encoder(nodes), batches, True


def _chain_quality(world, engine, k=3):
    """Both packages' engines with quality_topk=k over a world's batches,
    each chaining its own state; every batch's winners, committed columns
    and the three top-k leaves compared bit for bit, and the port's
    winners with quality off.  Returns the redos."""
    from kubernetes_tpu.models import batched as jb
    from kubernetes_tpu.models.speculative import (
        make_speculative_scheduler as jspec,
    )
    from kubernetes_tpu_torch.codec.schema import (
        cluster_to_torch,
        pods_to_torch,
        ports_to_torch,
    )
    from kubernetes_tpu_torch.models.batched import (
        make_sequential_scheduler as pseq,
    )
    from kubernetes_tpu_torch.models.speculative import (
        make_speculative_scheduler as pspec,
    )
    from torch_port_helpers import engine_keys

    enc, batches, with_aff = _engine_world(world)
    jmake, pmake = ((jb.make_sequential_scheduler, pseq)
                    if engine == "sequential" else (jspec, pspec))
    kw = engine_keys(enc)
    jfn = jmake(**kw, quality_topk=k)
    pfn = pmake(device="cpu", quality_topk=k, **kw)
    poff = pmake(device="cpu", **kw)
    assert pfn.quality_topk == k and poff.quality_topk == 0
    jstate = enc.snapshot()
    pstate = cluster_to_torch(jstate, "cpu")
    last, redos = 0, 0
    for pods in batches:
        aff = jb.encode_batch_affinity(enc, pods) if with_aff else None
        b = enc.encode_pods(pods)
        ports = jb.encode_batch_ports(enc, pods)
        tb, tp = pods_to_torch(b, "cpu"), ports_to_torch(ports, "cpu")
        h_off, _ = poff(pstate, tb, tp, last, aff_state=aff)
        jh, jstate, jq = jfn(jstate, b, ports, np.int32(last),
                             aff_state=aff)
        th, pstate, tq = pfn(pstate, tb, tp, last, aff_state=aff)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(h_off.numpy(), th.numpy())
        np.testing.assert_array_equal(np.asarray(jstate.requested),
                                      pstate.requested.numpy())
        _assert_topk_equal(jq, tq, f"{world} {engine} batch at {last}")
        assert tq.top_nodes.shape == (b.req.shape[0],
                                      min(k, pstate.n_nodes))
        placed = th >= 0
        assert torch.equal(tq.top_nodes[placed, 0], th[placed])
        if engine == "speculative":
            redos += int(pfn.last_redo)
            assert pfn.last_redo == bool(np.asarray(jfn.last_redo))
        last += len(pods)
    return redos


@pytest.mark.parametrize("engine", ["sequential", "speculative"])
@pytest.mark.parametrize("world", ["random", "random-affinity", "tight",
                                   "chain", "random1", "spreads"])
def test_engines_quality_identical(world, engine):
    """Both engines with quality_topk=3 against the JAX engines: plain
    and node-affinity worlds, in-batch affinity, and a tight cluster whose
    batches the hybrid check redoes (then the sequential engine's top-k
    is returned)."""
    redos = _chain_quality(world, engine)
    if world == "tight" and engine == "speculative":
        assert redos > 0


@pytest.mark.parametrize("k", [1, 8])
def test_engines_quality_other_widths(k):
    """K=1 (the winner only) and K=8 past a 6-node cluster (clamped)."""
    for engine in ("sequential", "speculative"):
        _chain_quality("tight", engine, k)


# ------------------------------------------------------ the live Scheduler

LIVE_CASES = [
    # (n_nodes, n_pods, batch, workload, engine, batched, pipeline,
    #  existing, nominated, node_pods): cases of tests/test_torch_live.py
    (200, 500, 64, "plain", "speculative", True, True, 0, 0, 110),
    (200, 400, 128, "plain", "sequential", False, False, 0, 0, 110),
    (160, 400, 64, "node-affinity", "speculative", True, True, 0, 0, 110),
    (160, 400, 64, "pod-anti-affinity", "speculative", True, True, 100, 0,
     110),
    (150, 360, 64, "plain", "speculative", True, True, 0, 0, 2),
    (200, 500, 64, "plain", "sequential", True, False, 0, 24, 110),
]


@functools.lru_cache(maxsize=None)
def _jax_live_quality(case, interval=1):
    from make_torch_golden import jax_live

    (n_nodes, n_pods, batch, workload, engine, batched, pipeline, existing,
     nominated, node_pods) = case
    hosts, order, unsched, requested, sched = jax_live(
        n_nodes, n_pods, batch, workload, engine, batched, pipeline,
        existing, nominated, node_pods, quality_top_k=3,
        quality_interval_cycles=interval)
    return (hosts, order, unsched, requested,
            loop.quality_arrays(sched.quality_record),
            sched.quality.summary())


def _port_live(case, quality_top_k=3, interval=1):
    (n_nodes, n_pods, batch, workload, engine, batched, pipeline, existing,
     nominated, node_pods) = case
    return loop.run_live(
        loop.bench_nodes(n_nodes, node_pods), n_pods, batch, workload,
        device="cpu", engine=engine, batched=batched, pipeline=pipeline,
        existing=existing,
        nominations=loop.nominated_preemptors(n_nodes, nominated),
        quality_top_k=quality_top_k, quality_interval_cycles=interval)


def _same_arrays(want: dict, got: dict):
    assert set(want) == set(got)
    for k, w in want.items():
        g = got[k]
        assert w.dtype == g.dtype, k
        if w.dtype == np.float32:
            w, g = w.view(np.int32), g.view(np.int32)
        np.testing.assert_array_equal(w, g, err_msg=k)


@pytest.mark.parametrize(
    "case", LIVE_CASES,
    ids=["-".join(str(x) for x in (c[3], c[4], "pipe" if c[6] else "sync",
                                   f"ex{c[7]}", f"nom{c[8]}",
                                   f"slots{c[9]}"))
         for c in LIVE_CASES])
def test_live_quality_matches_jax_scheduler(case):
    """quality_top_k=3, a regret sample every cycle: the bindings and
    their order, every cycle's top-k leaves, the regret samples and the
    margin and feasible p50s equal the JAX Scheduler's."""
    hosts, order, unsched, requested, qarr, summary = _jax_live_quality(case)
    res = _port_live(case)
    np.testing.assert_array_equal(res["hosts"], hosts)
    np.testing.assert_array_equal(res["bind_order"], order)
    assert res["unschedulable_pods"] == unsched
    np.testing.assert_array_equal(res["requested"], requested)
    _same_arrays(qarr, loop.quality_arrays(res["quality_record"]))
    got = res["quality"]
    for key in ("cycles", "decisions", "regret", "regret_samples"):
        assert got[key] == summary[key], key
    assert got["margin"] == summary["margin"]
    assert got["feasible"] == summary["feasible"]
    assert got["regret_dropped"] == 0 and got["regret_samples"] > 0
    assert res["quality_seconds"] > 0


def test_live_quality_with_thirteen_extended_resources():
    """13 extended resource names on every node grow the resource axis to
    32 columns (past K4's register rows): the bindings, every cycle's
    top-k leaves and the regret samples (one a cycle) equal the JAX
    Scheduler's, and none is dropped."""
    from make_torch_golden import jax_live

    hosts, order, _, _, sched = jax_live(
        64, 300, 64, quality_top_k=3, quality_interval_cycles=1,
        extended=13)
    res = loop.run_live(loop.bench_nodes(64, extended=13), 300, 64,
                        device="cpu", quality_top_k=3,
                        quality_interval_cycles=1)
    assert res["scheduler"].cache.encoder.dims.R == 32
    assert sched.cache.encoder.dims.R == 32
    np.testing.assert_array_equal(res["hosts"], hosts)
    np.testing.assert_array_equal(res["bind_order"], order)
    want = loop.quality_arrays(sched.quality_record)
    _same_arrays(want, loop.quality_arrays(res["quality_record"]))
    assert want["regret_cycle"].size > 1
    assert res["quality"]["regret_dropped"] == 0


def test_live_quality_on_off_same_bindings():
    """The observatory is read-only: the same bindings, in the same order,
    with quality on (every cycle sampled) and off, redone batches
    included."""
    for case in (LIVE_CASES[0], LIVE_CASES[4]):
        on, off = _port_live(case), _port_live(case, quality_top_k=0)
        np.testing.assert_array_equal(on["hosts"], off["hosts"])
        np.testing.assert_array_equal(on["bind_order"], off["bind_order"])
        assert "quality" in on and "quality" not in off


def test_live_quality_default_interval():
    """At the default interval (32) the first cycle samples and the next
    due one comes 32 cycles later: one sample over this run's cycles, as
    the JAX Scheduler takes it."""
    case = LIVE_CASES[0]
    want = _jax_live_quality(case, 32)
    res = _port_live(case, interval=32)
    assert res["quality"]["regret_samples"] == 1
    assert res["quality"]["regret"] == want[5]["regret"]
    _same_arrays(want[4], loop.quality_arrays(res["quality_record"]))


def test_default_config_but_three_constructs():
    """The JAX class's defaults, less the three still refused, construct
    on the port with the observatory on at top-k 3."""
    from kubernetes_tpu_torch.runtime.scheduler import (
        Scheduler,
        SchedulerConfig,
        refused_settings,
    )

    cfg = SchedulerConfig(cpu_fallback=False, telemetry=False,
                          timeline=False)
    assert cfg.quality_top_k == 3 and refused_settings(cfg) == []
    sched = Scheduler(config=cfg, device="cpu")
    assert sched.quality is not None and sched.quality.top_k == 3
    assert sched.quality.interval_cycles == 32
    assert tqual.get_default() is sched.quality
    assert sched._schedule_fn.quality_topk == 3
    assert sched._speculative_fn.quality_topk == 3


def test_regret_fault_is_counted_not_raised(monkeypatch):
    """A side launch that faults costs its sample, counted in
    regret_dropped; the cycles commit and the bindings are the same."""
    calls = []

    def boom(*a):
        calls.append(1)
        raise RuntimeError("injected regret fault")

    monkeypatch.setattr(tqual, "_ffd_counterfactual", boom)
    case = LIVE_CASES[0]
    res = _port_live(case)
    assert calls and res["quality"]["regret_dropped"] == len(calls)
    assert res["quality"]["regret_samples"] == 0
    np.testing.assert_array_equal(res["hosts"], _jax_live_quality(case)[0])


def test_live_quality_golden_file():
    """The full-width golden chip_smoke.py phase 14 reads: every pod bound
    in a recorded order, every cycle's top-k with the winner in column 0,
    a regret sample every cycle."""
    from make_torch_golden import live_golden_path

    data = np.load(live_golden_path(quality=3))
    assert int(data["nodes"]) == 5000 and int(data["batch"]) == 2048
    assert int(data["pods"]) == 10000 and int(data["top_k"]) == 3
    assert int(data["interval"]) == 1
    hosts, order = data["hosts"], data["bind_order"]
    assert (hosts >= 0).all() and sorted(order.tolist()) == list(range(12048))
    assert int(data["cycle_pods"].sum()) == 12048
    assert data["top_nodes"].shape == (12048, 3)
    # winners in bind order: cycle by cycle, each cycle's pods in order
    placed = data["top_nodes"][:, 0]
    np.testing.assert_array_equal(np.sort(placed), np.sort(hosts))
    assert len(data["regret_cycle"]) == len(data["cycle_pods"])
    assert (data["regret_ffd_nodes"] > 0).all()
    ref = np.load(live_golden_path())
    np.testing.assert_array_equal(ref["hosts"], hosts)
    np.testing.assert_array_equal(ref["bind_order"], order)
