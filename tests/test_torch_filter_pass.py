"""Kernel K11 (kernels/filter_pass.cu) and its plain twin, on the CPU.

The twin (ops/predicates.py filter_batch_plain, predicate_stack_plain) is
held bit for bit against the jitted JAX filter_batch and first_failure on
every kernels/k11_cases.py case and on one batch the port's encoder makes
from the bench fleet: the mask, the stack and the first failure.  The
dispatch sends CPU tensors to the twin; the wrapper refuses CPU tensors.
The kernel itself is held to the twin on the card by
tests/test_torch_passes_cuda.py and chip_smoke.py.  Tolerance: none.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.codec import schema as jschema
from kubernetes_tpu.ops import predicates as jpred
from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.codec import schema as tschema
from kubernetes_tpu_torch.kernels import k11_cases
from kubernetes_tpu_torch.ops import predicates as tpred

import torch_port_helpers  # noqa: F401  (caps torch's threads)

CASES = k11_cases.cases()


def jax_inputs(case):
    """The case as the JAX package's dataclasses and FilterConfig."""
    ct = jschema.ClusterTensors(**{k: jnp.asarray(v)
                                   for k, v in case["cluster"].items()})
    pb = jschema.PodBatch(**{k: jnp.asarray(v)
                             for k, v in case["pods"].items()})
    return ct, pb, jschema.FilterConfig(**case["cfg"])


def port_inputs(case, device="cpu"):
    ct = tschema.ClusterTensors(**{k: torch.from_numpy(np.array(v))
                                   for k, v in case["cluster"].items()})
    pb = tschema.PodBatch(**{k: torch.from_numpy(np.array(v))
                             for k, v in case["pods"].items()})
    return (tschema.cluster_to_torch(ct, device),
            tschema.pods_to_torch(pb, device),
            tschema.FilterConfig(**case["cfg"]))


def jax_filter(case):
    ct, pb, cfg = jax_inputs(case)
    key = case["unsched_key"]
    mask, stack = jax.jit(
        lambda c, p: jpred.filter_batch(c, p, cfg, key))(ct, pb)
    failure = jax.jit(jpred.first_failure)(stack)
    return np.asarray(mask), np.asarray(stack), np.asarray(failure)


def assert_twin_matches_jax(case):
    want_mask, want_stack, want_fail = jax_filter(case)
    ct, pb, cfg = port_inputs(case)
    key = case["unsched_key"]
    mask, stack = tpred.filter_batch_plain(ct, pb, cfg, key)
    np.testing.assert_array_equal(stack.numpy(), want_stack)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(tpred.first_failure(stack).numpy(),
                                  want_fail)
    hot, none = tpred.filter_batch_plain(ct, pb, cfg, key, need_per=False)
    assert none is None
    np.testing.assert_array_equal(hot.numpy(), want_mask)
    np.testing.assert_array_equal(
        tpred.predicate_stack_plain(ct, pb, cfg, key).numpy(), want_stack)


@pytest.mark.parametrize("name", [n for n, _ in CASES])
def test_twin_matches_jax_on_k11_case(name):
    assert_twin_matches_jax(dict(CASES)[name])


def _bench_case(n_pods=6):
    """One batch the port's encoder makes from the bench fleet (20 spread
    selectors, 1 node in 50 tainted), at 250 nodes."""
    from kubernetes_tpu_torch import loop

    nodes = loop.bench_nodes(250)
    enc = loop.build_encoder(nodes)
    pods = [loop.pending_pod(i) for i in range(n_pods)]
    pb = enc.encode_pods(pods)
    ct = enc.snapshot()
    key = enc.interner.intern("node.kubernetes.io/unschedulable")

    def as_np(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    return {"cluster": as_np(ct), "pods": as_np(pb), "cfg": {},
            "unsched_key": key, "zone_key": enc.getzone_key}


def test_twin_matches_jax_on_the_bench_fleet():
    case = _bench_case()
    assert (case["cluster"]["taint_effect"] >= 0).any()
    assert_twin_matches_jax(case)


def test_k11_cases_cover_their_corners():
    names = dict(CASES)
    assert any(c["cluster"]["valid"].shape[0] % 4 for c in names.values())
    aff = names["affinity-b9-n66"]["pods"]
    assert aff["aff_term_pairs"].shape[-1] == \
        names["affinity-b9-n66"]["cluster"]["topo_pairs"].shape[-1]
    assert names["csi-drivers"]["pods"]["new_vol_counts"].shape[1] == 8
    assert names["selector-lean-s0"]["pods"]["expr_key"].shape[1] == 0
    assert not names["padding-rows"]["cluster"]["valid"][50:].any()
    ops = np.concatenate([c["pods"]["expr_op"].ravel()
                          for c in names.values()])
    assert set(range(7)) <= set(ops.tolist())
    nums = np.concatenate([c["cluster"]["label_nums"].ravel()
                           for c in names.values()])
    assert np.isnan(nums).any() and np.isinf(nums).any()


def test_cpu_tensors_take_the_twin(monkeypatch):
    """filter_batch, predicate_stack: CPU tensors never reach the kernel."""
    def refuse(*a, **k):
        raise AssertionError("the kernel wrapper was called on the CPU")

    monkeypatch.setattr(kernels, "filter_pass", refuse)
    monkeypatch.setattr(kernels, "fold_predicates", refuse)
    case = dict(CASES)["affinity-b9-n66"]
    ct, pb, cfg = port_inputs(case)
    key = case["unsched_key"]
    want_mask, want_stack = tpred.filter_batch_plain(ct, pb, cfg, key)
    mask, stack = tpred.filter_batch(ct, pb, cfg, key)
    assert torch.equal(mask, want_mask) and torch.equal(stack, want_stack)
    mask2, none = tpred.filter_batch(ct, pb, cfg, key, need_per=False)
    assert none is None and torch.equal(mask2, want_mask)
    assert torch.equal(tpred.predicate_stack(ct, pb, cfg, key), want_stack)


def test_pair_hits_are_the_twins_products():
    """pair_hits' rows are the incidence products the twin takes."""
    case = dict(CASES)["affinity-b9-n66"]
    ct, pb, _ = port_inputs(case)
    hits, offs = tpred.pair_hits(ct, pb)
    topo_t = ct.topo_pairs.T
    B, N = pb.n_pods, ct.n_nodes
    assert hits.shape == (B, 1 + 2 + 2 + 2 + 2 + 2, N)
    np.testing.assert_array_equal(
        (hits[:, offs["forb"]] > 0).numpy(),
        tpred.exact_bool_matmul(pb.forbidden_pairs, topo_t).numpy())
    np.testing.assert_array_equal(
        (hits[:, offs["vb"]:offs["vb"] + 2] > 0).numpy(),
        tpred.exact_bool_matmul(pb.vol_bind_pairs, topo_t).numpy())
    lean = dict(CASES)["lean-b7-n64"]
    ct, pb, _ = port_inputs(lean)
    assert tpred.pair_hits(ct, pb) == (None, {})


def _c_struct_fields(source: str, struct: str) -> list:
    """The member names of a C struct in a kernel source, in order."""
    import os
    import re

    path = os.path.join(os.path.dirname(kernels.__file__), source)
    with open(path) as f:
        text = f.read()
    body = text[text.index(f"struct {struct} {{"):]
    body = re.sub(r"//[^\n]*", "", body[body.index("{") + 1:body.index("};")])
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[[^\]]*\]", "", decl).replace("*", " ").strip()
        if decl:
            head, _, rest = re.sub(r"^const\s+", "", decl).partition(" ")
            names += [n.strip() for n in rest.split(",")]
    return names


@pytest.mark.parametrize("source,cls", [
    ("filter_pass.cu", kernels.FilterPassArgs),
    ("score_pass.cu", kernels.ScorePassArgs),
])
def test_args_struct_mirrors_the_c_struct(source, cls):
    """The ctypes struct passed by value has the C struct's members in the
    C struct's order (a pointer each, then the sizes and flags)."""
    assert [f[0] for f in cls._fields_] == _c_struct_fields(
        source, cls.__name__)


def test_k11_wrapper_refuses_cpu_tensors():
    case = dict(CASES)["lean-b1-n5"]
    ct, pb, cfg = port_inputs(case)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.filter_pass(ct, pb, cfg, 0, None, {}, False)


def chip_smoke_module():
    """chip_smoke.py at the repo root, imported as a module (its phases
    run only when it is executed)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_k11_bound_counts_the_entries_in_use():
    """chip_smoke.py's K11 bound counts what these inputs need: mask mode
    skips padding pairs and stops a pair's walk at its first failure, so
    it counts fewer operations than stack mode; a nodeSelector key costs
    one compare a label slot in use on each node and one for its value;
    a pod with no port, disk id or toleration costs nothing for them."""
    cs = chip_smoke_module()
    case = _bench_case(n_pods=2)       # pod 0 has a nodeSelector key
    ct, pb, cfg = port_inputs(case)
    rows = tpred.predicate_stack_plain(ct, pb, cfg, case["unsched_key"])
    stack = cs._k11_bound(ct, pb, cfg, True)
    mask = cs._k11_bound(ct, pb, cfg, False, rows)
    assert 0 < mask["int_ops"] < stack["int_ops"]
    assert 0 < mask["f32_ops"] < stack["f32_ops"]
    costs = cs._k11_costs(ct, pb, cfg, {})
    N = ct.n_nodes
    pod = [torch.zeros((2, N), dtype=torch.bool) for _ in range(2)]
    pod[0][0], pod[1][1] = True, True
    selector = [cs._charge(costs[5][0], p) for p in pod]
    in_use = int((ct.label_keys != tschema.PAD).sum())
    assert selector[0] - selector[1] == in_use + N
    for k in (4, 7):                    # ports, disks: the verdict alone
        assert cs._charge(costs[k][0], pod[0]) == N
