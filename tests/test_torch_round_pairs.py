"""The node-pair table, the pair gather and kernel K16 (round_pairs.cu)'s
plain twin, on the CPU.

A node carries at most one value for each label key, so for each
topology key it lies in at most one topology pair: the table's twin
(ops/predicates.py node_pair_table_plain) is held to the topology itself
on the encoder's fleets (nodes without a key, several keys) and refuses a
node in two pairs of one key, as the snapshot layer's host check does;
the snapshot layer makes it once a snapshot upload; the gather over it
(_gather here, what K11 and K12 compute) equals the pair products the
twins take (pair_hits and the IPA product) bit for bit.  K16's twin (models/speculative.py
round_pairs_plain, the pair commit of a round and the next bootstrap
gate) is held to a loop over the accepted pods and their terms on every
kernels/k16_cases.py case.  The kernels themselves are held to the twins
on the card by tests/test_torch_passes_cuda.py,
tests/test_torch_scan_cuda.py and chip_smoke.py.  Tolerance: none.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.api.factory import make_node, make_pod
from kubernetes_tpu_torch.codec import schema as ts
from kubernetes_tpu_torch.codec.transfer import DeviceSnapshotCache
from kubernetes_tpu_torch.kernels import k11_cases, k14_cases, k16_cases
from kubernetes_tpu_torch.loop import bench_nodes, build_encoder
from kubernetes_tpu_torch.models.speculative import round_pairs_plain
from kubernetes_tpu_torch.ops import predicates as tpred

from test_torch_filter_pass import _c_struct_fields
from torch_port_helpers import process_state_kept

K16_CASES = k16_cases.cases()


@pytest.fixture(autouse=True)
def _process_state():
    with process_state_kept():
        yield


def _snapshot(nodes, topology_keys=()):
    enc = build_encoder(nodes)
    for key in topology_keys:
        enc.register_topology_key(key)
    return ts.cluster_to_torch(enc.snapshot(), "cpu")


def _check_table(ct):
    """The table against the topology, pair by pair."""
    got = tpred.node_pair_table_plain(ct.topo_pairs, ct.pair_topo_key)
    topo, ptk = ct.topo_pairs.numpy(), ct.pair_topo_key.numpy()
    keys = sorted(set(ptk[ptk != ts.PAD].tolist()))
    assert got.keys.tolist() == keys
    want = np.full((topo.shape[0], max(len(keys), 1)), -1, np.int32)
    for n, p in zip(*np.nonzero(topo)):
        want[n, keys.index(ptk[p])] = p
    np.testing.assert_array_equal(got.table.numpy(), want)
    return got


def test_node_pair_table_on_the_encoders_fleets():
    """The bench fleet (zone and hostname keys), a fleet where some nodes
    have no zone label, and one with a rack key registered beside."""
    got = _check_table(_snapshot(bench_nodes(40)))
    # every node has a hostname and a zone pair
    assert int((got.table[:40] >= 0).sum(1).min()) >= 2
    nodes = [make_node(f"n{i}", cpu="4", mem="8Gi",
                       labels=({k14_cases.ZONE: f"z{i % 3}"} if i % 4 else
                               {"rack": f"r{i % 2}"}))
             for i in range(12)]
    got = _check_table(_snapshot(nodes, ("rack",)))
    assert got.table.shape[1] >= 3               # hostname, zone, rack
    assert int((got.table[:12] == -1).sum()) > 0  # nodes without a key


def test_node_pair_table_without_pairs():
    """A snapshot whose nodes lie in no pair gets one column of -1."""
    ct = _snapshot(bench_nodes(8))
    got = tpred.node_pair_table_plain(torch.zeros_like(ct.topo_pairs),
                                      torch.full_like(ct.pair_topo_key,
                                                      ts.PAD))
    assert got.keys.numel() == 0 and got.table.shape == (ct.n_nodes, 1)
    assert bool((got.table == -1).all())


def test_node_pair_table_refuses_two_pairs_of_one_key():
    ct = _snapshot(bench_nodes(8))
    topo = ct.topo_pairs.clone()
    zone_pairs = torch.nonzero(ct.pair_topo_key == ct.pair_topo_key[
        torch.nonzero(topo[0])[0, 0]])[:, 0]
    topo[0, zone_pairs[:2]] = True
    with pytest.raises(ValueError, match="two topology pairs"):
        tpred.node_pair_table_plain(topo, ct.pair_topo_key)
    topo = ct.topo_pairs.clone()
    topo[1, -1] = True                           # a pair with no key
    assert int(ct.pair_topo_key[-1]) == ts.PAD
    with pytest.raises(ValueError, match="no key"):
        tpred.node_pair_table_plain(topo, ct.pair_topo_key)


def test_node_pair_table_is_built_once_a_snapshot():
    """The snapshot layer makes the table: cluster_to_torch at the
    upload, DeviceSnapshotCache.update again when it writes the pair
    tensors, not when it writes other fields; node_pair_table only reads
    it."""
    ct = _snapshot(bench_nodes(8))
    assert tpred.has_node_pairs(ct)
    first = tpred.node_pair_table(ct)
    assert tpred.node_pair_table(ct) is first
    _check_table(ct)
    enc = build_encoder(bench_nodes(8))
    cache = DeviceSnapshotCache("cpu")
    dev = cache.update(enc.snapshot())
    first = tpred.node_pair_table(dev)
    assert torch.equal(first.table, _check_table(dev).table)
    enc.add_pod(make_pod("p0", cpu="500m", mem="512Mi", node_name="n1"))
    dev = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    assert tpred.node_pair_table(dev) is first        # a commit
    for i in range(8, 12):                            # node events
        enc.add_node(make_node(f"x{i}", cpu="4", mem="8Gi",
                               labels={k14_cases.ZONE: f"z{i}"}))
    dev = cache.update(enc.snapshot(), dirty_rows=enc.take_dirty_rows())
    again = tpred.node_pair_table(dev)
    assert again is not first
    assert torch.equal(again.table, _check_table(dev).table)


def test_host_check_refuses_as_the_twin_does():
    """pair_key_slots equals _pair_keys, and check_node_pairs (the
    snapshot layer's check on the host arrays) refuses what the twin
    refuses; the upload keeps the refusal and the read raises it."""
    ct = _snapshot(bench_nodes(8))
    keys, slot = tpred.pair_key_slots(ct.pair_topo_key.numpy())
    want_keys, want_slot = tpred._pair_keys(ct.pair_topo_key)
    assert keys.tolist() == want_keys.tolist()
    assert slot.tolist() == want_slot.tolist()
    tpred.check_node_pairs(ct.topo_pairs.numpy(), slot, keys.size)
    zone = ct.pair_topo_key == ct.pair_topo_key[
        torch.nonzero(ct.topo_pairs[0])[0, 0]]
    two = ct.topo_pairs.clone()
    two[0, torch.nonzero(zone)[:2, 0]] = True
    keyless = ct.topo_pairs.clone()
    keyless[1, -1] = True
    assert int(ct.pair_topo_key[-1]) == ts.PAD
    for topo in (two, keyless):
        with pytest.raises(ValueError, match="two topology pairs"):
            tpred.check_node_pairs(topo.numpy(), slot, keys.size)
        bad = dataclasses.replace(ct, topo_pairs=topo)
        tpred.build_node_pairs(bad)
        with pytest.raises(ValueError, match="two topology pairs"):
            tpred.node_pair_table(bad)
    case = ts.ClusterTensors(**{k: torch.from_numpy(np.array(v)) for k, v in
                                dict(k11_cases.cases())["no-zones"]
                                ["cluster"].items()})
    no_zones = ts.cluster_to_torch(case, "cpu")      # the upload passes
    with pytest.raises(ValueError, match="two topology pairs"):
        tpred.node_pair_table(no_zones)


def test_key_slots():
    keys = torch.tensor([3, 5, 9], dtype=torch.int32)
    ids = torch.tensor([[5, 4], [9, -1]], dtype=torch.int32)
    assert tpred.key_slots(ids, keys).tolist() == [[1, -1], [2, -1]]
    none = tpred.key_slots(ids, keys[:0])
    assert none.tolist() == [[-1, -1], [-1, -1]]


def _gather_cases():
    return ([(n, c) for n, c in k11_cases.cases()
             if n.startswith("affinity-")]
            + [(n, c) for n, c in k14_cases.affinity_cases()
               if not n.startswith("aff-")])


def _gather(rows, table):
    """The gather K11 and K12 make of the pair products, as plain torch:
    rows bool[B, X, TP] or f32 -> f32[B, X, N], the sum over each node's
    pairs (table i32[N, KT]) of the row at that pair, in slot order from
    0.0."""
    rows = rows.to(torch.float32)
    out = torch.zeros(rows.shape[:-1] + (table.shape[0],),
                      dtype=torch.float32)
    for k in range(table.shape[1]):
        p = table[:, k].to(torch.int64)
        out = out + torch.where(p >= 0, rows[..., p.clamp(min=0)], 0.0)
    return out


@pytest.mark.parametrize("name", [n for n, _ in _gather_cases()])
def test_gather_equals_the_pair_products(name):
    """The gather over the node-pair table gives pair_hits' rows and the
    IPA sums bit for bit."""
    case = dict(_gather_cases())[name]
    ct = ts.cluster_to_torch(ts.ClusterTensors(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["cluster"].items()}), "cpu")
    pb = ts.pods_to_torch(ts.PodBatch(**{
        k: torch.from_numpy(np.array(v))
        for k, v in case["pods"].items()}), "cpu")
    table = tpred.node_pair_table(ct).table
    hits, _ = tpred.pair_hits(ct, pb)
    rows, _ = tpred.pair_rows(ct, pb)
    got = _gather(torch.cat(rows, dim=1), table)
    assert torch.equal(got.view(torch.int32), hits.view(torch.int32))
    ipa = pb.pref_pair_weights @ ct.topo_pairs.to(torch.float32).T
    got = _gather(pb.pref_pair_weights[:, None], table)[:, 0]
    assert torch.equal(got.view(torch.int32), ipa.view(torch.int32))


def _loop_pairs(c, hosts, accept, pb, aff, ct, hard_w):
    """K16's function as a loop: each accepted pod j on node h, each pod
    i and each term, one pair a (term, key) at h's pair of the key."""
    topo, ptk = ct.topo_pairs.numpy(), ct.pair_topo_key.numpy()
    u = {k: c[k].numpy().copy() for k in ("uaff", "uanti", "uforb",
                                          "upref")}
    a = {k: getattr(aff, k).numpy() for k in (
        "aff_match", "anti_match", "anti_own", "aff_own", "pref_match",
        "pref_own", "pref_weight", "pref_topo_key")}
    akey = pb.aff_term_topo_key.numpy()
    nkey = pb.anti_term_topo_key.numpy()
    B, PT = akey.shape
    AT, PP = nkey.shape[1], a["pref_weight"].shape[1]
    hw = np.float32(hard_w)
    if accept is not None:
        for j in np.nonzero(accept.numpy())[0]:
            at = {int(ptk[p]): p for p in np.nonzero(topo[hosts[j]])[0]}
            for i in range(B):
                for t in range(PT):
                    p = at.get(int(akey[i, t]))
                    if a["aff_match"][j, i, t] and p is not None:
                        u["uaff"][i, t, p] = True
                    p = at.get(int(akey[j, t]))
                    if a["aff_own"][j, t, i] and p is not None:
                        u["upref"][i, p] += hw
                for t in range(AT):
                    p = at.get(int(nkey[i, t]))
                    if a["anti_match"][j, i, t] and p is not None:
                        u["uanti"][i, t, p] = True
                    p = at.get(int(nkey[j, t]))
                    if a["anti_own"][j, t, i] and p is not None:
                        u["uforb"][i, p] = True
                for t in range(PP):
                    p = at.get(int(a["pref_topo_key"][i, t]))
                    if a["pref_match"][j, i, t] and p is not None:
                        u["upref"][i, p] += a["pref_weight"][i, t]
                    p = at.get(int(a["pref_topo_key"][j, t]))
                    if a["pref_own"][j, t, i] and p is not None:
                        u["upref"][i, p] += a["pref_weight"][j, t]
    active = c["active"].numpy()
    self_ = pb.aff_term_self.numpy().copy()
    for i in range(B):
        for t in range(PT):
            if any(active[j] and a["aff_match"][j, i, t] for j in range(i)):
                self_[i, t] = False
    u["self"] = self_
    return u


@pytest.mark.parametrize("commit", [True, False])
@pytest.mark.parametrize("name", [n for n, _ in K16_CASES])
def test_twin_matches_a_loop_on_k16_case(name, commit):
    ct, pb, aff, c, hosts, accept, hard_w = k16_cases.round_state(
        dict(K16_CASES)[name])
    if not commit:
        hosts = accept = None
    got = round_pairs_plain(c, hosts, accept, pb, aff, ct, hard_w)
    want = _loop_pairs(c, hosts, accept, pb, aff, ct, hard_w)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_k16_cases_cover_their_corners():
    accepted = [int(c["round"]["accept"].sum()) for _, c in K16_CASES]
    valid = [int(c["pods"]["valid"].sum()) for _, c in K16_CASES]
    assert 0 in accepted and any(a == v for a, v in zip(accepted, valid))
    shared = [len(set(c["round"]["hosts"][c["round"]["accept"]].tolist()))
              < int(c["round"]["accept"].sum()) for _, c in K16_CASES]
    assert any(shared)
    assert any(c["cfg"].get("hard_pod_affinity_weight", 1.0) != 1.0
               for _, c in K16_CASES)
    # a preferred term on a key no node has
    assert any((c["aff"]["pref_topo_key"] == 8).any() for _, c in K16_CASES)


def test_args_struct_mirrors_the_c_struct():
    assert [f[0] for f in kernels.RoundPairsArgs._fields_] == \
        _c_struct_fields("round_pairs.cu", "RoundPairsArgs")


def test_wrappers_refuse_cpu_tensors():
    ct, pb, aff, c, hosts, accept, hard_w = k16_cases.round_state(
        K16_CASES[0][1])
    with pytest.raises(ValueError, match="CUDA"):
        kernels.round_pairs(c, hosts, accept, pb, aff,
                            tpred.batch_pairs(ct, pb, aff.pref_topo_key),
                            hard_w)
    keys, slot = tpred._pair_keys(ct.pair_topo_key)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.node_pair_build(ct.topo_pairs, slot, keys.numel())
