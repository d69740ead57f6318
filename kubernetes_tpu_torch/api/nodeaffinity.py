"""Host-side matching helpers copied from the JAX package's cpuref.

The port's own copies of two helpers of kubernetes_tpu/cpuref/reference.py,
kept here so the port never imports the reference package:
`match_node_selector_term` (the encoder evaluates PersistentVolume node
affinity with it) and `_term_matches_pod` (models/batched.py
encode_nominated_block evaluates nominated pods' anti-affinity with it).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import labels as klabels
from kubernetes_tpu_torch.api.types import Node, Pod


def match_node_selector_term(pod_term, node: Node) -> bool:
    """ref v1helper.MatchNodeSelectorTerms: AND of matchExpressions (as label
    requirements) and matchFields (metadata.name); a term with an invalid
    label value never matches (NodeSelectorRequirementsAsSelector error)."""
    for expr in pod_term.match_expressions:
        if klabels.requirement_is_unbuildable(
            expr.key, expr.operator, expr.values
        ):
            return False
        req = klabels.Requirement(expr.key, expr.operator, tuple(expr.values))
        if not req.matches(node.labels):
            return False
    for expr in pod_term.match_fields:
        fields = {"metadata.name": node.name}
        req = klabels.Requirement(expr.key, expr.operator, tuple(expr.values))
        if not req.matches(fields):
            return False
    return bool(pod_term.match_expressions or pod_term.match_fields)


def _term_namespaces(term, pod: Pod):
    return set(term.namespaces) if term.namespaces else {pod.namespace}


def _term_matches_pod(term, src_pod: Pod, dst_pod: Pod) -> bool:
    """Does `term` (belonging to src_pod) select dst_pod?
    ref predicates.go podMatchesPodAffinityTerms."""
    if dst_pod.namespace not in _term_namespaces(term, src_pod):
        return False
    sel = klabels.selector_from_label_selector(term.label_selector)
    if sel is None:
        return False
    return sel.matches(dst_pod.labels)
