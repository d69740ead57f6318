"""NodeSelectorTerm matching against one node, on the host.

The port's own copy of the JAX package's cpuref helper of the same name
(kubernetes_tpu/cpuref/reference.py), kept here so the encoder can evaluate
PersistentVolume node affinity without importing the reference package.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api import labels as klabels
from kubernetes_tpu_torch.api.types import Node


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
