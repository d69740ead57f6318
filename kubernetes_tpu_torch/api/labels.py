"""Label selectors.

Reference: staging/src/k8s.io/apimachinery/pkg/labels (Requirement/Selector)
and staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go (LabelSelector
with MatchLabels + MatchExpressions).  Operators: In, NotIn, Exists,
DoesNotExist, Gt, Lt — the same set node-affinity terms use
(pkg/apis/core/types.go NodeSelectorOperator).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence

IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

OPERATORS = (IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT)


@dataclass(frozen=True)
class Requirement:
    key: str
    operator: str
    values: tuple = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.operator == IN:
            return has and labels[self.key] in self.values
        if self.operator == NOT_IN:
            # ref labels.Requirement.Matches: NotIn matches when the key is
            # absent OR the value is not in the set.
            return not has or labels[self.key] not in self.values
        if self.operator == EXISTS:
            return has
        if self.operator == DOES_NOT_EXIST:
            return not has
        if self.operator in (GT, LT):
            if not has:
                return False
            try:
                lhs = int(labels[self.key])
                rhs = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if self.operator == GT else lhs < rhs
        raise ValueError(f"unknown operator {self.operator!r}")


@dataclass(frozen=True)
class Selector:
    """Conjunction of requirements. Empty selector matches everything;
    a None selector (absent) matches nothing — mirroring
    metav1.LabelSelectorAsSelector semantics."""

    requirements: tuple = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        return all(r.matches(labels) for r in self.requirements)

    @property
    def keys(self) -> List[str]:
        return [r.key for r in self.requirements]


def selector_from_match_labels(match_labels: Mapping[str, str]) -> Selector:
    """A plain map selector (Service.spec.selector, RC.spec.selector)."""
    return Selector(
        tuple(Requirement(k, IN, (v,)) for k, v in sorted(match_labels.items()))
    )


def selector_from_label_selector(ls: Optional[dict]) -> Optional[Selector]:
    """metav1.LabelSelector {matchLabels, matchExpressions} -> Selector.

    Returns None for a None input (matches nothing), and an empty Selector for
    an empty LabelSelector (matches everything) — ref
    apimachinery/pkg/apis/meta/v1/helpers.go LabelSelectorAsSelector.
    """
    if ls is None:
        return None
    reqs: List[Requirement] = []
    for k, v in sorted((ls.get("matchLabels") or {}).items()):
        reqs.append(Requirement(k, IN, (v,)))
    for expr in ls.get("matchExpressions") or []:
        reqs.append(
            Requirement(
                expr["key"], expr["operator"], tuple(expr.get("values") or ())
            )
        )
    return Selector(tuple(reqs))

def parse_selector(s: str) -> Selector:
    """labels.Parse string grammar (apimachinery/pkg/labels/selector.go):
    comma-separated terms ``k=v`` / ``k==v`` / ``k!=v`` / ``k`` (exists)
    / ``!k`` (not exists) / ``k in (a,b)`` / ``k notin (a,b)``.
    Malformed terms raise ValueError (HTTP 400 at the REST layer)."""
    import re

    reqs: List[Requirement] = []
    # split on commas NOT inside parentheses (the in/notin value sets)
    terms = re.split(r",(?![^()]*\))", s)
    for term in terms:
        term = term.strip()
        if not term:
            continue
        m = re.fullmatch(
            r"(?P<key>[^\s!=,()]+)\s+(?P<op>in|notin)\s+"
            r"\((?P<vals>[^)]*)\)", term)
        if m:
            vals = tuple(v.strip() for v in m.group("vals").split(",")
                         if v.strip())
            reqs.append(Requirement(
                m.group("key"), IN if m.group("op") == "in" else NOT_IN,
                vals))
            continue
        if term.startswith("!"):
            reqs.append(Requirement(term[1:].strip(), DOES_NOT_EXIST))
            continue
        if "!=" in term:
            k, _, v = term.partition("!=")
            reqs.append(Requirement(k.strip(), NOT_IN, (v.strip(),)))
            continue
        if "==" in term:
            k, _, v = term.partition("==")
            reqs.append(Requirement(k.strip(), IN, (v.strip(),)))
            continue
        if "=" in term:
            k, _, v = term.partition("=")
            reqs.append(Requirement(k.strip(), IN, (v.strip(),)))
            continue
        if re.fullmatch(r"[^\s!=,()]+", term):
            reqs.append(Requirement(term, EXISTS))
            continue
        raise ValueError(f"invalid label selector term {term!r}")
    return Selector(tuple(reqs))


import re as _re

_LABEL_VALUE_RE = _re.compile(r"(([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9])?")
_QUAL_NAME_RE = _re.compile(r"([A-Za-z0-9][-A-Za-z0-9_.]*)?[A-Za-z0-9]")
_SUBDOMAIN_RE = _re.compile(
    r"[a-z0-9]([-a-z0-9]*[a-z0-9])?(\.[a-z0-9]([-a-z0-9]*[a-z0-9])?)*"
)


def is_valid_label_value(v: str) -> bool:
    """apimachinery validation.IsValidLabelValue: <= 63 chars, empty OK,
    else alphanumeric at the ends, [-_.alnum] in the middle."""
    return len(v) <= 63 and bool(_LABEL_VALUE_RE.fullmatch(v))


def is_valid_label_key(k: str) -> bool:
    """validation.IsQualifiedName: optional dns-1123-subdomain prefix '/',
    then a <=63-char name."""
    parts = k.split("/")
    if len(parts) == 2:
        prefix, name = parts
        if not prefix or len(prefix) > 253 or not _SUBDOMAIN_RE.fullmatch(prefix):
            return False
    elif len(parts) == 1:
        name = parts[0]
    else:
        return False
    return 0 < len(name) <= 63 and bool(_QUAL_NAME_RE.fullmatch(name))


def requirement_is_unbuildable(key: str, op: str, values) -> bool:
    """labels.NewRequirement error cases for NodeSelector matchExpressions —
    any of these makes NodeSelectorRequirementsAsSelector error, so the
    containing TERM never matches (v1helper.MatchNodeSelectorTerms skips
    it).  matchFields are exempt (NodeSelectorRequirementsAsFieldSelector
    does not validate label syntax):
      * invalid label key (any operator)
      * In/NotIn with zero values or any invalid value
      * Exists/DoesNotExist with values
      * Gt/Lt with a value count other than one"""
    values = list(values)
    if not is_valid_label_key(key):
        return True
    if op in (IN, NOT_IN):
        return not values or any(
            not is_valid_label_value(v) for v in values
        )
    if op in (EXISTS, DOES_NOT_EXIST):
        return bool(values)
    if op in (GT, LT):
        return len(values) != 1
    return False
