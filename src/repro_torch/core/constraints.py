"""Denial constraints.

The paper cleans violations of denial constraints (DCs):

    forall t1..tk  NOT (p1 AND p2 ... AND pm)

Two families are treated specially, as in the paper:

* **FD** ``X -> Y`` (the equality special case; Example 1, §4.1).  ``X`` may be
  multi-attribute, ``Y`` is a single attribute (wider FDs decompose, §4.1).
* **General binary DCs** with order predicates between two tuples, e.g.
  Example 4's  ``NOT (t1.salary < t2.salary AND t1.tax > t2.tax)`` (§4.2).
  Each atom relates attribute ``left`` of t1 with attribute ``right`` of t2
  via an operator; in the paper's evaluation (and ours) ``left == right``
  ("conditions over the same attribute", §4.2 — following BigDansing).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

OPS = ("==", "!=", "<", "<=", ">", ">=")

_INVERT = {"==": "!=", "!=": "==", "<": ">=", "<=": ">", ">": "<=", ">=": "<"}
_FLIP = {"==": "==", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}


def invert_op(op: str) -> str:
    """Negation: NOT(a op b) == a invert_op(op) b."""
    return _INVERT[op]


def flip_op(op: str) -> str:
    """Commutation: a op b == b flip_op(op) a."""
    return _FLIP[op]


@dataclasses.dataclass(frozen=True)
class FD:
    """Functional dependency lhs -> rhs."""

    name: str
    lhs: Tuple[str, ...]
    rhs: str

    def __init__(self, name: str, lhs, rhs: str):
        if isinstance(lhs, str):
            lhs = (lhs,)
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "lhs", tuple(lhs))
        object.__setattr__(self, "rhs", rhs)

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.lhs + (self.rhs,)


@dataclasses.dataclass(frozen=True)
class Atom:
    """One predicate of a binary DC: t1.left  op  t2.right."""

    left: str
    op: str
    right: str

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"bad op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class DC:
    """Binary denial constraint NOT(atom1 AND atom2 AND ...)."""

    name: str
    atoms: Tuple[Atom, ...]

    def __init__(self, name: str, atoms: Sequence[Atom]):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "atoms", tuple(atoms))

    @property
    def attrs(self) -> Tuple[str, ...]:
        seen = []
        for a in self.atoms:
            for c in (a.left, a.right):
                if c not in seen:
                    seen.append(c)
        return tuple(seen)


def fd_as_dc(fd: FD) -> DC:
    """An FD X->Y is the DC NOT(t1.X == t2.X AND t1.Y != t2.Y)."""
    atoms = [Atom(a, "==", a) for a in fd.lhs] + [Atom(fd.rhs, "!=", fd.rhs)]
    return DC(fd.name, atoms)


def rule_attrs(rule) -> Tuple[str, ...]:
    if isinstance(rule, FD):
        return rule.attrs
    return rule.attrs


def equality_key_attrs(rule) -> Tuple[str, ...]:
    """Attributes usable as a shard-routing key for distributed detection
    (DESIGN.md §8): every violating pair agrees on them, so hash-routing
    rows by their combined value puts all of a row's potential partners on
    the same shard.

    FDs always key on the lhs.  A general DC contributes an attribute per
    equality atom over the *same* attribute on both sides (``t1.a == t2.a``
    — the paper's "conditions over the same attribute", §4.2); an equality
    atom across two different attributes gives each role a different
    routing key and is not shardable this way.  Empty result means the
    rule has no equality key and sharded detection must fall back to the
    dense scan.
    """
    if isinstance(rule, FD):
        return rule.lhs
    return tuple(
        a.left for a in rule.atoms if a.op == "==" and a.left == a.right
    )


def overlaps_query(rule, query_attrs: Sequence[str]) -> bool:
    """Paper §4.1: a rule affects a query iff (X u Y) n (P u W) != {} ."""
    return bool(set(rule_attrs(rule)) & set(query_attrs))
