"""Predicate pushdown domain model.

Reference blueprint: core/trino-spi/src/main/java/io/trino/spi/predicate/
(TupleDomain, Domain, ValueSet/Ranges; SURVEY.md §2.1). Simplified to the shapes the
round-1 optimizer extracts: per-column range + in-list + null admission. Used for
connector split pruning and (later) dynamic filtering.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, Optional, Tuple


@dataclass(frozen=True)
class Range:
    """[low, high] with open/closed bounds; None bound = unbounded."""

    low: Any = None
    high: Any = None
    low_inclusive: bool = True
    high_inclusive: bool = True

    def intersect(self, other: "Range") -> Optional["Range"]:
        low, low_inc = self.low, self.low_inclusive
        if other.low is not None and (low is None or other.low > low or (other.low == low and not other.low_inclusive)):
            low, low_inc = other.low, other.low_inclusive
        high, high_inc = self.high, self.high_inclusive
        if other.high is not None and (high is None or other.high < high or (other.high == high and not other.high_inclusive)):
            high, high_inc = other.high, other.high_inclusive
        if low is not None and high is not None:
            if low > high or (low == high and not (low_inc and high_inc)):
                return None
        return Range(low, high, low_inc, high_inc)

    def contains_value(self, v: Any) -> bool:
        if self.low is not None:
            if v < self.low or (v == self.low and not self.low_inclusive):
                return False
        if self.high is not None:
            if v > self.high or (v == self.high and not self.high_inclusive):
                return False
        return True


ALL_RANGE = Range()


@dataclass(frozen=True)
class Domain:
    """Admissible values for one column (ref: spi/predicate/Domain.java)."""

    range: Range = ALL_RANGE
    in_values: Optional[FrozenSet[Any]] = None  # None = unconstrained by IN
    nulls_allowed: bool = False
    none: bool = False  # contradiction: no value passes

    @staticmethod
    def all() -> "Domain":
        return Domain(nulls_allowed=True)

    @staticmethod
    def single(value: Any) -> "Domain":
        return Domain(range=Range(value, value))

    def intersect(self, other: "Domain") -> "Domain":
        if self.none or other.none:
            return Domain(none=True)
        r = self.range.intersect(other.range)
        iv = self.in_values
        if other.in_values is not None:
            iv = other.in_values if iv is None else frozenset(iv & other.in_values)
        nulls = self.nulls_allowed and other.nulls_allowed
        if r is None or (iv is not None and not iv):
            return Domain(none=True, nulls_allowed=nulls)
        return Domain(range=r, in_values=iv, nulls_allowed=nulls)

    def contains_value(self, v: Any) -> bool:
        if self.none:
            return False
        if v is None:
            return self.nulls_allowed
        if self.in_values is not None and v not in self.in_values:
            return False
        return self.range.contains_value(v)

    def overlaps_range(self, low: Any, high: Any) -> bool:
        """Can any value in [low, high] satisfy this domain? (split pruning)."""
        if self.none:
            return False
        r = self.range.intersect(Range(low, high))
        if r is None:
            return False
        if self.in_values is not None:
            return any(Range(low, high).contains_value(v) and self.range.contains_value(v) for v in self.in_values)
        return True


@dataclass(frozen=True)
class TupleDomain:
    """Conjunction of per-column domains (ref: spi/predicate/TupleDomain.java)."""

    domains: Tuple[Tuple[str, Domain], ...] = ()  # sorted items, hashable

    @staticmethod
    def all() -> "TupleDomain":
        return TupleDomain()

    @staticmethod
    def from_dict(d: Dict[str, Domain]) -> "TupleDomain":
        return TupleDomain(tuple(sorted(d.items())))

    def as_dict(self) -> Dict[str, Domain]:
        return dict(self.domains)

    @property
    def is_none(self) -> bool:
        return any(dom.none for _, dom in self.domains)

    def intersect(self, other: "TupleDomain") -> "TupleDomain":
        merged = self.as_dict()
        for col, dom in other.domains:
            merged[col] = merged[col].intersect(dom) if col in merged else dom
        return TupleDomain.from_dict(merged)

    def domain_for(self, column: str) -> Domain:
        for col, dom in self.domains:
            if col == column:
                return dom
        return Domain.all()
