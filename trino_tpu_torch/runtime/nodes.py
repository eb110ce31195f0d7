"""Topology-aware task placement: the part of ``trino_tpu.runtime.nodes``
the remote scheduler imports (``TopologyPlacement`` and the
network-location distance beneath it), copied. The node registry,
announcements and discovery are not ported yet."""

from __future__ import annotations


def topology_distance(a: str, b: str) -> int:
    """Distance between two network-location paths ("region/rack/host"):
    path length minus twice the shared prefix depth (ref:
    execution/scheduler/NetworkLocation.java)."""
    pa = [x for x in a.split("/") if x]
    pb = [x for x in b.split("/") if x]
    shared = 0
    for x, y in zip(pa, pb):
        if x != y:
            break
        shared += 1
    return (len(pa) - shared) + (len(pb) - shared)


class TopologyPlacement:
    """Counter-based nearest-first task placement with per-worker capacity
    and tier spill-over (ref: TopologyAwareNodeSelector.java:51).

    ``assign(key)`` is memoized: consumers asking where producer (fid, p)
    landed get the answer the dispatch did. Within a tier tasks balance to
    the least-loaded worker; a task goes to a farther tier only when every
    nearer worker is at capacity; when every worker is saturated the
    least-loaded overall takes it (capacity is a target, not an error)."""

    def __init__(self, origin: str, urls, locations, capacity: int = 0):
        far = 1 << 30
        locs = {k.rstrip("/"): v for k, v in (locations or {}).items()}

        def dist(u: str) -> int:
            loc = locs.get(u.rstrip("/"), "")
            return topology_distance(origin, loc) if loc else far

        self._urls = list(urls)
        self._dist = {u: dist(u) for u in self._urls}
        self.capacity = capacity
        self.counts = {u: 0 for u in self._urls}
        self.assignments = {}

    def assign(self, key) -> str:
        got = self.assignments.get(key)
        if got is not None:
            return got
        candidates = [u for u in self._urls
                      if self.capacity <= 0 or self.counts[u] < self.capacity]
        order = {u: i for i, u in enumerate(self._urls)}
        if candidates:
            pick = min(candidates, key=lambda u: (self._dist[u], self.counts[u], order[u]))
        else:
            pick = min(self._urls, key=lambda u: (self.counts[u], self._dist[u], order[u]))
        self.counts[pick] += 1
        self.assignments[key] = pick
        return pick
