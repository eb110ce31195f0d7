"""Page sizing.

The port keeps only ``page_bytes`` of ``trino_tpu.runtime.memory``: the
operator-state spill gates and the spiller size pages with it. The memory
plane (pools, contexts, revocation) is not ported yet.
"""

from __future__ import annotations


def page_bytes(page) -> int:
    """Bytes held by a Page: device data and validity of every column, the
    active row mask, and the host dictionary values (each distinct
    dictionary counted once, memoized on it: dictionaries are immutable and
    shared across pages)."""
    total = page.active.numel()  # active mask (bool)
    seen_dicts = set()
    for c in page.columns:
        total += c.data.numel() * c.data.element_size() + c.valid.numel()
        d = c.dictionary
        if d is not None and id(d) not in seen_dicts:
            seen_dicts.add(id(d))
            if d._host_bytes is None:
                d._host_bytes = int(sum(len(str(v)) for v in d.values))
            total += d._host_bytes
    return int(total)
