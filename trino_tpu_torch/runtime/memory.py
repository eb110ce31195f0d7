"""Page sizing.

The port keeps only ``page_bytes`` of ``trino_tpu.runtime.memory``: the
operator-state spill gates and the spiller size pages with it. The memory
plane (pools, contexts, revocation) is not ported yet.
"""

from __future__ import annotations


def page_bytes(page) -> int:
    """Bytes held by a Page: every device tensor of every column (data,
    validity, and a nested column's lengths, element masks and children),
    the active row mask, and the host dictionary values (each distinct
    dictionary counted once, memoized on it: dictionaries are immutable and
    shared across pages)."""
    from ..spi.page import column_tensors

    total = page.active.numel()  # active mask (bool)
    seen_dicts = set()

    def add_dictionaries(c) -> int:
        n = 0
        d = c.dictionary
        if d is not None and id(d) not in seen_dicts:
            seen_dicts.add(id(d))
            if d._host_bytes is None:
                d._host_bytes = int(sum(len(str(v)) for v in d.values))
            n += d._host_bytes
        return n + sum(add_dictionaries(k) for k in c.children)

    for c in page.columns:
        total += sum(t.numel() * t.element_size() for t in column_tensors(c))
        total += add_dictionaries(c)
    return int(total)
