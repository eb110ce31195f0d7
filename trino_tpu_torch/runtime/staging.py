"""Host pages to the card, overlapped with compute.

Where the reference hands a host page to ``jax.device_put`` from an I/O
thread, the port stages it: the page's buffers are packed into one pinned
host buffer (only the page being staged is pinned, never a whole store),
copied with one ``non_blocking`` copy on a dedicated copy stream, and an
event is recorded after the copy. The consumer's stream waits on that event
before it reads the page, and the device buffer is marked as used by the
consumer's stream (``record_stream``), so the caching allocator cannot hand
it to the copy stream again while the consumer still reads it. Nothing here
synchronizes the host with the card.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..spi.page import Column, Page

_ALIGN = 64  # bytes: each buffer starts on a 64-byte boundary of the pack


class Staged:
    """A page whose copy to the card may still be in flight: read it
    through :meth:`DeviceStager.take`."""

    __slots__ = ("page", "event", "buffer", "nbytes")

    def __init__(self, page: Page, event, buffer, nbytes: int):
        self.page = page
        self.event = event
        self.buffer = buffer
        self.nbytes = nbytes


def _tensors(page: Page) -> List[torch.Tensor]:
    out = [page.active]
    for c in page.columns:
        out.extend((c.data, c.valid))
    return out


class DeviceStager:
    """Stages CPU pages to ``device`` on a copy stream of its own. On a
    CPU device it passes pages through unchanged."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        )

    def stage(self, page: Page) -> Staged:
        """Start the copy of a CPU page to the card; any thread may call
        this. The returned page must not be read before :meth:`take`."""
        tensors = _tensors(page)
        sizes = [t.numel() * t.element_size() for t in tensors]
        if self.stream is None:
            return Staged(page, None, None, sum(sizes))
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // _ALIGN) * _ALIGN
        host = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
        for t, o, n in zip(tensors, offsets, sizes):
            host[o:o + n].copy_(t.contiguous().view(-1).view(torch.uint8))
        with torch.cuda.stream(self.stream):
            buf = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        views = [buf[o:o + n].view(t.dtype) for t, o, n in zip(tensors, offsets, sizes)]
        cols = tuple(
            Column(c.type, views[1 + 2 * i], views[2 + 2 * i], c.dictionary)
            for i, c in enumerate(page.columns)
        )
        return Staged(Page(cols, views[0]), event, buf, sum(sizes))

    def take(self, staged: Staged) -> Page:
        """The staged page, safe to read on the calling thread's current
        stream: that stream waits for the copy (on the card, not the
        host)."""
        if staged.event is None:
            return staged.page
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(staged.event)
        staged.buffer.record_stream(consumer)
        return staged.page
