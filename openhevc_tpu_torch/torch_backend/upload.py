"""One frame's plan arrays in one buffer, moved by one host-to-device copy.

``plan_layout`` places every array of a frame in a single byte buffer:
one section a dtype (int16, int8, uint8), each section 16-byte aligned and
each array aligned to four elements inside its section.  The host side
writes the arrays straight into that buffer (pinned memory on the card,
from a ``PinnedRing``); ``to_device`` moves it with one ``non_blocking``
copy on a copy stream and widens each section to int32 with one op on the
caller's (compute) stream, so every array arrives as a contiguous int32
view.  Nothing here waits for the device unless the ring has to reuse a
buffer whose copy is still in flight.
"""

import numpy as np
import torch

from . import device

SECTIONS = (np.dtype(np.int16), np.dtype(np.int8), np.dtype(np.uint8))
_TORCH = {np.dtype(np.int16): torch.int16, np.dtype(np.int8): torch.int8,
          np.dtype(np.uint8): torch.uint8}


def _up(x, m):
    return -(-x // m) * m


def plan_layout(specs):
    """specs: {key: (numpy dtype, shape)} -> (layout, total bytes).

    layout: ((dtype, byte start, elements, ((key, element offset, shape),
    ...)), ...), one entry a non-empty section, in SECTIONS order."""
    layout, start = [], 0
    for dt in SECTIONS:
        items, n = [], 0
        for key, (kdt, shape) in specs.items():
            if np.dtype(kdt) != dt:
                continue
            items.append((key, n, tuple(shape)))
            n += _up(int(np.prod(shape, dtype=np.int64)), 4)
        if items:
            layout.append((dt, start, n, tuple(items)))
            start = _up(start + n * dt.itemsize, 16)
    return tuple(layout), start


class HostPlan(dict):
    """{key: ndarray view} into one byte buffer laid out by plan_layout;
    ``buf`` is the whole buffer; ``pinned`` the same bytes as a pinned
    tensor and ``slot`` its PinnedRing slot (both None for a buffer in
    pageable memory)."""

    def __init__(self, buf, layout, pinned=None, slot=None):
        super().__init__()
        self.buf, self.layout = buf, layout
        self.pinned, self.slot = pinned, slot
        for dt, start, n, items in layout:
            sec = self.section(dt)
            for key, off, shape in items:
                size = int(np.prod(shape, dtype=np.int64))
                self[key] = sec[off:off + size].reshape(shape)

    def section(self, dt):
        """The whole section of dtype dt, as one flat array."""
        for sdt, start, n, _items in self.layout:
            if sdt == dt:
                return self.buf[start:start + n * dt.itemsize].view(dt)
        raise KeyError(dt)


class PinnedRing:
    """A few pinned host buffers, used in turn.  A buffer is handed out
    again only after the event of its last copy has completed; the
    buffers grow when a frame needs more."""

    def __init__(self, slots=4):
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.next = 0

    def take(self, nbytes):
        """-> (slot, the first nbytes of a pinned uint8 buffer)."""
        k = self.next
        self.next = (k + 1) % len(self.bufs)
        ev = self.events[k]
        if ev is not None and not ev.query():
            ev.synchronize()            # the ring is full: wait for a copy
        self.events[k] = None
        buf = self.bufs[k]
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes + nbytes // 4 + 64, dtype=torch.uint8,
                              pin_memory=True)
            self.bufs[k] = buf
        return k, buf[:nbytes]

    def copied(self, slot, event):
        self.events[slot] = event


def host_plan(layout, nbytes, ring=None):
    """A HostPlan in a ring buffer when a ring is given (the card), else in
    pageable memory.  Its arrays hold stale bytes until written."""
    if ring is None:
        return HostPlan(np.zeros(max(nbytes, 16), np.uint8), layout)
    slot, pinned = ring.take(max(nbytes, 16))
    return HostPlan(pinned.numpy(), layout, pinned, slot)


def to_device(host, dev, copy_stream=None, ring=None):
    """HostPlan -> {key: contiguous int32 tensor on dev}.

    On the card: one non_blocking copy of the whole buffer on copy_stream
    into a device buffer allocated there; the current stream waits for
    the copy's event and widens each section with one op.  The device
    buffer is marked as used by the current stream, so the allocator does
    not hand it to the copy stream again before the widening has run."""
    if dev.type == "cpu":
        flat = torch.from_numpy(host.buf)
    else:
        pinned = host.pinned
        compute = torch.cuda.current_stream(dev)
        with torch.cuda.stream(copy_stream):
            flat = torch.empty(pinned.numel(), dtype=torch.uint8, device=dev)
            flat.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        device.count(device.H2D)
        if ring is not None:
            ring.copied(host.slot, done)
        compute.wait_event(done)
        flat.record_stream(compute)
    out = {}
    for dt, start, n, items in host.layout:
        sec = flat[start:start + n * dt.itemsize].view(_TORCH[dt]) \
            .to(torch.int32)
        for key, off, shape in items:
            size = int(np.prod(shape, dtype=np.int64))
            out[key] = sec[off:off + size].view(shape)
    return out
