"""A frame's output wire on its way to the host.

``frame_step`` ends in a flat wire of the three planes on the device: uint8
(depth 8, and the packed 10- and 12-bit wires), or int16 samples, which
``cpu()`` hands out as uint16 (the reference's wire type, and the one
``Frame.host_planes`` reads).  ``Wire`` carries it to the caller with two
methods, the ones the decoder's ``Frame.host_planes`` and
``Decoder._reconstruct`` look for:

- ``copy_to_host_async()`` makes the D2H stream wait for the wire (an event
  recorded on the stream that made it) and starts a ``non_blocking`` copy
  into pinned host memory there;
- ``cpu()`` waits for that copy (starting it first if nobody did), checks
  K1's error word for the frame, and returns the host tensor.

``check()`` alone raises where K1 could not schedule the frame's metadata;
the pipeline calls it at the latest when it hands the frame out.  On the
CPU the wire is already in host memory and both methods only check.
"""

import torch


class Wire:
    def __init__(self, wire, d2h_stream, errors=None, poc=None):
        self.wire = wire
        self.errors = errors            # intra.IntraErrors or None
        self.poc = poc
        self._stream = d2h_stream
        self._host = None
        self._copied = None
        self.ready = None               # the wire is complete on its stream
        if wire.device.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(wire.device))
        else:
            self._host = wire

    def copy_to_host_async(self):
        if self._host is not None:
            return
        s = self._stream
        s.wait_event(self.ready)
        with torch.cuda.stream(s):
            host = torch.empty(self.wire.shape, dtype=self.wire.dtype,
                               pin_memory=True)
            host.copy_(self.wire, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(s)
        # the copy reads the wire on s: the allocator must not reuse it
        # before the copy has run
        self.wire.record_stream(s)
        self._host = host

    def check(self):
        """Raise where K1 met metadata it could not schedule."""
        if self.errors is not None:
            self.errors.check(self.poc)     # raises again on a retry
            self.errors = None

    def cpu(self):
        """The wire as a host tensor (waits for the copy)."""
        self.copy_to_host_async()
        if self._copied is not None:
            self._copied.synchronize()
        self.check()
        if self._host.dtype == torch.int16:
            return self._host.view(torch.uint16)
        return self._host
