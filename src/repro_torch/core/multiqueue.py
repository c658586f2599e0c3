"""§4.2 of the paper: the circular multi-queue, as the port's 3-D kernel
uses it (the port's own copy of ``repro.core.multiqueue.MultiQueueLayout``
in its "shifting" addressing, the only one the kernel uses;
``tests/test_torch_stencil3d.py`` holds the two equal).

A multi-queue is one queue per temporal-blocking step; queue ``s`` holds
the most recent planes of the time-``s`` field.  Plane ``z_out`` of time
``s`` is computed from the ``2·rad+1`` planes ``window(s, z_out)`` of
time ``s-1``, and once input plane ``z_in`` (time 0) is in, the planes
of time ``s`` up to ``producible(s, z_in) = z_in - s·rad`` are
computable.

The CUDA kernel (``kernels/csrc/stencil3d.cu``) keeps queues ``0..t-1``
as rings of ``ring`` plane slots in shared memory, plane ``z`` in slot
``slot(z)``.  It lags each time level one plane behind what is
producible: plane ``z`` of time ``s`` is computed in the kernel's
iteration ``z + s·(rad+1)`` (time 0 takes input plane ``z`` in
iteration ``z``), from planes of time ``s-1`` written in earlier
iterations only, since the reads of ``window(s, z)`` end at plane
``z + rad``, written one iteration earlier.  So all ``t`` levels
advance in the same iteration with one barrier per iteration, and the
level below writes its next plane while the window is still read.  The
``2·rad+1`` live planes plus that one write slot (``ring = live_span()
+ 1``, what :meth:`MultiQueueLayout.check` asserts) are exactly what
this needs.  The reference's batched streaming (``choose_batch``,
``stream_schedule``) is not copied: this kernel streams one plane at a
time.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MultiQueueLayout:
    depth: int          # t, number of temporal steps (queues)
    radius: int         # stencil radius
    ring: int           # slots per queue

    @classmethod
    def make(cls, depth: int, radius: int):
        """``2·rad+1`` live planes plus one write slot per queue."""
        return cls(depth, radius, 2 * radius + 2)

    # ---------------------------------------------------------------- slots
    def slot(self, z: int) -> int:
        """Ring slot for plane index z (same algebra for every queue)."""
        return z % self.ring

    def producible(self, s: int, z_in: int) -> int:
        """Highest plane of time-step ``s`` computable once input plane
        ``z_in`` (time 0) has been enqueued: z_in - s·rad."""
        return z_in - s * self.radius

    def window(self, s: int, z_out: int) -> list[int]:
        """Plane indices of time-step ``s-1`` read to produce plane ``z_out``
        of time-step ``s``."""
        return list(range(z_out - self.radius, z_out + self.radius + 1))

    def live_span(self) -> int:
        """Number of planes that must stay live per queue (ring lower
        bound)."""
        return 2 * self.radius + 1

    def check(self) -> None:
        """The invariant the kernel relies on."""
        if self.ring < self.live_span() + 1:
            raise ValueError("write slot would clobber a live plane")


def kernel_layout(depth: int, radius: int) -> MultiQueueLayout:
    """The layout the CUDA kernel allocates: ``2·rad+2`` slots per queue,
    addressed ``z % ring`` (the smallest ring the lagged schedule
    allows)."""
    layout = MultiQueueLayout.make(depth, radius)
    layout.check()
    return layout
