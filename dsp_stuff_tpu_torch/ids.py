"""Monotonic ID generators with the reference's restore discipline.

The reference generates NodeId/PortId/LinkId/DeviceId from per-type atomic
counters; deserializing an ID bumps the counter with ``fetch_max(val + 1)``
so freshly generated IDs never collide with restored ones
(reference: dsp-stuff/src/ids.rs:1-57, fetch_max at ids.rs:16).

This module replicates that contract.  A single process-wide generator per
ID kind is all the reference has; graphs that want isolated ID spaces can
construct their own ``IdGen``.
"""

from __future__ import annotations

import itertools
import threading


class IdGen:
    """Monotonic counter; ``restore(v)`` guarantees future ``generate()`` > v."""

    def __init__(self) -> None:
        self._next = 0
        self._lock = threading.Lock()

    def generate(self) -> int:
        with self._lock:
            v = self._next
            self._next += 1
            return v

    def restore(self, val: int) -> int:
        # fetch_max(val + 1) semantics (ids.rs:16)
        with self._lock:
            if val + 1 > self._next:
                self._next = val + 1
        return val

    def peek(self) -> int:
        return self._next


class IdSpace:
    """One generator per ID kind, as in ids.rs:42-57."""

    KINDS = ("node", "port", "link", "device")

    def __init__(self) -> None:
        self.node = IdGen()
        self.port = IdGen()
        self.link = IdGen()
        self.device = IdGen()


# Process-global default space (the reference uses process-global statics).
GLOBAL_IDS = IdSpace()
