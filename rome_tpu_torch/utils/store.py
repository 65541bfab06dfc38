"""One bounded keyed store for what the port builds once per structure and
keeps: solvers, device programs, plans and routings (:class:`Store`)."""

from __future__ import annotations

import contextlib

from rome_tpu_torch.utils.profiling import annotate, count


class Store:
    """At most ``size`` entries by hashable key. :meth:`get` returns a key's
    entry, or builds it on a miss (inside the span ``span``, when given); a
    full store is cleared whole before the new entry goes in. Each lookup
    counts ``<name>.hit`` or ``<name>.miss`` and each clear ``<name>.clear``
    (``utils/profiling.count``). Iterating a store yields its keys."""

    def __init__(self, name: str, size: int, span: str = None):
        self.name, self.size, self.span = name, size, span
        self._hit, self._miss, self._clear = (f"{name}.{c}" for c in ("hit", "miss", "clear"))
        self._entries = {}

    def get(self, key, build):
        """The entry of ``key``; ``build()`` makes it on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            count(self._hit)
            return entry
        count(self._miss)
        if len(self._entries) >= self.size:
            count(self._clear)
            self._entries.clear()
        with annotate(self.span) if self.span else contextlib.nullcontext():
            entry = self._entries[key] = build()
        return entry

    def values(self):
        return self._entries.values()

    def clear(self):
        self._entries.clear()

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)
