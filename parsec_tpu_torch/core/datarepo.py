"""Data repositories: produced copies held for successors.

Re-design of parsec/datarepo.{c,h}. One repo per task class per taskpool; each
entry is keyed by the producing task's key and holds the data copies it
produced, one slot per flow. The retire protocol mirrors the reference
(datarepo.h:74-90): an entry carries ``usagelmt`` (how many successor uses will
happen) and ``usagecnt`` (how many happened); when they meet, the entry retires
and its copies drop a reference.

The ``retired`` counter shows that retires actually happened.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional


class DataRepoEntry:
    """Ref: data_repo_entry_t (parsec/datarepo.h:74-90)."""

    __slots__ = ("key", "data", "usagelmt", "usagecnt", "retained", "_repo",
                 "_mp_owner")

    def __init__(self, repo: "DataRepo", key: Any, nb_flows: int) -> None:
        self.key = key
        self.data: List[Any] = [None] * nb_flows  # DataCopy per flow
        self.usagelmt = 0
        self.usagecnt = 0
        self.retained = 0
        self._repo = repo


class DataRepo:
    """Hash table of repo entries for one task class (ref: datarepo.c).

    Entries come from a thread-affine :class:`~parsec_tpu_torch.utils.mempool.
    Mempool` — the reference allocates repo entries from parsec_mempool_t
    for exactly this churn profile (one entry per produced task, retired
    when all successors consumed)."""

    def __init__(self, nb_flows: int, name: str = "") -> None:
        self.nb_flows = nb_flows
        self.name = name
        self.retired = 0          # entries fully consumed and released
        self._table: Dict[Any, DataRepoEntry] = {}
        self._lock = threading.Lock()
        from ..utils.mempool import Mempool
        self._pool = Mempool(
            factory=lambda: DataRepoEntry(self, None, nb_flows),
            reset=self._scrub)

    def _scrub(self, e: DataRepoEntry) -> None:
        e.key = None
        for i in range(self.nb_flows):
            e.data[i] = None
        e.usagelmt = 0
        e.usagecnt = 0
        e.retained = 0

    def lookup_entry(self, key: Any) -> Optional[DataRepoEntry]:
        with self._lock:
            return self._table.get(key)

    def lookup_entry_and_create(self, key: Any) -> DataRepoEntry:
        """data_repo_lookup_entry_and_create: get-or-insert, retained."""
        with self._lock:
            e = self._table.get(key)
            if e is None:
                e = self._pool.alloc()
                e.key = key
                self._table[key] = e
            e.retained += 1
            return e

    def entry_used_once(self, key: Any) -> None:
        """data_repo_entry_used_once: one successor consumed its input."""
        retire = None
        with self._lock:
            e = self._table.get(key)
            if e is None:
                return
            e.usagecnt += 1
            if e.usagelmt and e.usagecnt >= e.usagelmt and e.retained == 0:
                retire = self._table.pop(key, None)
                if retire is not None:
                    self.retired += 1
        if retire is not None:
            self._release(retire)

    def entry_addto_usage_limit(self, key: Any, lmt: int) -> None:
        """data_repo_entry_addto_usage_limit + release of the creator's retain."""
        retire = None
        with self._lock:
            e = self._table.get(key)
            if e is None:
                return
            e.usagelmt += lmt
            e.retained = max(0, e.retained - 1)
            if e.usagelmt and e.usagecnt >= e.usagelmt and e.retained == 0:
                retire = self._table.pop(key, None)
                if retire is not None:
                    self.retired += 1
        if retire is not None:
            self._release(retire)

    def _release(self, entry: DataRepoEntry) -> None:
        for copy in entry.data:
            if copy is not None and hasattr(copy, "release"):
                copy.release()
        # mempool return AFTER the copies dropped their references: the
        # scrub clears the slots, and the shell re-enters circulation
        self._pool.release(entry)

    def pool_stats(self) -> Dict[str, int]:
        st = self._pool.stats()
        st["retired"] = self.retired
        return st

    def __len__(self) -> int:
        return len(self._table)
