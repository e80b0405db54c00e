"""Data collections: the distribution vtable.

Re-design of parsec/include/parsec/data_distribution.h:18-61. A collection
maps logical keys to (rank, device, Data): ``rank_of`` / ``data_of`` /
``vpid_of`` / ``data_key`` — the basis of owner-computes distribution;
closed-form layouts (block cyclic) are in :mod:`parsec_tpu_torch.data.matrix`.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Iterable

from .data import Data


class DataCollection:
    """Ref: parsec_data_collection_t (data_distribution.h:18-61)."""

    def __init__(self, name: str = "dc", nodes: int = 1, myrank: int = 0) -> None:
        self.name = name
        self.nodes = nodes
        self.myrank = myrank
        self.dc_id = id(self)
        self._datas: Dict[Any, Data] = {}
        self._lock = threading.Lock()
        self.default_datatype = None   # arena datatype for remote transfers

    # --- the vtable ---------------------------------------------------------
    def data_key(self, *indices) -> Any:
        """Flatten logical indices into a key (ref: data_key fn ptr)."""
        return indices if len(indices) != 1 else indices[0]

    def rank_of(self, *indices) -> int:
        return 0

    def rank_of_key(self, key: Any) -> int:
        return 0

    def vpid_of(self, *indices) -> int:
        return 0

    def data_of(self, *indices) -> Data:
        return self.data_of_key(self.data_key(*indices))

    def data_of_key(self, key: Any) -> Data:
        with self._lock:
            d = self._datas.get(key)
            if d is None:
                d = self._create_data(key)
                self._datas[key] = d
            return d

    # --- helpers ------------------------------------------------------------
    def _create_data(self, key: Any) -> Data:
        """Subclasses materialize storage lazily (local tiles only)."""
        return Data(key=key, dc=self)

    def register_data(self, key: Any, data: Data) -> Data:
        with self._lock:
            data.dc = self
            self._datas[key] = data
        return data

    def keys(self) -> Iterable[Any]:
        return list(self._datas.keys())

    def local_keys(self) -> Iterable[Any]:
        return [k for k in self.keys() if self.rank_of_key(k) == self.myrank]
