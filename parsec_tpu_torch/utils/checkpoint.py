"""Checkpoint / resume for data collections.

Beyond-reference capability (checkpoint/restart is absent in PaRSEC; its
closest machinery is taskpool quiescence + DTD ``data_flush``): after a
taskpool drains, every rank serializes the tiles it OWNS — payloads pulled
from the card to the host, version numbers preserved — into one ``.npz``
per rank plus a JSON manifest describing the grid, so a later run (same or
different rank count is fine as long as the distribution maps tiles the
same way) can restore the collection state and continue where the previous
run stopped.

Usage pattern (each rank)::

    tp.data_flush_all(A)          # DTD: land cross-owner writes home
    tp.wait(); ...
    checkpoint.save(path, {"A": A}, rank=ctx.my_rank)
    # --- later / new process ---
    checkpoint.restore(path, {"A": A}, rank=ctx.my_rank)

The quiescence point is the caller's: checkpoint after ``wait()`` — the
runtime's termination detection IS the global consistency barrier.

The files are numpy's: a float32 or float64 tile is stored as its numpy
array, and the manifest names the dtype by numpy's ``dtype.str`` (``<f4``,
``<f8``). numpy has no bfloat16: a bf16 tile is stored as its raw 2-byte
words (numpy ``|V2``) and named ``<V2``, which is what a numpy array of the
``ml_dtypes`` bfloat16 type writes, so the bits of either kind of file
restore unchanged. Restored tiles land in the collection's home copies, on
its device (the card for a collection built there).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.data import COHERENCY_INVALID, COHERENCY_OWNED
from . import output

#: the manifest's (and the archive's) name for bfloat16 tiles
BF16_STR = "<V2"


def dtype_str(dtype: torch.dtype) -> str:
    """The manifest's dtype string of a torch dtype: numpy's ``dtype.str``,
    and ``<V2`` for bfloat16."""
    if dtype == torch.bfloat16:
        return BF16_STR
    return torch.empty((), dtype=dtype).numpy().dtype.str


def _to_numpy(payload: Any) -> np.ndarray:
    """A tile as the numpy array the archive holds (bf16 as raw words)."""
    t = torch.as_tensor(payload).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    """The tensor of an archived tile (raw 2-byte words are bf16)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _owned_tiles(dc, rank: Optional[int]):
    for m in range(dc.mt):
        for n in range(dc.nt):
            if not dc.stored(m, n):
                continue
            if rank is None or dc.rank_of(m, n) == rank:
                yield m, n


def _grid(dc) -> Dict[str, Any]:
    return {"lm": dc.lm, "ln": dc.ln, "mb": dc.mb, "nb": dc.nb,
            "mt": dc.mt, "nt": dc.nt, "dtype": dtype_str(dc.dtype)}


def save(path: str, collections: Dict[str, Any],
         rank: Optional[int] = None) -> str:
    """Serialize every collection's locally-owned tiles.

    Writes ``{path}.r{rank}.npz`` (or ``{path}.npz`` single-process) and a
    shared manifest ``{path}.manifest.json``. Returns the npz path.
    """
    arrays: Dict[str, np.ndarray] = {}
    versions: Dict[str, int] = {}
    skipped: list = []
    manifest: Dict[str, Any] = {"collections": {}}
    for name, dc in collections.items():
        manifest["collections"][name] = _grid(dc)
        for m, n in _owned_tiles(dc, rank):
            data = dc.data_of(m, n)
            copy = data.newest_copy()
            key = f"{name}/{m}_{n}"
            if copy is None or copy.payload is None:
                # never-materialized tile (e.g. lazily-allocated, never
                # touched): recorded so strict restore can tell an
                # intentional absence from a torn checkpoint
                skipped.append(key)
                continue
            arrays[key] = _to_numpy(copy.payload)
            versions[key] = int(copy.version)
    suffix = f".r{rank}" if rank is not None else ""
    npz_path = f"{path}{suffix}.npz"
    os.makedirs(os.path.dirname(npz_path) or ".", exist_ok=True)
    tmp = npz_path + ".tmp"
    with open(tmp, "wb") as f:          # atomic publish: no torn checkpoints
        np.savez(f, __versions__=json.dumps(versions),
                 __skipped__=json.dumps(skipped), **arrays)
    os.replace(tmp, npz_path)
    man_path = f"{path}.manifest.json"
    if rank in (None, 0):
        with open(man_path + ".tmp", "w") as f:
            json.dump(manifest, f)
        os.replace(man_path + ".tmp", man_path)
    return npz_path


def restore(path: str, collections: Dict[str, Any],
            rank: Optional[int] = None, strict: bool = True) -> int:
    """Load this rank's owned tiles back into the collections.

    Validates the manifest grid against each live collection (a mismatched
    tiling would silently scramble data). Returns the number of tiles
    restored. With ``strict`` every owned tile must be present."""
    man_path = f"{path}.manifest.json"
    if not os.path.exists(man_path):
        if strict:
            output.fatal(f"checkpoint manifest {man_path!r} missing — the "
                         f"grid cannot be validated (pass strict=False to "
                         f"restore anyway at your own risk)")
        manifest = None
    else:
        with open(man_path) as f:
            manifest = json.load(f)["collections"]
    if manifest is not None:
        for name, dc in collections.items():
            meta = manifest.get(name)
            if meta is None:
                output.fatal(f"checkpoint {path!r} has no collection "
                             f"{name!r} (has: {sorted(manifest)})")
            live = _grid(dc)
            if live != meta:
                output.fatal(f"checkpoint grid mismatch for {name!r}: "
                             f"saved {meta}, live {live}")
    suffix = f".r{rank}" if rank is not None else ""
    npz_path = f"{path}{suffix}.npz"
    with np.load(npz_path, allow_pickle=False) as z:
        versions = json.loads(str(z["__versions__"]))
        skipped = set(json.loads(str(z["__skipped__"]))) \
            if "__skipped__" in z else set()
        restored = 0
        for name, dc in collections.items():
            for m, n in _owned_tiles(dc, rank):
                key = f"{name}/{m}_{n}"
                if key not in z:
                    # strict restore fatals only on tiles the checkpoint
                    # claims should exist; save() records intentional skips
                    if strict and key not in skipped:
                        output.fatal(f"checkpoint missing tile {key}")
                    continue
                arr = _from_numpy(z[key]).to(device=dc.device, dtype=dc.dtype)
                data = dc.data_of(m, n)
                newest = data.newest_copy()
                host = data.get_copy(0)
                if host is None:
                    host = data.create_copy(0, arr, COHERENCY_OWNED)
                else:
                    host.payload = arr
                    # the restored home copy is the truth, whatever state a
                    # previous life left it in (e.g. INVALID after a device
                    # write took ownership)
                    host.coherency_state = COHERENCY_OWNED
                # restore the saved version so staged copies from a previous
                # life can never win a newest_copy race; keep the Data-level
                # version counter in sync so later bump_version() calls hand
                # out strictly newer versions
                host.version = max(versions.get(key, 0),
                                   (newest.version if newest else 0) + 1)
                data.version = max(data.version, host.version)
                # invalidate stale non-home copies
                for di, c in list(data.copies.items()):
                    if di != 0 and c is not None:
                        c.coherency_state = COHERENCY_INVALID
                restored += 1
    return restored
