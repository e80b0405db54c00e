"""Model/training-state checkpointing via ``torch.distributed.checkpoint``.

The runtime side of checkpoint/resume (tile collections at quiescence) is
:mod:`parsec_tpu_torch.utils.checkpoint`; this module is the MODEL side:
save and restore a whole training state — the parameter tree, the
optimizer state tree (:mod:`parsec_tpu_torch.parallel.optim`'s
``{"count", "mu", "nu"}``) and the step counter — as one
``torch.distributed.checkpoint`` (DCP) directory. Without a process group
DCP writes and reads in this process alone; its format is the one it
shards, so a sharded state (DTensor leaves, a process group) extends this
without a new format.

    from parsec_tpu_torch.utils.model_ckpt import (save_train_state,
                                                   restore_train_state)
    save_train_state(path, params, opt_state, step=1000)
    params, opt_state, step = restore_train_state(path, like=(params0, opt0))

The trees are flattened to ``"<part>/<key>/<index>/..."`` entries (the
step is the 0-dim int64 entry ``step``); every leaf is stored with its
dtype and shape, so a restore is bit for bit.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import warnings
from typing import Any, Optional, Tuple

import torch


def _no_dist() -> bool:
    import torch.distributed as dist
    return not (dist.is_available() and dist.is_initialized())


@contextlib.contextmanager
def _single_process():
    """DCP warns on every call without a process group that it assumes
    one process: that is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        yield


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k in sorted(tree):
            if "/" in str(k):
                raise ValueError(f"tree key {k!r} holds '/'")
            _flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif isinstance(tree, torch.Tensor):
        out[prefix] = tree
    elif tree is not None:
        raise TypeError(f"{prefix}: a checkpoint holds tensors, not "
                        f"{type(tree).__name__}")
    return out


def _unflatten(flat: dict, part: str):
    """The tree under ``part`` from flattened entries: a level whose keys
    are all digits is a list."""
    root: dict = {}
    for key, t in flat.items():
        head, *path = key.split("/")
        if head != part:
            continue
        node = root
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = t

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}
    return fix(root) if root else None


def save_train_state(path: str, params: Any, opt_state: Any = None,
                     step: int = 0, force: bool = True) -> str:
    """Write ``{params, opt_state, step}`` under ``path`` (a directory,
    replaced when ``force``; else an existing one raises). Returns the
    absolute path."""
    import torch.distributed.checkpoint as dcp
    import torch.distributed as dist
    path = os.path.abspath(path)
    solo = _no_dist()
    if solo or dist.get_rank() == 0:
        if os.path.exists(path):
            if not force:
                raise FileExistsError(path)
            shutil.rmtree(path)
    if not solo:
        dist.barrier()
    state = _flatten(params, "params", {})
    _flatten(opt_state, "opt_state", state)
    state["step"] = torch.tensor(int(step), dtype=torch.int64)
    with _single_process():
        dcp.save(state, checkpoint_id=path, no_dist=solo)
    return path


def restore_train_state(path: str, like: Optional[Tuple[Any, Any]] = None
                        ) -> Tuple[Any, Any, int]:
    """Restore ``(params, opt_state, step)``.

    ``like=(params_like, opt_state_like)`` gives the target trees: each
    leaf is restored into a new tensor of the like leaf's device, a DTensor
    leaf into a new DTensor on its mesh and placements (bit for bit the
    saved one; the like trees are not written). Without ``like`` the trees
    come back as saved, on the CPU."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader
    path = os.path.abspath(path)
    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    devices = {}
    if like is not None:
        _flatten(like[0], "params", devices)
        if like[1] is not None:
            _flatten(like[1], "opt_state", devices)
    from ..parallel.compat import DTensor
    state = {}
    for key, md in meta.items():
        lk = devices.get(key)
        if isinstance(lk, DTensor):
            state[key] = DTensor.from_local(
                torch.empty_like(lk.to_local()), lk.device_mesh,
                lk.placements, run_check=False, shape=lk.shape,
                stride=lk.stride())
            continue
        dev = lk.device if lk is not None else "cpu"
        state[key] = torch.empty(tuple(md.size), dtype=md.properties.dtype,
                                 device=dev)
    missing = set(devices) - set(state)
    if missing:
        raise KeyError(f"checkpoint {path} lacks {sorted(missing)[:4]}")
    with _single_process():
        dcp.load(state, checkpoint_id=path, no_dist=_no_dist())
    return (_unflatten(state, "params"), _unflatten(state, "opt_state"),
            int(state["step"]))
