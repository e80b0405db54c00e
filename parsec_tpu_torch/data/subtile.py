"""Subtile collections: recursive finer tiling of one tile.

Re-design of parsec/data_dist/matrix/subtile.c: a collection viewing ONE
tile of a parent collection as its own tiled matrix, the data substrate of
recursive task execution (PARSEC_DEV_RECURSIVE): a coarse task spawns a
nested taskpool over the subtile view of its tile, the nested tasks operate
on sub-blocks, and the coarse tile sees the result.

The working buffer is a torch tensor on the device of the parent's newest
copy (the card, when the parent tile lives there) and the sub-blocks' home
copies are views into it, so nested updates that land in place compose;
:meth:`SubtileCollection.flush` gathers the (possibly replaced) sub-blocks
into a fresh tensor and makes it the parent's newest copy.
"""

from __future__ import annotations

import torch

from .data import COHERENCY_OWNED, Data
from .matrix import TiledMatrix


class SubtileCollection(TiledMatrix):
    """Tiled view of one parent tile (ref: subtile_desc_create)."""

    def __init__(self, parent_data: Data, mb: int, nb: int,
                 name: str = "subtile") -> None:
        src = parent_data.newest_copy()
        if src is None:
            raise ValueError("parent tile has no valid copy")
        tile = torch.as_tensor(src.payload)
        lm, ln = tile.shape
        super().__init__(name, lm, ln, mb, nb, dtype=tile.dtype,
                         device=tile.device)
        self.parent_data = parent_data
        #: the parent's copy the buffer came from, and flush writes back to
        self.parent_index = src.device_index
        # one contiguous working buffer; sub-blocks are views into it. On
        # the card the copy is complete before any nested task reads it:
        # the device module reads on its own stream
        self._buffer = tile.clone(memory_format=torch.contiguous_format)
        if self._buffer.is_cuda:
            torch.cuda.current_stream(self._buffer.device).synchronize()

    @property
    def buffer(self) -> torch.Tensor:
        """The working buffer the sub-blocks' home copies are views of."""
        return self._buffer

    def _create_data(self, key):
        m, n = self.key_to_indices(key)
        r, c = self.tile_shape(m, n)
        view = self._buffer[m * self.mb:m * self.mb + r,
                            n * self.nb:n * self.nb + c]
        d = Data(key=key, dc=self, shape=(r, c), dtype=self.dtype)
        d.create_copy(0, view, COHERENCY_OWNED)
        return d

    def _in_buffer(self, t: torch.Tensor) -> bool:
        """Whether ``t`` is a view into the working buffer."""
        return t.device == self._buffer.device and \
            t.untyped_storage().data_ptr() == \
            self._buffer.untyped_storage().data_ptr()

    def flush(self) -> None:
        """Write the subtile results back into the parent tile: a new tensor
        on the buffer's device becomes the payload of the parent's copy the
        buffer came from, and that copy takes a new version (the newest, as
        after any task write), so no older copy of the parent — its host
        copy, or a device copy staged before — is served after it."""
        out = self._buffer.clone()
        for m in range(self.mt):
            for n in range(self.nt):
                d = self._datas.get(self.data_key(m, n))
                if d is None:
                    continue
                payload = torch.as_tensor(d.newest_copy().payload)
                if self._in_buffer(payload):
                    continue        # updated in place: already in the clone
                r, co = self.tile_shape(m, n)
                out[m * self.mb:m * self.mb + r,
                    n * self.nb:n * self.nb + co] = payload[:r, :co]
        if out.device.type == "cuda":
            # the sub-blocks were written on the device module's stream
            torch.cuda.synchronize(out.device)
        home = self.parent_data.get_copy(self.parent_index)
        if home is None:
            self.parent_data.create_copy(self.parent_index, out,
                                         COHERENCY_OWNED)
        else:
            home.payload = out
        self.parent_data.bump_version(self.parent_index)
