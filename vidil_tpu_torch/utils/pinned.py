"""Page-locked host memory carved from slabs, for copies between the host
and the card that must not hold the host back."""

from __future__ import annotations

import numpy as np
import torch


class PinnedArena:
    """Pinned host tensors carved in turn from pinned slabs, no byte handed
    out twice. Allocating page-locked memory can wait for the whole device
    (it synchronizes implicitly), and the caching host allocator allocates
    anew while callers keep what it handed out, so a fresh pinned buffer
    per chunk can hold the host until the card has run the chunk just
    dispatched; a slab pays that once per `SLAB_BYTES`, which holds ~150 of
    the LM stage's chunks (a chunk's ids and packing tables take ~0.4 MB at
    16 prompts of 3000 tokens) and thousands of CapFilt's readbacks. A
    caller may keep what it was handed for as long as it likes.

    `copy` reads a device tensor back (CapFilt's early readback); `upload`
    stages a host array and sends it to the card without waiting (the LM
    stage's packed prompts)."""

    SLAB_BYTES = 64 << 20
    ALIGN = 256

    def __init__(self):
        self._slab = None
        self._used = 0

    def _carve(self, dtype, shape, nbytes: int) -> torch.Tensor:
        size = -(-max(nbytes, 1) // self.ALIGN) * self.ALIGN
        if self._slab is None or self._used + size > self._slab.numel():
            self._slab = torch.empty(max(self.SLAB_BYTES, size), dtype=torch.uint8,
                                     pin_memory=True)
            self._used = 0
        out = self._slab[self._used:self._used + nbytes].view(dtype).view(shape)
        self._used += size
        return out

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of the device tensor `x`, enqueued on the
        current stream (valid once the stream has passed it)."""
        out = self._carve(x.dtype, x.shape, x.numel() * x.element_size())
        return out.copy_(x, non_blocking=True)

    def upload(self, a: np.ndarray, device) -> torch.Tensor:
        """The host array `a` on `device`: through a pinned copy and an
        upload that does not wait, on a card; a plain copy elsewhere."""
        src = torch.from_numpy(np.ascontiguousarray(a))
        device = torch.device(device)
        if device.type != "cuda":
            return src.to(device)
        staged = self._carve(src.dtype, src.shape, src.numel() * src.element_size())
        staged.copy_(src)
        return staged.to(device, non_blocking=True)
