"""Fixed-capacity containers: bitsets and bounded arrays.

Port of ``bsdmg_tpu/utils/containers.py``, the counterparts of the
reference's device utilities (cuda/includes/utils.cu:32-78): ``BitSet<N>``
(a packed 32-bit word backing, :34-58) and the fixed ``Array<T, N>`` /
``DynamicArray<T, N>`` (:70-78), as immutable values over dense tensors
(setters return a new container), and the vector min/max reductions
(:16-30). The reference never calls its versions from a kernel; these
serve tests and host code. A word is 32 bits held in an int64 tensor
(PyTorch's uint32 lacks the shifts), with the JAX package's values.
"""

from __future__ import annotations

import dataclasses

import torch

_WORD = 0xFFFFFFFF


def vec_minimum(v: torch.Tensor) -> torch.Tensor:
    """min over the last (component) axis: utils.cu:16-22."""
    return v.amin(dim=-1)


def vec_maximum(v: torch.Tensor) -> torch.Tensor:
    """max over the last (component) axis: utils.cu:24-30."""
    return v.amax(dim=-1)


def _shifts(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


@dataclasses.dataclass(frozen=True)
class BitSet:
    """Fixed-size bitset packed into 32-bit words (utils.cu:32-58),
    little-endian bit order; immutable."""

    words: torch.Tensor  # (ceil(n / 32),) int64 holding 32-bit words

    @staticmethod
    def zeros(n: int, device: torch.device | str = "cuda") -> "BitSet":
        return BitSet(torch.zeros((max(1, -(-n // 32)),), dtype=torch.int64, device=device))

    @staticmethod
    def from_mask(mask: torch.Tensor) -> "BitSet":
        """Pack a boolean vector into words."""
        n = mask.shape[0]
        m = torch.nn.functional.pad(mask.to(torch.int64), (0, (-n) % 32)).reshape(-1, 32)
        return BitSet((m << _shifts(mask.device)).sum(dim=1))

    @property
    def capacity(self) -> int:
        return int(self.words.shape[0]) * 32

    def get(self, i) -> torch.Tensor:
        i = torch.as_tensor(i, dtype=torch.int64, device=self.words.device)
        return ((self.words[i // 32] >> (i % 32)) & 1).bool()

    def set(self, i, value=True) -> "BitSet":
        i = torch.as_tensor(i, dtype=torch.int64, device=self.words.device)
        bit = torch.ones_like(i) << (i % 32)
        w = self.words[i // 32]
        value = torch.as_tensor(value, dtype=torch.bool, device=self.words.device)
        words = self.words.clone()
        words[i // 32] = torch.where(value, w | bit, w & (~bit & _WORD))
        return BitSet(words)

    def count(self) -> torch.Tensor:
        """Popcount over all words (the reference's SWAR sum, on 32 bits)."""
        x = self.words
        x = x - ((x >> 1) & 0x55555555)
        x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
        x = (x + (x >> 4)) & 0x0F0F0F0F
        return (((x * 0x01010101) & _WORD) >> 24).sum()

    def to_mask(self, n: int | None = None) -> torch.Tensor:
        bits = ((self.words[:, None] >> _shifts(self.words.device)) & 1).bool().reshape(-1)
        return bits if n is None else bits[:n]


@dataclasses.dataclass(frozen=True)
class BoundedArray:
    """Fixed-capacity array and live count (utils.cu:70-78 DynamicArray):
    ``data`` has shape (capacity, ...), ``count`` is an int32 scalar tensor.
    ``push`` appends without a host sync; a push beyond the capacity drops,
    like the reference's unchecked ``add``."""

    data: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def empty(capacity: int, item_shape=(), dtype=torch.float32,
              device: torch.device | str = "cuda") -> "BoundedArray":
        return BoundedArray(torch.zeros((capacity, *item_shape), dtype=dtype, device=device),
                            torch.zeros((), dtype=torch.int32, device=device))

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def push(self, item) -> "BoundedArray":
        idx = torch.clamp_max(self.count, self.capacity - 1).long()
        keep = self.count < self.capacity
        item = torch.as_tensor(item, dtype=self.data.dtype, device=self.data.device)
        data = self.data.clone()
        data[idx] = torch.where(keep, item, data[idx])
        return BoundedArray(data, self.count + keep.to(torch.int32))

    def get(self, i) -> torch.Tensor:
        return self.data[i]

    def live_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.data.device) < self.count
