"""Deterministic synthetic data for the paper's applications (port of
``repro.data.synthetic``).

The batch at step ``t`` is a pure function of ``(seed, step, host)``, drawn
with numpy exactly as the reference draws it, so the port's batches are
bit-identical to the reference's.  They come back as tensors on the
caller's device (images NHWC, as the reference gives them).  Every batch
put on the device is logged as a
:class:`~repro_torch.core.events.HostTransfer`, which fills the host
row/column (0, j) of the communication matrix.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.events import HostTransfer

_TRANSFERS: list[HostTransfer] = []


def host_transfer_log() -> list[HostTransfer]:
    return _TRANSFERS


def _put(arrays: dict, label: str, device) -> dict:
    """numpy arrays -> tensors on ``device``, each logged as an h2d
    transfer to device 0 (in the reference's sorted-key order)."""
    out = {}
    for k, a in sorted(arrays.items()):
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        _TRANSFERS.append(HostTransfer(direction="h2d", device=0,
                                       nbytes=int(a.nbytes), label=label))
    return out


@dataclasses.dataclass
class SyntheticImageData:
    """64x64 image classification batches (the paper's ResNet-18 setting)."""

    num_classes: int
    global_batch: int
    image_size: int = 64
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int, device="cuda") -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        labels = rng.integers(0, self.num_classes, self.host_batch)
        # class-conditioned gaussians => learnable signal
        base = np.linspace(-1, 1, self.num_classes)[labels]
        imgs = (rng.standard_normal(
            (self.host_batch, self.image_size, self.image_size, 3)) * 0.35
            + base[:, None, None, None]).astype(np.float32)
        return _put({"images": imgs, "labels": labels.astype(np.int32)},
                    f"img_batch[{step}]", device)


@dataclasses.dataclass
class SyntheticSeq2Seq:
    """Copy-reverse translation task for the GNMT app."""

    vocab_size: int
    src_len: int
    tgt_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1

    @property
    def host_batch(self) -> int:
        return self.global_batch // self.num_hosts

    def batch_at(self, step: int, device="cuda") -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_id]))
        src = rng.integers(2, self.vocab_size,
                           (self.host_batch, self.src_len)).astype(np.int32)
        # target = reversed source (teacher forcing, BOS=1)
        tgt_full = src[:, ::-1][:, :self.tgt_len]
        tgt_in = np.concatenate(
            [np.ones((self.host_batch, 1), np.int32), tgt_full[:, :-1]], 1)
        return _put({"src": src, "tgt": tgt_in, "labels": tgt_full},
                    f"mt_batch[{step}]", device)
