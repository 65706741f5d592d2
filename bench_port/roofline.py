"""The yardstick of the kernel layer: peaks of the cards and the bytes a
coded product must move.

A GF(256) coded product of (k, n) input bytes into (m, n) output bytes
does no arithmetic a card's peak rates count; its least time is its
bytes, each input byte read once and each output byte written once:
(k + m) * n, over the card's memory bandwidth. The count is the same
work whichever kernel computes the product.
"""
from __future__ import annotations

# Device memory bandwidth in bytes/s, by torch.cuda.get_device_name():
# NVIDIA's data sheets, at the full power limit.
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}     # H100 SXM


def product_bytes(k: int, m: int, n: int) -> int:
    """Bytes a (k, n) x (m, k) coded product must move."""
    return (k + m) * n


def least_seconds(nbytes: int, device_kind: str) -> float | None:
    """The least time of moving `nbytes` on the card, None for a card
    the table does not hold."""
    bw = HBM_BYTES_PER_S.get(device_kind)
    return None if bw is None else nbytes / bw
