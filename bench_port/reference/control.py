"""The control: the reference put in the program's place with one stated
guarantee broken, to show that the comparison deciding `correct` fails
it. The configurations state no precision; what they state is the code,
so the control seals with plain XOR parity (every coefficient 1, the
shortcut of a RAID-style parity) where the code's GF(256) rows are due.
`python3 bench_port/run.py ... --control 1` runs a cell with it."""
from __future__ import annotations

import numpy as np
import torch

from . import encode


def _xor_rows(coef: np.ndarray) -> np.ndarray:
    return np.ones_like(np.asarray(coef, dtype=np.uint8))


class ControlCodec:
    """A codec backend (coded_matmul and its stream) computing XOR parity
    with the reference's plain product on `device`."""

    name = "control"

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)

    def coded_matmul(self, coef: np.ndarray, shards: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(shards, dtype=np.uint8))
        return encode.coded_matmul(_xor_rows(coef), x.to(self.device)).cpu().numpy()

    def coded_matmul_stream(self, coef: np.ndarray, blocks, depth: int = 2):
        for block in blocks:
            yield self.coded_matmul(coef, block)

