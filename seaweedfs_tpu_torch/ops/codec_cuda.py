"""The hand-written CUDA coded-matmul kernel, its wrapper, its plain
PyTorch version, and the `cuda` codec backend — the counterpart of
seaweedfs_tpu/ops/codec_pallas.py.

Source note. The kernel (csrc/coded_matmul.cu) replaces the Pallas TPU
kernel `_kernel` of seaweedfs_tpu/ops/codec_pallas.py:43, launched by
`_coded_matmul_pallas_pm_impl` (`pl.pallas_call` at :100). Both compute
out[i, c] = XOR_j coef[i, j] * x[j, c] over GF(256). The Pallas kernel
does it as a bf16 bit-plane matmul with plane-major columns and host
padding to 4096 columns, both shaped by Mosaic's sublane layout. On an
H100 the function is bound by memory traffic: (k + m) * n bytes at
3.35 TB/s, against a few integer operations per byte. So the CUDA kernel
reads each input byte once in 16-byte vector loads, looks products up
in a (m, k, 256) product table staged in shared memory, XORs them into
registers, writes each output byte once, and masks the ragged edge
itself: no bit planes, no padding, no intermediate in device memory.

The wrapper `coded_matmul` runs the kernel for CUDA tensors and the
plain version `coded_matmul_plain` for CPU tensors, and for no other
reason: a CUDA tensor either launches the kernel or raises. Its launch
count is `coded_matmul.launches`.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from . import _build, gf256
from .codec_torch import TorchCodec
from ..utils.device import DEFAULT_DEVICE

_launch_lock = threading.Lock()


def product_tables(coef: np.ndarray) -> np.ndarray:
    """(m, k) coefficient bytes -> (m, k, 256) uint8 product table,
    tables[i, j, v] = coef[i, j] * v in GF(256)."""
    coef = np.asarray(coef, dtype=np.uint8)
    return np.ascontiguousarray(gf256.MUL_TABLE[coef])


def operands_from_pallas(a_pm: np.ndarray, pack: np.ndarray) -> np.ndarray:
    """Carry the Pallas codec's per-coefficient state across: its
    plane-major bit matrix (`plane_major_bit_matrix`, (8m, 8k)) and
    packing matrix (`packing_matrix`, (m, 8m)), as numpy arrays, ->
    this kernel's (m, k, 256) product table.

    Column s*k + j of the plane-major matrix multiplies bit s of shard
    j, and column t = 0 of each 8x8 block is the coefficient's own bits,
    so coef[i, j] = sum_s a_pm[8i + s, j] << s. Raises when the matrices
    are not the operands of one GF(256) coefficient matrix."""
    a = np.asarray(a_pm, dtype=np.float32)
    p = np.asarray(pack, dtype=np.float32)
    m8, k8 = a.shape
    if m8 % 8 or k8 % 8 or not m8 or not k8:
        raise ValueError(f"a_pm shape {a.shape} is not (8m, 8k)")
    m, k = m8 // 8, k8 // 8
    want_pack = np.zeros((m, m8), dtype=np.float32)
    for i in range(m):
        want_pack[i, 8 * i:8 * i + 8] = 2.0 ** np.arange(8)
    if p.shape != want_pack.shape or not np.array_equal(p, want_pack):
        raise ValueError("pack is not the packing matrix of m=%d" % m)
    if not np.isin(a, (0.0, 1.0)).all():
        raise ValueError("a_pm holds values other than 0 and 1")
    bits = a.astype(np.uint8)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    coef = (bits[:, :k].reshape(m, 8, k) * weights).sum(axis=1)
    coef = coef.astype(np.uint8)
    perm = [8 * j + s for s in range(8) for j in range(k)]
    if not np.array_equal(gf256.expand_to_bits(coef)[:, perm], bits):
        raise ValueError("a_pm is not the plane-major expansion of a "
                         "GF(256) coefficient matrix")
    return product_tables(coef)


def coded_matmul_plain(tables: torch.Tensor, x: torch.Tensor
                       ) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device:
    (m, k, 256) uint8 tables x (k, n) uint8 -> (m, n) uint8."""
    m, k = tables.shape[:2]
    out = torch.zeros((m, x.shape[1]), dtype=torch.uint8, device=x.device)
    for j in range(k):
        out ^= tables[:, j].index_select(1, x[j].long())
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("coded_matmul")
    lib.coded_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.coded_matmul_launch.restype = ctypes.c_int
    lib.coded_matmul_error_string.argtypes = [ctypes.c_int]
    lib.coded_matmul_error_string.restype = ctypes.c_char_p
    return lib


def coded_matmul(tables: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """GF(256) coded matmul: (m, k, 256) uint8 product tables (see
    product_tables) x (k, n) uint8 -> (m, n) uint8, out[i] =
    XOR_j tables[i, j][x[j]].

    CUDA tensors launch csrc/coded_matmul.cu on the current stream
    without synchronising; `x` may be a column view with any row stride.
    CPU tensors run coded_matmul_plain. Anything else raises."""
    if tables.dtype != torch.uint8 or x.dtype != torch.uint8:
        raise TypeError(f"need uint8 tensors, got {tables.dtype} and "
                        f"{x.dtype}")
    if tables.dim() != 3 or tables.shape[2] != 256:
        raise ValueError(f"tables shape {tuple(tables.shape)} is not "
                         "(m, k, 256)")
    m, k = tables.shape[:2]
    if x.dim() != 2 or x.shape[0] != k or m == 0 or k == 0:
        raise ValueError(f"x shape {tuple(x.shape)} does not match "
                         f"tables {tuple(tables.shape)}")
    if x.device != tables.device:
        raise ValueError(f"x on {x.device}, tables on {tables.device}")
    if x.device.type == "cpu":
        return coded_matmul_plain(tables, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[1]
    ldx = x.stride(0)
    if n > 1 and x.stride(1) != 1:
        raise ValueError("x rows must be contiguous (stride 1 along columns)")
    if k > 1 and ldx < n:
        raise ValueError(f"x row stride {ldx} is below its width {n}")
    if not tables.is_contiguous() or tables.data_ptr() % 16:
        raise ValueError("tables must be contiguous and 16-byte aligned")
    out = torch.empty((m, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    vec = all(v % 16 == 0 for v in (x.data_ptr(), ldx, out.data_ptr(), n))
    lib = _lib()
    stream = torch.cuda.current_stream(x.device)
    rc = lib.coded_matmul_launch(
        tables.data_ptr(), x.data_ptr(), ldx, out.data_ptr(), n, m, k, n,
        int(vec), x.device.index, stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"coded_matmul launch failed: cudaError {rc} "
            f"({lib.coded_matmul_error_string(rc).decode()})")
    with _launch_lock:
        coded_matmul.launches += 1
    return out


coded_matmul.launches = 0


class CudaCodec(TorchCodec):
    """Codec backend `cuda`: TorchCodec's feed (pinned ring, copy and
    compute streams, staged stream) around the hand-written kernel.
    Per coefficient matrix it caches the (m, k, 256) product table on
    the device. The kernel keeps no intermediate, so the default slab
    is one 32 MiB-per-shard encode block: one launch per block."""

    name = "cuda"

    def __init__(self, slab: int = 1 << 25,
                 device: str | torch.device = DEFAULT_DEVICE):
        super().__init__(slab=slab, device=device)

    def _make_mats(self, coef: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(product_tables(coef)).to(self.device)

    def _kernel(self, tables: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return coded_matmul(tables, x)
