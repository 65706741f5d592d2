"""The hand-written CUDA coded-matmul kernel, its wrapper, its plain
PyTorch version, and the `cuda` codec backend — the counterpart of
seaweedfs_tpu/ops/codec_pallas.py.

Source note. The kernel (csrc/coded_matmul.cu) replaces the Pallas TPU
kernel `_kernel` of seaweedfs_tpu/ops/codec_pallas.py:43, launched by
`_coded_matmul_pallas_pm_impl` (`pl.pallas_call` at :100). Both compute
out[i, c] = XOR_j coef[i, j] * x[j, c] over GF(256). The Pallas kernel
does it as a bf16 bit-plane matmul with plane-major columns and host
padding to 4096 columns, both shaped by Mosaic's sublane layout. On an
H100 the least time is the bytes, (k + m) * n at 3.35 TB/s; above it the
product lookups bind, through shared-memory wavefronts (random table
addresses conflict in the banks) and instruction issue. So the operand
is a packed product table (`packed_tables`): one uint32 word per (output
group of 4 rows, input row, byte value) holding the 4 products, so one
lookup serves 4 output rows. The kernel stages it in shared memory,
streams the input through a ring of shared-memory stages filled by bulk
asynchronous copies, XORs into registers, writes each output byte once,
and masks the ragged edge itself: no bit planes, no padding, no
intermediate in device memory. The source note in the .cu gives the
reckoning.

The wrapper `coded_matmul` runs the kernel for CUDA tensors and the
plain version `coded_matmul_plain` for CPU tensors, and for no other
reason: a CUDA tensor either launches the kernel or raises. Its launch
count is `coded_matmul.launches`, and per card
`coded_matmul.launches_by_device`. A launch leaves the calling thread's
current device as it found it, so one thread may launch on every card of
a mesh.
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

# Table rows one launch keeps in shared memory (kMaxK in the .cu); a
# larger k runs as several launches that XOR into the output.
MAX_K_PER_LAUNCH = 64


def packed_tables(coef: np.ndarray) -> np.ndarray:
    """(m, k) coefficient bytes -> (ceil(m/4), k, 256) int32 packed
    product table: byte o of word [g, j, v] is coef[4g + o, j] * v in
    GF(256), and 0 for rows 4g + o >= m. (int32 holds the uint32 bits,
    since torch indexes int32 and not uint32.)"""
    coef = np.asarray(coef, dtype=np.uint8)
    if coef.ndim != 2 or not coef.size:
        raise ValueError(f"coef shape {coef.shape} is not (m, k)")
    m, k = coef.shape
    groups = -(-m // 4)
    prod = np.zeros((4 * groups, k, 256), dtype=np.uint32)
    prod[:m] = gf256.MUL_TABLE[coef]
    prod = prod.reshape(groups, 4, k, 256)
    packed = (prod[:, 0] | prod[:, 1] << 8 | prod[:, 2] << 16
              | prod[:, 3] << 24)
    return np.ascontiguousarray(packed).view(np.int32)


def operands_from_pallas(a_pm: np.ndarray, pack: np.ndarray) -> np.ndarray:
    """Carry the Pallas codec's per-coefficient state across: its
    plane-major bit matrix (`plane_major_bit_matrix`, (8m, 8k)) and
    packing matrix (`packing_matrix`, (m, 8m)), as numpy arrays, ->
    this kernel's packed product table (`packed_tables`), for
    m = pack.shape[0] output rows.

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
    return packed_tables(coef)


def coded_matmul_plain(tables: torch.Tensor, x: torch.Tensor, m: int
                       ) -> torch.Tensor:
    """The kernel's function in plain torch ops, on any device:
    (ceil(m/4), k, 256) int32 packed tables x (k, n) uint8 -> (m, n)
    uint8."""
    groups, k = tables.shape[:2]
    acc = torch.zeros((groups, x.shape[1]), dtype=torch.int32,
                      device=x.device)
    for j in range(k):
        acc ^= tables[:, j].index_select(1, x[j].long())
    out = torch.empty((groups, 4, x.shape[1]), dtype=torch.uint8,
                      device=x.device)
    for o in range(4):
        out[:, o] = (acc >> (8 * o)) & 0xff
    return out.reshape(4 * groups, -1)[:m]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("coded_matmul")
    lib.coded_matmul_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.coded_matmul_launch.restype = ctypes.c_int
    lib.coded_matmul_error_string.argtypes = [ctypes.c_int]
    lib.coded_matmul_error_string.restype = ctypes.c_char_p
    return lib


def _aligned(*values: int) -> bool:
    return all(v % 16 == 0 for v in values)


def coded_matmul(tables: torch.Tensor, x: torch.Tensor, m: int,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """GF(256) coded matmul: (ceil(m/4), k, 256) int32 packed product
    tables (see packed_tables) x (k, n) uint8 -> (m, n) uint8,
    out[4g + o] = byte o of XOR_j tables[g, j][x[j]].

    CUDA tensors launch csrc/coded_matmul.cu on x's device, on that
    device's current stream, without synchronising; `x` may be a column view with any row stride
    (full tiles stream through the kernel's bulk-copy ring when x and its
    row stride are 16-byte aligned, the rest through its direct-load
    path). `out`, when given, is the (m, n) uint8 result on x's device,
    with any row stride; it is written and returned (the caller
    allocates it ahead, e.g. outside a timed window). CPU tensors run
    coded_matmul_plain. Anything else raises."""
    if tables.dtype != torch.int32 or x.dtype != torch.uint8:
        raise TypeError(f"need int32 tables and uint8 x, got {tables.dtype}"
                        f" and {x.dtype}")
    if tables.dim() != 3 or tables.shape[2] != 256:
        raise ValueError(f"tables shape {tuple(tables.shape)} is not "
                         "(ceil(m/4), k, 256)")
    groups, k = tables.shape[:2]
    if m < 1 or not 4 * groups - 4 < m <= 4 * groups:
        raise ValueError(f"m={m} does not match {groups} packed groups")
    if x.dim() != 2 or x.shape[0] != k or k == 0:
        raise ValueError(f"x shape {tuple(x.shape)} does not match "
                         f"tables {tuple(tables.shape)}")
    if x.device != tables.device:
        raise ValueError(f"x on {x.device}, tables on {tables.device}")
    n = x.shape[1]
    if out is not None:
        if out.dtype != torch.uint8 or out.device != x.device or \
                tuple(out.shape) != (m, n):
            raise ValueError(f"out {out.dtype} {tuple(out.shape)} on "
                             f"{out.device} is not uint8 ({m}, {n}) on "
                             f"{x.device}")
        if n > 1 and out.stride(1) != 1 or m > 1 and out.stride(0) < n:
            raise ValueError(f"out strides {out.stride()} do not hold "
                             f"contiguous rows of {n}")
    if x.device.type == "cpu":
        if out is None:
            return coded_matmul_plain(tables, x, m)
        return out.copy_(coded_matmul_plain(tables, x, m))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ldx = x.stride(0)
    if n > 1 and x.stride(1) != 1:
        raise ValueError("x rows must be contiguous (stride 1 along columns)")
    if k > 1 and ldx < n:
        raise ValueError(f"x row stride {ldx} is below its width {n}")
    if not tables.is_contiguous() or tables.data_ptr() % 16:
        raise ValueError("tables must be contiguous and 16-byte aligned")
    if out is None:
        out = torch.empty((m, n), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(x.device)
    ldo = out.stride(0) if m > 1 else n
    vec_out = _aligned(out.data_ptr(), ldo)
    for j0 in range(0, k, MAX_K_PER_LAUNCH):
        kc = min(MAX_K_PER_LAUNCH, k - j0)
        xp = x.data_ptr() + j0 * ldx
        ring = _aligned(xp, ldx if kc > 1 else 0)
        rc = lib.coded_matmul_launch(
            tables.data_ptr() + j0 * 1024, k * 256, xp, ldx,
            out.data_ptr(), ldo, m, kc, n, int(ring), int(vec_out),
            int(j0 > 0),
            x.device.index, stream.cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"coded_matmul launch failed: cudaError {rc} "
                f"({lib.coded_matmul_error_string(rc).decode()})")
        with _launch_lock:
            coded_matmul.launches += 1
            by_dev = coded_matmul.launches_by_device
            by_dev[x.device.index] = by_dev.get(x.device.index, 0) + 1
    return out


def reset_launches() -> None:
    """Set the launch counts (total and per card) to 0."""
    with _launch_lock:
        coded_matmul.launches = 0
        coded_matmul.launches_by_device = {}


coded_matmul.launches = 0
coded_matmul.launches_by_device = {}


class CudaCodec(TorchCodec):
    """Codec backend `cuda`: TorchCodec's feed (pinned ring, copy and
    compute streams, staged stream) around the hand-written kernel.
    Per coefficient matrix it caches the packed product table and m on
    the device. The kernel keeps no intermediate, so the default slab
    is one 32 MiB-per-shard encode block: one launch per block."""

    name = "cuda"

    def __init__(self, slab: int = 1 << 25,
                 device: str | torch.device = DEFAULT_DEVICE):
        super().__init__(slab=slab, device=device)

    def _make_mats(self, coef: np.ndarray) -> tuple[torch.Tensor, int]:
        tables = torch.from_numpy(packed_tables(coef)).to(self.device)
        return tables, coef.shape[0]

    def _kernel(self, mats: tuple[torch.Tensor, int], x: torch.Tensor,
                out: torch.Tensor | None = None) -> torch.Tensor:
        tables, m = mats
        return coded_matmul(tables, x, m, out=out)

    def _plan_for(self, coef, nbytes):
        # the kernel reads each input byte once and writes each output
        # byte once; the scheduled XOR program never applies here (as
        # PallasCodec._plan_for)
        return None
