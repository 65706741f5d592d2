"""Device-mesh helpers for the codec data plane — the counterpart of
seaweedfs_tpu/parallel/mesh.py.

Stripes of independent volumes ride a `vol` (data-parallel) mesh axis
and the columns of a stripe ride a `col` axis. Encode and rebuild are
column-local, so each device computes its piece alone; the scrub count
and the sharded rebuild's partial sums meet in collectives.

The mesh is single-controller, as the reference's is: one process
drives every local card, each through its own streams. A `Mesh` is a
grid of `torch.device`s with the reference's axis names. On the CPU it
is a grid of `torch.device("cpu")` entries (CPU_DEVICES of them, the
host device count the reference's tests force on JAX), and every piece
runs the plain version of its device code there.

In place of NamedSharding, a sharded array is a `Sharded`: per-device
tensors, each with the index of the global array it holds. Pieces are
contiguous near-equal splits, so no array needs padding to divide the
mesh; `pad_to_mesh` stays for callers that want the reference's
divisible shapes.

The collectives run inside the process: NCCL (`torch.cuda.nccl`) over a
CUDA mesh, one tensor per card; on a CPU mesh, their plain version (a
sum over the per-device tensors, then the split).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..utils.device import resolve_device

VOL_AXIS = "vol"
COL_AXIS = "col"
SHARD_AXIS = "shard"

# production mesh shape knobs (-ec.mesh.devices / -ec.mesh.col set
# these; the MeshCodec reads them at construction)
DEVICES_ENV = "SEAWEEDFS_TPU_EC_MESH_DEVICES"
COL_ENV = "SEAWEEDFS_TPU_EC_MESH_COL"

# devices of a CPU mesh
CPU_DEVICES = 8


class Mesh:
    """A grid of torch.devices with named axes: (vol, col) for the codec,
    (shard,) for the sharded rebuild. `devices` is a numpy object array;
    `devices.flat` is the device order of every per-device list."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        self.devices = devices
        self.axis_names = axis_names

    @property
    def device_list(self) -> list[torch.device]:
        return list(self.devices.flat)

    @property
    def platform(self) -> str:
        return "gpu" if self.devices.flat[0].type == "cuda" else "cpu"


class Sharded:
    """An array held as per-device pieces: pieces[i] = (tensor, index),
    tensor on the mesh's device i holding array[index] (a tuple of
    slices), the torch form of a jax array with a NamedSharding."""

    def __init__(self, pieces: list[tuple[torch.Tensor, tuple]],
                 shape: tuple[int, ...], dtype: torch.dtype):
        self.pieces = pieces
        self.shape = tuple(shape)
        self.dtype = dtype

    def gather(self) -> torch.Tensor:
        """The whole array on the host."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for t, idx in self.pieces:
            out[idx] = t.cpu()
        return out


def mesh_config() -> tuple[int | None, int | None]:
    """(n_devices, col_parallel) from the environment; None means the
    defaults (all local devices / the make_mesh heuristic). Garbage
    values are ignored, not fatal — a bad flag must not take down a
    volume server whose CPU codec still works."""
    def _positive_int(name: str) -> int | None:
        v = os.environ.get(name, "").strip()
        if not v:
            return None
        try:
            n = int(v)
        except ValueError:
            return None
        return n if n > 0 else None

    return _positive_int(DEVICES_ENV), _positive_int(COL_ENV)


def describe(mesh: Mesh) -> dict:
    """Operator-facing mesh geometry for /debug/ec and the probe: device
    count, (vol, col) shape, platform."""
    vol, col = (int(x) for x in mesh.devices.shape)
    return {"devices": int(mesh.devices.size), "vol": vol, "col": col,
            "platform": mesh.platform}


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """Every device a mesh on `device`'s platform may use: each visible
    card (raises without one), or CPU_DEVICES host entries."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")] * CPU_DEVICES


def device_grid(n_devices: int | None = None,
                device: str | torch.device = "cuda") -> np.ndarray:
    """The first n devices of `device`'s platform (all of them by
    default) as a 1-D numpy object array."""
    devs = local_devices(device)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devs[:n]
    return grid


def make_mesh(n_devices: int | None = None,
              col_parallel: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """A (vol, col) mesh over the first n devices of `device`'s platform.

    col_parallel defaults to 2 when n is even and > 1 (so both axes are
    exercised), else 1.
    """
    grid = device_grid(n_devices, device)
    n = grid.size
    if col_parallel is None:
        col_parallel = 2 if (n % 2 == 0 and n > 1) else 1
    if n % col_parallel:
        raise ValueError(f"{n} devices not divisible by col={col_parallel}")
    return Mesh(grid.reshape(n // col_parallel, col_parallel),
                (VOL_AXIS, COL_AXIS))


def split(n: int, parts: int) -> list[slice]:
    """`parts` contiguous pieces of range(n), ceil(n / parts) long; the
    last ones may be short or empty."""
    per = -(-n // parts)
    return [slice(min(i * per, n), min((i + 1) * per, n))
            for i in range(parts)]


def stripe_slices(mesh: Mesh, batch: int, cols: int
                  ) -> list[tuple[slice, slice]]:
    """(batch slice, column slice) of a (batch, k, cols) stripe block on
    each mesh device, in device order: batch over vol, columns over col
    (the placement of the reference's stripe_sharding)."""
    vol, col = mesh.devices.shape
    return [(bs, cs) for bs in split(batch, vol) for cs in split(cols, col)]


def column_slices(mesh: Mesh, n: int) -> list[slice]:
    """The MeshCodec's split of a (k, n) block: vol * col column pieces
    in device order — vol segments, each cut over col, as the
    reference's _to_batched lays them out."""
    return split(n, int(mesh.devices.size))


def shard_stripes(mesh: Mesh, arr) -> Sharded:
    """Place a (batch, k, cols) host array over the mesh (the reference's
    device_put with stripe_sharding)."""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"])) \
        if isinstance(arr, np.ndarray) else arr
    pieces = [(t[bs, :, cs].to(dev), (bs, slice(None), cs))
              for dev, (bs, cs) in zip(mesh.device_list,
                                       stripe_slices(mesh, t.shape[0],
                                                     t.shape[2]))]
    return Sharded(pieces, tuple(t.shape), t.dtype)


def replicate(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """One copy of `t` per mesh device (the reference's replicated
    sharding)."""
    return [t.to(dev) for dev in mesh.device_list]


def pad_to_mesh(arr: np.ndarray, mesh: Mesh, batch_axis: int = 0,
                col_axis: int = 2) -> tuple[np.ndarray, tuple[int, int]]:
    """Zero-pad (batch, k, cols)-shaped host data so both sharded dims
    divide the mesh. Returns (padded, (orig_batch, orig_cols)); callers
    slice outputs back with those. Zero stripes encode to zero parity,
    so padding never perturbs scrub results."""
    vol, col = mesh.devices.shape
    b, c = arr.shape[batch_axis], arr.shape[col_axis]
    pb = -(-b // vol) * vol
    pc = -(-c // col) * col
    if (pb, pc) == (b, c):
        return arr, (b, c)
    shape = list(arr.shape)
    shape[batch_axis], shape[col_axis] = pb, pc
    out = np.zeros(shape, dtype=arr.dtype)
    sl = [slice(None)] * arr.ndim
    sl[batch_axis], sl[col_axis] = slice(0, b), slice(0, c)
    out[tuple(sl)] = np.asarray(arr)
    return out, (b, c)


# ----------------------------------------------------------------------
# collectives: one tensor per mesh device, in device order
# ----------------------------------------------------------------------

def all_reduce_sum(tensors: list[torch.Tensor], streams=None) -> None:
    """In place: every tensor becomes the sum of all of them. CUDA
    tensors (one per distinct card) go through one NCCL all-reduce,
    enqueued on `streams` (one per tensor; default: each card's current
    stream); CPU tensors are summed directly."""
    if tensors[0].is_cuda:
        torch.cuda.nccl.all_reduce(tensors, streams=streams)
        return
    total = torch.stack(tensors).sum(dim=0, dtype=tensors[0].dtype)
    for t in tensors:
        t.copy_(total)


def reduce_scatter_sum(inputs: list[torch.Tensor],
                       outputs: list[torch.Tensor], streams=None) -> None:
    """outputs[i] = chunk i of the sum of `inputs`, chunks being the d
    equal contiguous pieces of an input's memory. CUDA tensors go
    through one NCCL reduce-scatter; CPU tensors are summed and split."""
    if inputs[0].is_cuda:
        torch.cuda.nccl.reduce_scatter(inputs, outputs, streams=streams)
        return
    total = torch.stack(inputs).sum(dim=0, dtype=inputs[0].dtype)
    total = total.reshape(len(outputs), -1)
    for i, out in enumerate(outputs):
        out.copy_(total[i].view(out.shape))
