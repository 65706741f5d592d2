"""The general traffic generator: one driver per kind of operation, each
read from a traffic mix's data file (`bench_port/traffic/<mix>.json`,
key `driver`) and a configuration's file of sizes.

A driver's life in a run:
  setup()          make the seeded inputs, warm every shape the window
                   uses (set-up time)
  window(seconds)  the measured, closed loop; returns the window record
  release()        drop the program's state
  check()          the plain reference over the same inputs, after the
                   window -> {name: (value, limit)} and the failed count

Drivers
  scrub  the computation of `ec.verify -sampleMB 0 -backend <backend>`
         (shell/commands_ec.py `ec_verify`) over one volume sealed at
         set-up: each shard's bytes whole, as its holder serves them,
         stacked as `ec_verify` stacks them, and `ReedSolomon.verify`;
         one pass in `corrupt_every` has a seeded byte of a seeded shard
         flipped and restored after; a pass in flight at the deadline is
         finished and the window ends with it; every verdict is compared
         with the reference's verdict on the same stored bytes, and the
         stored shards with the reference's encode of the seeded volume.
"""
from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .reference import codes, encode
from .roofline import product_bytes

GB = 1e9


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from the run's seed and a path of ints."""
    ss = np.random.SeedSequence([seed & ((1 << 64) - 1), *path])
    return int(ss.generate_state(1, dtype=np.uint64)[0] & ((1 << 63) - 1))


def seeded_bytes(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """n uniform bytes on `device`, from a generator on that device."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(0, 256, (n,), dtype=torch.uint8, device=device,
                         generator=g)


def codec_seconds(op: str, label: str) -> float:
    """The codec's summed call seconds so far (ec_codec_seconds{op})."""
    from seaweedfs_tpu_torch.utils import metrics

    return metrics.counter_value("ec_codec_seconds_sum",
                                 {"op": op, "backend": label})


class Driver:
    """What every driver shares: the run's context and the volume files
    in a directory of its own under TMPDIR."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.config
        self.traffic = ctx.traffic
        self.k, self.m = codes.shard_counts(self.config)
        self.coef = codes.parity_rows(self.config)
        self.dir = tempfile.mkdtemp(prefix="bench-port-")

    def cleanup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)

    def _write_dat(self, path: str, seed: int) -> None:
        data = seeded_bytes(int(self.config["volume_bytes"]), seed,
                            self.ctx.device).cpu().numpy()
        with open(path, "wb") as f:
            f.write(memoryview(data))
            # written back now, at set-up, and not under the window
            f.flush()
            os.fsync(f.fileno())

    def _shard_len(self) -> int:
        return encode.shard_bytes(int(self.config["volume_bytes"]),
                                  int(self.config["large_block_bytes"]),
                                  int(self.config["small_block_bytes"]),
                                  self.k)

    def _ref_data(self, dat: torch.Tensor) -> torch.Tensor:
        return encode.data_shards(dat.to(self.ctx.device), self.k,
                                  int(self.config["large_block_bytes"]),
                                  int(self.config["small_block_bytes"]))

    def _seal_kwargs(self) -> dict:
        return dict(backend=self.ctx.backend,
                    large_block=int(self.config["large_block_bytes"]),
                    small_block=int(self.config["small_block_bytes"]),
                    chunk=int(self.traffic["chunk_bytes"]),
                    codec=self.config["codec_spec"])


class ScrubDriver(Driver):
    def setup(self) -> None:
        from seaweedfs_tpu_torch.ec import encoder, geometry
        from seaweedfs_tpu_torch.ec.backend import ReedSolomon

        self.rs_class = ReedSolomon
        self.code = geometry.parse_code(self.config["codec_spec"])
        base = os.path.join(self.dir, "1")
        self._write_dat(base + ".dat", sub_seed(self.ctx.seed, 1, 0))
        encoder.write_ec_files(base, **self._seal_kwargs())
        os.remove(base + ".dat")
        self.paths = [f"{base}.ec{i:02d}" for i in range(self.k + self.m)]
        self.fds = [os.open(p, os.O_RDWR) for p in self.paths]
        for fd in self.fds:
            os.fsync(fd)
        self.shard_len = self._shard_len()
        self.corrupt_every = int(self.traffic["corrupt_every"])
        self._flips: dict[int, tuple[int, int, int, int]] = {}
        self.fetch_s = 0.0
        self._verify()                                  # warm-up

    def flip_for(self, i: int) -> tuple[int, int, int] | None:
        """(shard, offset, xor mask) flipped in pass i, or None: one seeded
        pass in every `corrupt_every`."""
        blk = i // self.corrupt_every
        if blk not in self._flips:
            rng = np.random.default_rng(sub_seed(self.ctx.seed, 4, blk))
            self._flips[blk] = (int(rng.integers(self.corrupt_every)),
                                int(rng.integers(self.k + self.m)),
                                int(rng.integers(self.shard_len)),
                                int(rng.integers(1, 256)))
        at, shard, off, mask = self._flips[blk]
        return (shard, off, mask) if i % self.corrupt_every == at else None

    def _xor_byte(self, shard: int, off: int, mask: int) -> None:
        fd = self.fds[shard]
        b = os.pread(fd, 1, off)[0]
        os.pwrite(fd, bytes([b ^ mask]), off)

    def _fetch(self) -> np.ndarray:
        """The (k + m, n) stack that `ec_verify` verifies: each shard's
        bytes whole, as `/admin/ec/shard_read` returns them to it,
        stacked as it stacks them."""
        t0 = time.perf_counter()
        shards = []
        for p in self.paths:
            with open(p, "rb") as f:
                shards.append(np.frombuffer(f.read(), dtype=np.uint8))
        n = min(len(s) for s in shards)
        stack = np.stack([s[:n] for s in shards])
        self.fetch_s += time.perf_counter() - t0
        return stack

    def _verify(self) -> bool:
        stack = self._fetch()
        rs = self.rs_class(self.k, self.m, backend=self.ctx.backend,
                           code=self.code)
        return bool(rs.verify(stack))

    def window(self, seconds: float) -> dict:
        label = self.traffic["codec_label"]
        self.passes, op_s = [], []
        self.fetch_s = 0.0
        codec0 = codec_seconds("encode", label)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            flip = self.flip_for(i)
            t_op = time.perf_counter()
            if flip:
                self._xor_byte(*flip)
            try:
                verdict, err = self._verify(), None
            except Exception as e:  # noqa: BLE001 - a failed pass
                verdict, err = None, e
            finally:
                if flip:
                    self._xor_byte(*flip)
            self.passes.append((flip, verdict, err))
            op_s.append(time.perf_counter() - t_op)
            i += 1
            if time.perf_counter() >= deadline:
                break
        t_end = time.perf_counter()
        n = len(self.passes)
        pass_bytes = (self.k + self.m) * self.shard_len
        return {"values": {self.traffic["rate_metric"]:
                           n * pass_bytes / (t_end - t0) / GB},
                "attempted": n, "span_s": t_end - t0, "op_s": op_s,
                "bytes": n * pass_bytes, "fetch_s": self.fetch_s,
                "codec_s": codec_seconds("encode", label) - codec0,
                "product_bytes": n * product_bytes(self.k, self.m,
                                                   self.shard_len)}

    def release(self) -> None:
        self.rs_class = None

    def cleanup(self) -> None:
        for fd in getattr(self, "fds", []):
            os.close(fd)
        self.fds = []
        super().cleanup()

    def check(self) -> tuple[dict, int]:
        k = self.k
        shards = torch.stack([
            torch.from_numpy(np.fromfile(p, dtype=np.uint8))
            for p in self.paths]).to(self.ctx.device)
        parity = encode.coded_matmul(self.coef, shards[:k])
        bad = (parity != shards[k:]).any(dim=0)
        n_bad = int(bad.sum())
        # the shards the program sealed at set-up, against the reference's
        # own encode of the same seeded volume
        data = self._ref_data(seeded_bytes(int(self.config["volume_bytes"]),
                                           sub_seed(self.ctx.seed, 1, 0),
                                           self.ctx.device))
        sealed = int((data != shards[:k]).sum()) + int(
            (encode.coded_matmul(self.coef, data) != shards[k:]).sum())
        del data
        differing = 0
        for flip, verdict, err in self.passes:
            if flip is None:
                want = n_bad == 0
            else:
                s, off, mask = flip
                col = shards[:, off].clone()
                col[s] ^= mask
                got = encode.coded_matmul(self.coef, col[:k, None])[:, 0]
                want = (n_bad - int(bad[off]) == 0
                        and bool(torch.equal(got, col[k:])))
            differing += int(err is not None or verdict != want)
        return {"verdicts_differing": (differing, 0),
                "sealed_bytes_differing": (sealed, 0)}, differing


DRIVERS = {"scrub": ScrubDriver}
