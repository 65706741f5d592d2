#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a host with one GPU

Phases, each fatal on failure (exit code 1, no result line):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   build of every kernel in seaweedfs_tpu_torch/csrc/ with nvcc.
2. Kernel against its plain version on the card, byte for byte: RS(10,4)
   parity rows, the recovery rows for shards {1,4,11,13} and {3}, RS(28,4),
   a k=40 code (tables tiled over k), ragged widths, strided column views;
   then the kernel's time at the main path's launch shapes beside its
   memory bound and the plain version's time.
3. The main path at real size (BASELINE config #1, cut from SeaweedFS's
   30 GB volume limit to 1 GiB): write_ec_files(backend="cuda") on a
   1 GiB seeded .dat, verify_ec_files on the dense `torch` backend, a
   numpy-codec check of 64 seeded 64 KiB column windows, then
   rebuild_ec_files of shard 3 and of shards {1,4,11,13}, each hashed
   against the originals. The kernel's launch count over this phase must
   be above 0.
4. The batched step: encode_scrub_step on 64 stripes x 10 x 1 MiB; 0
   mismatches against the kernel's parity, 1 after flipping one byte.

The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
DAT_BYTES = 1 << 30             # 1 GiB volume
CHUNK = 32 << 20                # encoder.DEFAULT_CHUNK, bytes per shard


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA
    events), after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(8 << 20), b""):
            h.update(piece)
    return h.hexdigest()


def phase_device():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from seaweedfs_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"[1] built {sorted(paths)} in {time.perf_counter() - t0:.2f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[1] ptxas {name}: {line.strip()}")
    return card


def phase_kernel():
    from seaweedfs_tpu_torch.ops import codec_cuda, codec_numpy, rs_matrix

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(k, n):
        return torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=gen)

    def tables_of(coef):
        return torch.from_numpy(codec_cuda.product_tables(coef)).to(dev)

    parity = rs_matrix.parity_rows(10, 4)
    present4 = [i for i in range(14) if i not in (1, 4, 11, 13)]
    rec4, _ = rs_matrix.recovery_rows(10, 4, present4, [1, 4, 11, 13])
    rec1, _ = rs_matrix.recovery_rows(
        10, 4, [i for i in range(14) if i != 3], [3])
    cases = [
        ("rs10.4 parity n=32Mi", parity, rand(10, CHUNK)),
        ("rs10.4 recover {1,4,11,13}", rec4, rand(10, CHUNK)),
        ("rs10.4 recover {3}", rec1, rand(10, CHUNK)),
        ("rs28.4 parity", rs_matrix.parity_rows(28, 4), rand(28, 1 << 22)),
        ("k=40 m=6 parity (k-tiled, 2 output groups)",
         rs_matrix.parity_rows(40, 6), rand(40, 1 << 20)),
    ]
    for n in (1, 4095, 4097, (8 << 20) + 13):
        cases.append((f"rs10.4 parity ragged n={n}", parity, rand(10, n)))
    wide = rand(10, (1 << 20) + 64)
    cases.append(("rs10.4 parity strided aligned view",
                  parity, wide[:, 4096:4096 + 100000]))
    cases.append(("rs10.4 parity strided misaligned view",
                  parity, wide[:, 5:5 + 100003]))

    max_err = 0
    for label, coef, x in cases:
        tables = tables_of(coef)
        got = codec_cuda.coded_matmul(tables, x)
        want = codec_cuda.coded_matmul_plain(tables, x)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if x.shape[1] else 0
        # and an independent host check on a window
        w = min(x.shape[1], 65536)
        host = codec_numpy.coded_matmul(coef, x[:, :w].cpu().numpy())
        host_ok = np.array_equal(host, got[:, :w].cpu().numpy())
        log(f"[2] {label}: shape {tuple(x.shape)} -> {tuple(got.shape)}, "
            f"max |kernel - plain| = {err}, numpy window equal: {host_ok}")
        if err != 0 or not host_ok:
            fail(f"kernel disagrees with its plain version on {label}")
        max_err = max(max_err, err)

    timings = {}
    for label, coef in (("encode m=4", parity), ("rebuild m=1", rec1)):
        x = rand(10, CHUNK)
        tables = tables_of(coef)
        m, k = coef.shape
        ms = time_ms(lambda: codec_cuda.coded_matmul(tables, x), 20)
        plain_ms = time_ms(lambda: codec_cuda.coded_matmul_plain(tables, x), 3)
        bound_ms = (k + m) * CHUNK / HBM_BYTES_PER_S * 1e3
        timings[label] = (ms, plain_ms, bound_ms)
        log(f"[2] {label} k=10 n={CHUNK}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes), plain {plain_ms:.3f} ms, "
            f"{(k + m) * CHUNK / ms / 1e6:.1f} GB/s; library: none "
            f"(no single PyTorch call computes a GF(256) coded matmul)")
    return max_err, timings


def phase_main_path():
    from seaweedfs_tpu_torch.ec import geometry as geo
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                verify_ec_files,
                                                write_ec_files)
    from seaweedfs_tpu_torch.ops import codec_cuda, codec_numpy, rs_matrix
    from seaweedfs_tpu_torch.utils import metrics

    tmp = tempfile.mkdtemp(prefix="ec-smoke-")
    try:
        base = os.path.join(tmp, "1")
        rng = np.random.default_rng(SEED)
        t0 = time.perf_counter()
        with open(base + ".dat", "wb") as f:
            for _ in range(DAT_BYTES // (64 << 20)):
                f.write(rng.bytes(64 << 20))
        n_large, n_small = geo.row_layout(DAT_BYTES)
        log(f"[3] wrote {DAT_BYTES} B seeded .dat in "
            f"{time.perf_counter() - t0:.2f} s; rows: {n_large} large, "
            f"{n_small} small")

        def stage_seconds():
            return {s: metrics.counter_value(
                "ec_codec_stage_seconds_sum", {"stage": s, "backend": "cuda"})
                for s in ("pread", "pin", "h2d", "kernel", "d2h", "relay")}

        def stages_since(before, wall):
            now = stage_seconds()
            d = {s: now[s] - before[s] for s in now}
            dev = d["h2d"] + d["kernel"] + d["d2h"]
            return (f"stage seconds {json.dumps(d)}; device stages sum to "
                    f"{dev / wall:.1%} of the wall time (idle share >= "
                    f"{1 - dev / wall:.1%})")

        metrics.reset()
        codec_cuda.coded_matmul.launches = 0
        before = stage_seconds()
        t0 = time.perf_counter()
        write_ec_files(base, backend="cuda")
        t_enc = time.perf_counter() - t0
        enc_launches = codec_cuda.coded_matmul.launches
        paths = [base + geo.shard_ext(i) for i in range(14)]
        shard_size = os.path.getsize(paths[0])
        log(f"[3] encode: {t_enc:.3f} s, {DAT_BYTES / t_enc / 1e6:.1f} MB/s "
            f"(.dat bytes in), shard size {shard_size}, kernel launches "
            f"{enc_launches}, {stages_since(before, t_enc)}")
        if shard_size != geo.shard_file_size(DAT_BYTES):
            fail(f"shard size {shard_size}")
        orig = [sha256(p) for p in paths]

        t0 = time.perf_counter()
        ok = verify_ec_files(base, backend="torch")
        log(f"[3] verify_ec_files on the dense torch backend: {ok} "
            f"({time.perf_counter() - t0:.3f} s)")
        if not ok:
            fail("dense torch backend disagrees with the kernel's parity")
        maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
        parity = rs_matrix.parity_rows(10, 4)
        wrng = np.random.default_rng(SEED + 1)
        for off in wrng.integers(0, shard_size - 65536, 64):
            data = np.stack([mm[off:off + 65536] for mm in maps[:10]])
            stored = np.stack([mm[off:off + 65536] for mm in maps[10:]])
            if not np.array_equal(codec_numpy.coded_matmul(parity, data),
                                  stored):
                fail(f"numpy codec disagrees at shard offset {off}")
        del maps
        log("[3] numpy codec agrees on 64 seeded 64 KiB windows")

        for lost in ([3], [1, 4, 11, 13]):
            for i in lost:
                os.remove(paths[i])
            n_before = codec_cuda.coded_matmul.launches
            before = stage_seconds()
            t0 = time.perf_counter()
            got = rebuild_ec_files(base, backend="cuda")
            dt = time.perf_counter() - t0
            if got != lost:
                fail(f"rebuilt {got}, expected {lost}")
            bad = [i for i in lost if sha256(paths[i]) != orig[i]]
            if bad:
                fail(f"rebuilt shards {bad} differ from the originals")
            log(f"[3] rebuild {lost}: {dt:.3f} s, "
                f"{10 * shard_size / dt / 1e6:.1f} MB/s (input shard bytes "
                f"in), launches {codec_cuda.coded_matmul.launches - n_before}"
                f", hashes equal, {stages_since(before, dt)}")
        launches = codec_cuda.coded_matmul.launches
        log(f"[3] kernel launches over the main path: {launches} "
            f"(encode {enc_launches})")
        if launches <= 0:
            fail("the main path launched the kernel no time")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_batched():
    from seaweedfs_tpu_torch.models import ec_pipeline
    from seaweedfs_tpu_torch.ops import codec_cuda, rs_matrix

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    stripes = torch.randint(0, 256, (64, 10, 1 << 20), dtype=torch.uint8,
                            device=dev, generator=gen)
    tables = torch.from_numpy(
        codec_cuda.product_tables(rs_matrix.parity_rows(10, 4))).to(dev)
    expected = torch.stack([codec_cuda.coded_matmul(tables, s)
                            for s in stripes])
    a_bits = ec_pipeline.parity_bit_matrix(10, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parity, mism = ec_pipeline.encode_scrub_step(a_bits, stripes, expected)
    mism = int(mism)
    dt = time.perf_counter() - t0
    log(f"[4] encode_scrub_step 64 x 10 x 1 MiB: {dt:.3f} s "
        f"({stripes.numel() / dt / 1e6:.1f} MB/s), mismatches {mism}, "
        f"parity {tuple(parity.shape)}")
    if mism != 0:
        fail(f"scrub found {mism} mismatches on clean parity")
    expected[7, 2, 12345] ^= 1
    _, mism = ec_pipeline.encode_scrub_step(a_bits, stripes, expected)
    mism = int(mism)
    log(f"[4] after flipping one parity byte: mismatches {mism}")
    if mism != 1:
        fail(f"scrub counted {mism} mismatches after one flipped byte")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import seaweedfs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository: {e}")
    card = phase_device()
    max_err, timings = phase_kernel()
    launches = phase_main_path()
    phase_batched()
    ms, plain_ms, bound_ms = timings["encode m=4"]
    record = {"kernels": [{
        "name": "coded_matmul",
        "route": "cuda",
        "source": "seaweedfs_tpu_torch/csrc/coded_matmul.cu",
        "replaces": "seaweedfs_tpu/ops/codec_pallas.py:43",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
    }]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
