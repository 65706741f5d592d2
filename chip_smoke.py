#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a host with one GPU

Phases, each fatal on failure (exit code 1, no result line):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   build of every kernel in seaweedfs_tpu_torch/csrc/ with nvcc.
2. Kernel against its plain version on the card, byte for byte, on every
   path of the kernel: RS(10,4) parity rows, the recovery rows for shards
   {1,4,11,13} and {3}, RS(28,4) and k=40 (a tile's rows over several ring
   stages), k=70 (two launches, the second XORing into the output), random
   codes with m in {1, 2, 3, 5, 8} (partly filled packed words, two output
   groups), ragged widths ending mid-tile and mid-stage, a 16-byte-aligned
   strided view (bulk-copy ring) and a misaligned one (direct-load path),
   and the result written into an aligned and a misaligned `out=` view;
   then the kernel's time at the main path's launch shapes (encode m=4,
   rebuild m=1 and m=4, RS(28,4) encode) beside its memory bound and the
   plain version's time, with nvidia-smi sampling the SM clock and power
   over the window.
3. The main path at real size (BASELINE config #1, cut from SeaweedFS's
   30 GB volume limit to 1 GiB): write_ec_files(backend="cuda") on a
   1 GiB seeded .dat, verify_ec_files on the dense `torch` backend, a
   numpy-codec check of 64 seeded 64 KiB column windows, then
   rebuild_ec_files of shard 3 and of shards {1,4,11,13}, each hashed
   against the originals. The kernel's launch count over this phase must
   be above 0.
4. The batched step: encode_scrub_step on 64 stripes x 10 x 1 MiB; 0
   mismatches against the kernel's parity, 1 after flipping one byte.
5. The measured router and the EC lifecycle, with the probe cache in the
   run's temporary directory (so the sweep is always fresh):
   a. probe.get_curve(refresh=True): the size x depth sweep of the feed
      (1, 4, 16, 64 MiB x depths 1, 2, 4) with its transfer-only
      ceilings, and the CPU codec's rate; every row printed with its
      feed-stage seconds beside the kernel's own launch time at that
      width (CUDA events). Fatal: device backend not `cuda`, no measured
      row, or no kernel launch during the sweep.
   b. The router's decisions at 1 MiB, 64 MiB and 1 GiB and its buckets.
   c. Phase 3's seeded 1 GiB .dat (same seed) encoded with
      backend="cuda", "native" (the native whole-file encode) and "auto",
      each twice, in the order cuda, native, auto, auto, native, cuda,
      into fresh shard files; the shard sets must be hash-equal, and each
      encode must have recorded its `ec.write_ec_files` span with `peer`
      = the backend it ran on.
   d. The torch backend's scheduled XOR program (schedule pinned on)
      byte-equal to the kernel on 4 seeded blocks; then the chooser's
      measured verdict on a 4 MiB sample, with both times.
   e. A seeded .idx tiling the .dat with needle records (overwrites and
      tombstones included) -> write_sorted_ecx; find_dat_size must give
      back the .dat size; shards {0, 5, 11} deleted; write_dat_file with
      backend="cuda" must rebuild a .dat sha256-equal to the original
      through the kernel; write_idx_from_ecx (one .ecj deletion) must
      write the .ecx's entries plus that tombstone.
6. The Store the volume server calls, at 1 GiB: Store([dir],
   ec_backend="cuda"), seeded needles (1 KiB - 1 MiB, log-uniform; 5% of
   writes overwrite an earlier id, then 2% of ids deleted) until the .dat
   holds 1 GiB; mark_readonly, generate_ec_shards through the kernel
   (launches > 0), mount all 14 shards and hash them, delete the volume;
   read every live needle (bytes and cookie equal, deleted ids raise
   KeyError, 1% more deleted through the .ecj raise too); delete shards
   {0, 5, 11} and read every needle again (intervals of shards 0 and 5
   reconstruct on the CPU codec, as the reference routes single-interval
   reads); rebuild_ec_shards through the kernel (launches > 0), remount,
   rebuilt shards sha256-equal, a last read pass. One line per step with
   wall s, MB/s, reads/s, p50 / p99 read latency, launches and the feed's
   stage seconds.

8. The mesh and the batched feeds, on every card torch sees (one card:
   a (1, 1) mesh; four: (2, 2)):
   a. MeshCodec: coded_matmul byte-equal to the kernel on one card
      (RS(10,4) and RS(28,4) parity, the recovery rows of {1,4,11,13};
      n = 32 Mi + 777 and 1); write_ec_files(backend="mesh") on phase
      3's seeded 1 GiB .dat, shards sha256-equal to phase 3's;
      rebuild_ec_files(backend="mesh") of {1,4,11,13}, sha256-equal;
      kernel launches > 0 on every card of the mesh.
   b. pipelined_encode_stream, BASELINE config #3 at full size: 64 x
      1 GiB volumes, RS(10,4), depth 2, 208 blocks of (8, 10, <= 4 Mi)
      from a pool of 4 seeded blocks, each result equal to the native
      codec's parity of its pool block; with mesh=None and with the
      mesh; then the same bytes through the kernel's route
      (CudaCodec.coded_matmul_stream per volume) and its transfer-only
      ceiling (and, with more than one card, the mesh codec's route and
      ceiling). MB/s and stage seconds of each.
   c. pipelined_scrub over the same blocks (BASELINE config #5, cut
      from 1000 volumes to 64), without and with the mesh: 0 mismatches
      clean; with one byte flipped in one pool entry's parity, as many
      mismatches as that entry was fed.
   d. sharded_rebuild over rebuild_mesh(), shards {0,3,11,13} missing,
      (10, 32 Mi) shards: byte-equal to the kernel's reconstruction; the
      per-device product and the reduce-scatter timed apart (CUDA
      events).
   e. sharded_encode_scrub over make_mesh() on (64, 10, 1 Mi): 0
      mismatches, 1 after one flipped byte.
   f. The current device is what it was before phase 8; with more than
      one card, the probe's mesh rows beside its single-card rows and
      the router's choice at 1 MiB, 64 MiB and 1 GiB.

9. The self-healing plane: a master and five volume servers over three
   racks (rA, rA, rB, rB, rC) on "cuda", pulse 0.5 s, the redundancy
   watchdog's repairs enabled (scan interval 1 s, grace 10 s, which
   rides out ec.encode's server-by-server mounts). Every repair is the
   watchdog's own; a failed one, one during ec.encode, or a deficit
   still open at its deadline, fails the run.
   a. Phase 7's seeded 1 GiB volume (its writer, its seed) through
      ec.encode; the 14 shards hashed; the server with the fewest
      shards (at most m = 4) stopped. Detection seconds (kill ->
      UnderParity lists the volume) and repair seconds (-> 14 live
      shards), the kernel's launches during the repair (> 0), the
      repair metrics; rebuilt shards sha256-equal, every live needle
      read back over HTTP.
   b. One byte flipped mid-shard on disk; ec.verify -sample_mb=0
      -backend=cuda must answer verified false, that shard, quarantined
      and repair_enqueued; its wall and MB/s over the 14 shards; the
      watchdog's rebuild launches the kernel (> 0), sha256-equal, and a
      second ec.verify passes.
   c. A 256 MiB volume with replication 010; one byte flipped in one
      needle of one replica's .dat; volume.scrub reports that replica
      bad, unmounts it and enqueues a repair; the watchdog's
      volume.fix.replication restores 2 replicas; every needle reads
      equal from both (host only).
   d. 30% of c's needles deleted; /vol/vacuum?garbageThreshold=0.2
      compacts both replicas to exactly their live records, every read
      equal, every deleted needle 404; after volume.vacuum.disable,
      /vol/vacuum answers 409.

10. S3 objects through the filer into erasure-coded volumes: the same
   five servers over three racks with a sqlite filer and the S3 gateway
   in the process, pulse 0.5 s, the watchdog's repairs enabled at grace
   0 (interval 1 s). A failed repair other than a refused lock, a
   repair during ec.encode, or a deficit open at its deadline fails
   the run.
   a. SigV4-signed PUTs of 80 objects of 10 MiB (warp's default size,
      two 8 MiB filer chunks each), one 160 MiB object by multipart
      (10 x 16 MiB parts) and 4,096 objects of 1-64 KiB (every 8th
      seeded .json text, stored gzipped), at least 1 GiB in all; MB/s,
      objects/s, p50 / p99; the large objects read back from the plain
      volumes.
   b. A shell with the filer takes `lock` through the filer's DLM, runs
      ec.encode on every volume of the bucket's collection under the
      live watchdog, then `unlock`: no rebuild during the encodes, each
      shard listed once, launches equal to the encodes' own, and the
      repair attempts the lock refused; ec.verify -sample_mb=0
      -backend=cuda of every volume clean.
   c. The server holding the fewest shards stopped: detection and
      repair seconds (deficit -> 14 live shards everywhere, grace 0),
      the watchdog's rebuilds through the kernel (launches > 0), and a
      seeded sample of objects read through S3 from the kill on
      (degraded reads; reads/s, p50 / p99).
   d. Every object read back through S3 over the EC shards, md5 and
      ETag as at PUT (the multipart one's as CompleteMultipartUpload
      gave it); seeded Range GETs of the multipart object;
      ListObjectsV2 by pages gives exactly the key set; DeleteObjects
      of a seeded tenth, and the listing drops exactly those.

11. Raft-replicated masters and a leader failover, in the layout of
   k8s/seaweedfs-tpu.yaml: three masters, each a process of `python -m
   seaweedfs_tpu_torch master -peers A,B,C -raftDir D` (pulse 0.5 s,
   volume limit 1 GiB, the watchdog's repairs enabled at grace 0,
   interval 1 s); in this process five volume servers over three racks
   on "cuda" with every master in -mserver, and a sqlite filer.
   a. Seconds to one stable leader.
   b. A 1 GiB volume filled over HTTP with every /vol/grow and
      /dir/assign sent to a follower (307 to the leader), then ec.encode
      from a shell whose master list names the follower first, under
      the filer's DLM lock: launches > 0, no repair during the encode.
   c. The leader SIGKILLed: seconds to a new leader, seconds until it
      lists the five servers and the 14 shards; the repairs it queued
      and the kernel's launches from the kill through its repair hold
      (5 pulses) must both be 0, and every heartbeat goes to it.
   d. The server with the fewest shards stopped: the new leader's
      watchdog rebuilds them (detection and repair seconds, launches
      > 0), sha256-equal; every needle read back over HTTP from a holder
      located through a master list that names the dead leader first.
   e. /vol/grow gives a volume id above every master's mark before the
      kill; no needle key assigned after the failover (64 single, 8
      batches of 128) equals one assigned before; the killed master,
      restarted from its -raftDir, is a follower with the leader's max
      volume id; a `master.follower` process answers /dir/lookup for the
      EC volume by volume id and by fid from its KeepConnected cache.
   f. The current device is what it was before phase 11.

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
import threading
import time
import xml.etree.ElementTree as ET

import numpy as np
import torch

SEED = 20261017
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
DAT_BYTES = 1 << 30             # 1 GiB volume
CHUNK = 32 << 20                # encoder.DEFAULT_CHUNK, bytes per shard
CARD = "cuda"                   # the device phase 5 times the kernel on


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


def write_seeded_dat(path: str) -> float:
    """The main path's seeded 1 GiB .dat; -> seconds taken."""
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    with open(path, "wb") as f:
        for _ in range(DAT_BYTES // (64 << 20)):
            f.write(rng.bytes(64 << 20))
    return time.perf_counter() - t0


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for piece in iter(lambda: f.read(8 << 20), b""):
            h.update(piece)
    return h.hexdigest()


def feed_stage_seconds(backend: str = "cuda") -> dict:
    """A feed's stage seconds so far (ec_codec_stage_seconds), by its
    backend label."""
    from seaweedfs_tpu_torch.utils import metrics

    return {s: metrics.counter_value(
        "ec_codec_stage_seconds_sum", {"stage": s, "backend": backend})
        for s in ("pread", "pin", "h2d", "kernel", "d2h", "relay")}


def stages_since(before: dict, wall: float, backend: str = "cuda") -> str:
    now = feed_stage_seconds(backend)
    d = {s: now[s] - before[s] for s in now}
    dev = d["h2d"] + d["kernel"] + d["d2h"]
    return (f"stage seconds {json.dumps(d)}; device stages sum to "
            f"{dev / wall:.1%} of the wall time (idle share >= "
            f"{1 - dev / wall:.1%})")


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
    from seaweedfs_tpu_torch import native

    t0 = time.perf_counter()
    lib = native.load()._name
    log(f"[1] built the native host codec {os.path.basename(lib)} in "
        f"{time.perf_counter() - t0:.2f} s (SIMD level "
        f"{native.simd_level()}: 3 = AVX2)")
    return card


def sample_clocks():
    """Start nvidia-smi sampling the SM clock, power draw and limit every
    100 ms; stop() -> the samples as (MHz, W, W) tuples."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader,nounits", "-lms", "100", "-i", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    first = proc.stdout.readline()   # sampling has started

    def stop():
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
        samples = []
        for line in [first, *out.splitlines()]:
            try:
                samples.append(tuple(float(v) for v in line.split(",")))
            except ValueError:
                pass
        return samples

    return stop


def phase_kernel():
    from seaweedfs_tpu_torch.ops import codec_cuda, codec_numpy, rs_matrix

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)

    def rand(k, n):
        return torch.randint(0, 256, (k, n), dtype=torch.uint8, device=dev,
                             generator=gen)

    def tables_of(coef):
        return torch.from_numpy(codec_cuda.packed_tables(coef)).to(dev)

    def random_coef(m, k):
        return rng.integers(0, 256, (m, k), dtype=np.uint8)

    parity = rs_matrix.parity_rows(10, 4)
    present4 = [i for i in range(14) if i not in (1, 4, 11, 13)]
    rec4, _ = rs_matrix.recovery_rows(10, 4, present4, [1, 4, 11, 13])
    rec1, _ = rs_matrix.recovery_rows(
        10, 4, [i for i in range(14) if i != 3], [3])
    rec3, _ = rs_matrix.recovery_rows(
        10, 4, [i for i in range(14) if i not in (0, 5, 11)], [0, 5, 11])
    tile = 4096   # columns per kernel tile (kTile in the .cu)
    cases = [
        ("rs10.4 parity n=32Mi", parity, rand(10, CHUNK)),
        ("rs10.4 recover {1,4,11,13}", rec4, rand(10, CHUNK)),
        ("rs10.4 recover {3}", rec1, rand(10, CHUNK)),
        ("rs10.4 recover {0,5,11} (phase 6's rebuild)", rec3,
         rand(10, CHUNK)),
        ("rs28.4 parity (2 ring stages per tile)",
         rs_matrix.parity_rows(28, 4), rand(28, 1 << 22)),
        ("k=40 m=6 parity (3 ring stages per tile, 2 output groups)",
         rs_matrix.parity_rows(40, 6), rand(40, 1 << 20)),
        ("k=70 m=4 random (2 launches, the second XORs into the output)",
         random_coef(4, 70), rand(70, (1 << 18) + 48)),
        ("k=1 m=3 random", random_coef(3, 1), rand(1, (1 << 20) + 5)),
    ]
    for m in (1, 2, 3, 5, 8):
        cases.append((f"k=10 m={m} random", random_coef(m, 10),
                      rand(10, (1 << 22) + 16 * 37)))
    for n in (1, 4095, 4097, (8 << 20) + 13):
        cases.append((f"rs10.4 parity ragged n={n}", parity, rand(10, n)))
    cases.append(("rs10.4 parity, ends mid-tile, 16-byte aligned width",
                  parity, rand(10, 5 * tile + 16 * 7)))
    cases.append(("rs28.4 parity, ends mid-stage and mid-tile",
                  rs_matrix.parity_rows(28, 4), rand(28, 3 * tile + 1001)))
    wide = rand(10, (1 << 20) + 64)
    cases.append(("rs10.4 parity strided aligned view (bulk ring)",
                  parity, wide[:, 4096:4096 + 100000]))
    cases.append(("rs10.4 parity strided misaligned view (direct path)",
                  parity, wide[:, 5:5 + 100003]))
    cases.append(("k=5 m=2 random strided aligned view, ragged",
                  random_coef(2, 5), wide[:5, 32:32 + 3 * tile + 999]))

    max_err = 0
    bad = []
    for label, coef, x in cases:
        m = coef.shape[0]
        tables = tables_of(coef)
        got = codec_cuda.coded_matmul(tables, x, m)
        want = codec_cuda.coded_matmul_plain(tables, x, m)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max()) if x.shape[1] else 0
        # and an independent host check on a window
        w = min(x.shape[1], 65536)
        host = codec_numpy.coded_matmul(coef, x[:, :w].cpu().numpy())
        host_ok = np.array_equal(host, got[:, :w].cpu().numpy())
        log(f"[2] {label}: shape {tuple(x.shape)} -> {tuple(got.shape)}, "
            f"max |kernel - plain| = {err}, numpy window equal: {host_ok}")
        if err != 0 or not host_ok:
            bad.append(label)
        max_err = max(max_err, err)
    # out= with a row stride above the width (a slab of a wider output),
    # aligned and misaligned: only the view's bytes may change
    for off in (4096, 3):
        x = rand(10, (1 << 20) + 77)
        tables = tables_of(parity)
        outer = torch.zeros((4, (2 << 20) + 4096), dtype=torch.uint8,
                            device=dev)
        view = outer[:, off:off + x.shape[1]]
        codec_cuda.coded_matmul(tables, x, 4, out=view)
        want = codec_cuda.coded_matmul_plain(tables, x, 4)
        torch.cuda.synchronize()
        err = int((view.int() - want.int()).abs().max())
        rest = int(outer[:, :off].any()) + int(outer[:, off +
                                                     x.shape[1]:].any())
        log(f"[2] rs10.4 parity into an out= view at column {off} of a "
            f"{tuple(outer.shape)} tensor: max |kernel - plain| = {err}, "
            f"bytes outside the view touched: {bool(rest)}")
        if err or rest:
            bad.append(f"out= view at {off}")
        max_err = max(max_err, err)
    if bad:
        fail(f"kernel disagrees with its plain version on {bad}")

    timings = {}
    stop = sample_clocks()
    for label, coef in (("encode m=4", parity), ("rebuild m=1", rec1),
                        ("rebuild m=4", rec4),
                        ("encode k=28 m=4", rs_matrix.parity_rows(28, 4))):
        m, k = coef.shape
        x = rand(k, CHUNK)
        tables = tables_of(coef)
        ms = time_ms(lambda: codec_cuda.coded_matmul(tables, x, m), 200)
        plain_ms = time_ms(
            lambda: codec_cuda.coded_matmul_plain(tables, x, m), 3)
        bound_ms = (k + m) * CHUNK / HBM_BYTES_PER_S * 1e3
        timings[label] = (ms, plain_ms, bound_ms)
        log(f"[2] {label} k={k} n={CHUNK}: kernel {ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms (bytes), {bound_ms / ms:.1%} of "
            f"bound, plain {plain_ms:.3f} ms, "
            f"{(k + m) * CHUNK / ms / 1e6:.1f} GB/s; library: none "
            f"(no single PyTorch call computes a GF(256) coded matmul)")
        if label == "encode m=4":
            # yardsticks for the memory system's practical rate on this
            # card: a device copy and a read-only reduction of the input
            copy_ms = time_ms(lambda: x.clone(), 200)
            xs = x.view(torch.int64)
            sum_ms = time_ms(lambda: xs.sum(dim=1), 200)
            log(f"[2] yardsticks on the same (10, {CHUNK}) input: clone "
                f"{copy_ms:.4f} ms ({2 * x.numel() / copy_ms / 1e9:.3f} TB/s"
                f" moved), int64 row sums {sum_ms:.4f} ms "
                f"({x.numel() / sum_ms / 1e9:.3f} TB/s read)")
    samples = stop()
    if samples:
        clk = sorted(s[0] for s in samples)
        pw = sorted(s[1] for s in samples)
        log(f"[2] nvidia-smi over the timing window, {len(samples)} samples:"
            f" SM clock min/median/max {clk[0]:.0f}/{clk[len(clk) // 2]:.0f}"
            f"/{clk[-1]:.0f} MHz, power draw median {pw[len(pw) // 2]:.1f} W"
            f" (max {pw[-1]:.1f} W), limit {samples[0][2]:.2f} W")
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
        dt = write_seeded_dat(base + ".dat")
        n_large, n_small = geo.row_layout(DAT_BYTES)
        log(f"[3] wrote {DAT_BYTES} B seeded .dat in {dt:.2f} s; rows: "
            f"{n_large} large, {n_small} small")

        metrics.reset()
        codec_cuda.coded_matmul.launches = 0
        before = feed_stage_seconds()
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
            before = feed_stage_seconds()
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
        return launches, orig
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
        codec_cuda.packed_tables(rs_matrix.parity_rows(10, 4))).to(dev)
    expected = torch.stack([codec_cuda.coded_matmul(tables, s, 4)
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


def _latest_span(name: str) -> dict | None:
    from seaweedfs_tpu_torch.utils import tracing

    spans = [sp for tr in tracing.traces_json(limit=50)
             for sp in tr["spans"] if sp["name"] == name]
    return max(spans, key=lambda sp: sp["start"]) if spans else None


def _seeded_idx(path: str, seed: int) -> tuple[int, int]:
    """An .idx whose needle records tile a DAT_BYTES .dat from offset 8
    (after the superblock): ~5% of records overwrite an earlier key, then
    ~2% of keys get a tombstone; the last record stays live, so the
    volume's end is its end. -> (entries, live keys)."""
    from seaweedfs_tpu_torch.ec import decoder
    from seaweedfs_tpu_torch.storage import idx as idxmod
    from seaweedfs_tpu_torch.storage import types as t

    rng = np.random.default_rng(seed)
    off, rows, keys = 8, [], []
    while off < DAT_BYTES:
        disk = int(rng.integers(4096, 1 << 20)) // 8 * 8
        if DAT_BYTES - off - disk < 4096:
            disk = DAT_BYTES - off
        size = disk - 29      # the size whose padded record is `disk`
        if decoder.needle_entry_disk_size(size) != disk:
            fail(f"needle size {size} does not pad to {disk}")
        if keys and rng.random() < 0.05 and off + disk < DAT_BYTES:
            key = keys[int(rng.integers(0, len(keys)))]
        else:
            key = int(rng.integers(1, 1 << 40))
            keys.append(key)
        rows.append((key, t.actual_to_offset(off), size))
        off += disk
    last = rows[-1][0]
    dead = {k for k in keys if k != last and rng.random() < 0.02}
    rows += [(k, 0, t.size_to_u32(t.TOMBSTONE_SIZE)) for k in sorted(dead)]
    idxmod.write_index(path, np.array(rows, dtype=idxmod.IDX_DTYPE))
    return len(rows), len(set(keys) - dead)


def phase_router_lifecycle():
    """Phase 5 -> (sweep launches, decode launches)."""
    from seaweedfs_tpu_torch.ec import backend as ecb
    from seaweedfs_tpu_torch.ec import decoder, encoder, probe
    from seaweedfs_tpu_torch.ec import geometry as geo
    from seaweedfs_tpu_torch.ops import codec_cuda, codec_torch, rs_matrix
    from seaweedfs_tpu_torch.storage import idx as idxmod

    tmp = tempfile.mkdtemp(prefix="ec-smoke5-")
    os.environ["SEAWEEDFS_TPU_EC_PROBE_CACHE"] = os.path.join(
        tmp, "ec_probe.json")
    try:
        # a. the sweep
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        curve = probe.get_curve(refresh=True)
        sweep_wall = time.perf_counter() - t0
        sweep_launches = codec_cuda.coded_matmul.launches
        log(f"[5a] sweep: {sweep_wall:.2f} s wall ({curve['sweep_seconds']}"
            f" s inside run_sweep), device {json.dumps(curve['device'])}, "
            f"device_backend {curve['device_backend']}, cpu_backend "
            f"{curve['cpu_backend']} at {curve['cpu_mbps']} MB/s, kernel "
            f"launches {sweep_launches}; cache {probe.cache_path()}")
        dev = torch.device(CARD)
        tables = torch.from_numpy(codec_cuda.packed_tables(
            rs_matrix.parity_rows(10, 4))).to(dev)
        launch_ms = {}
        for size in probe.SWEEP_SIZES:
            x = torch.randint(0, 256, (10, size // 10), dtype=torch.uint8,
                              device=dev)
            launch_ms[size] = time_ms(
                lambda: codec_cuda.coded_matmul(tables, x, 4), 50)
        for r in curve["rows"]:
            if "e2e_mbps" not in r:
                log(f"[5a] row {json.dumps(r)}")
                continue
            st = r["stages_s"]
            log(f"[5a] size {r['size'] >> 20} MiB depth {r['depth']} "
                f"blocks {r['blocks']}: e2e {r['e2e_mbps']} MB/s, ceiling "
                f"{r['xfer_ceiling_mbps']} MB/s, vs_ceiling "
                f"{r['vs_ceiling']}; kernel stage "
                f"{st['kernel'] / r['blocks'] * 1e3:.4f} ms per block vs "
                f"{launch_ms[r['size']]:.4f} ms per launch (CUDA events, "
                f"10 x {r['size'] // 10}); stages "
                f"{json.dumps({k: round(v, 6) for k, v in st.items()})}")
        if curve["device_backend"] != "cuda":
            fail(f"device backend {curve['device_backend']}, not cuda")
        if any("error" in r for r in curve["rows"]):
            fail("a sweep row recorded an error")
        if not probe.measured_rows(curve):
            fail("the sweep measured no device row")
        if sweep_launches <= 0:
            fail("the sweep launched the kernel no time")

        # b. decisions
        for nbytes in (1 << 20, 64 << 20, 1 << 30):
            log(f"[5b] {nbytes >> 20} MiB: choose_backend_for_size -> "
                f"{ecb.choose_backend_for_size(nbytes)}, "
                f"pipeline_depth_for -> {ecb.pipeline_depth_for(nbytes)}, "
                f"device e2e {probe.e2e_mbps_at(curve, nbytes):.1f} MB/s "
                f"vs cpu {curve['cpu_mbps']} MB/s")
        for b in ecb.router_buckets(curve):
            log(f"[5b] bucket {json.dumps(b)}")

        # c. one volume, three encodes, each twice in mirrored order
        from seaweedfs_tpu_torch.utils import metrics

        base = os.path.join(tmp, "5")
        write_seeded_dat(base + ".dat")
        paths = [base + geo.shard_ext(i) for i in range(14)]
        hashes = {}
        for backend in ("cuda", "native", "auto", "auto", "native", "cuda"):
            for p in paths:     # every encode writes fresh shard files
                if os.path.exists(p):
                    os.remove(p)
            n0 = codec_cuda.coded_matmul.launches
            stages0 = {st: metrics.counter_value(
                "ec_codec_stage_seconds_sum", {"stage": st,
                                               "backend": "cuda"})
                for st in probe.STAGES}
            t0 = time.perf_counter()
            encoder.write_ec_files(base, backend=backend)
            dt = time.perf_counter() - t0
            chosen = (ecb.get_backend("auto").chosen if backend == "auto"
                      else backend)
            stages = {st: round(metrics.counter_value(
                "ec_codec_stage_seconds_sum", {"stage": st,
                                               "backend": "cuda"})
                - stages0[st], 6) for st in probe.STAGES}
            sp = _latest_span("ec.write_ec_files")
            got = [sha256(p) for p in paths]
            if hashes.setdefault(backend, got) != got:
                fail(f"backend {backend} wrote other shards the second time")
            log(f"[5c] encode backend={backend}"
                f"{f' (chose {chosen})' if backend == 'auto' else ''}: "
                f"{dt:.3f} s, {DAT_BYTES / dt / 1e6:.1f} MB/s, kernel "
                f"launches {codec_cuda.coded_matmul.launches - n0}, span "
                f"peer {sp and sp['peer']!r}, duration "
                f"{sp and round(sp['duration'], 4)} s; cuda feed stage "
                f"seconds {json.dumps(stages)}")
            if sp is None or sp["peer"] != chosen or \
                    sp["start"] < time.time() - dt - 5:
                fail(f"no ec.write_ec_files span with peer {chosen!r}")
        if not hashes["cuda"] == hashes["native"] == hashes["auto"]:
            bad = [i for i in range(14) if len({hashes[b][i]
                                                for b in hashes}) > 1]
            fail(f"shard sets differ between backends at shards {bad}")
        log("[5c] cuda, native and auto shard sets are hash-equal")

        # d. the scheduled XOR program on the card
        parity = rs_matrix.parity_rows(10, 4)
        rng = np.random.default_rng(SEED + 4)
        blocks = [rng.integers(0, 256, (10, (1 << 20) + 13 * i),
                               dtype=np.uint8) for i in range(4)]
        kern = ecb.get_backend("cuda")
        want = [kern.coded_matmul(parity, b) for b in blocks]
        os.environ["SEAWEEDFS_TPU_EC_SCHEDULE"] = "on"
        sched = codec_torch.TorchCodec()
        t0 = time.perf_counter()
        got = list(sched.coded_matmul_stream(parity, iter(blocks)))
        dt = time.perf_counter() - t0
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        log(f"[5d] torch backend, schedule on: 4 blocks of 10 x ~1 MiB in "
            f"{dt:.3f} s, byte-equal to the kernel: {same}")
        if not same or len(got) != 4:
            fail("the scheduled XOR program disagrees with the kernel")
        os.environ["SEAWEEDFS_TPU_EC_SCHEDULE"] = "auto"
        chooser_codec = codec_torch.TorchCodec()
        sample = rng.integers(0, 256, (10, (4 << 20) // 10), dtype=np.uint8)
        if not np.array_equal(chooser_codec.coded_matmul(parity, sample),
                              kern.coded_matmul(parity, sample)):
            fail("torch backend disagrees with the kernel on the sample")
        deadline = time.monotonic() + 300
        while chooser_codec._chooser.snapshot()["measuring"]:
            if time.monotonic() > deadline:
                fail("the chooser's measurement did not finish")
            time.sleep(0.05)
        snap = chooser_codec._chooser.snapshot()
        for v in snap["verdicts"]:
            log(f"[5d] chooser verdict at the 4 MiB sample (bucket "
                f"2^{v['bucket']} B): scheduled {v['scheduled']}; "
                f"scheduled {v['sched_s'] * 1e3:.3f} ms, dense "
                f"{v['dense_s'] * 1e3:.3f} ms")
        if snap["failed"] or not snap["verdicts"]:
            fail(f"chooser measurement failed: {snap}")

        # e. .ecx, decode through the kernel, .idx
        n_entries, n_live = _seeded_idx(base + ".idx", SEED + 5)
        encoder.write_sorted_ecx(base)
        ecx = idxmod.read_index(base + ".ecx")
        dat_size = decoder.find_dat_size(base)
        log(f"[5e] .idx {n_entries} entries -> .ecx {len(ecx)} live "
            f"(expected {n_live}); find_dat_size {dat_size}")
        if dat_size != DAT_BYTES or len(ecx) != n_live:
            fail(f"find_dat_size {dat_size} / .ecx {len(ecx)} entries")
        orig = sha256(base + ".dat")
        os.remove(base + ".dat")
        for i in (0, 5, 11):
            os.remove(paths[i])
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        decoder.write_dat_file(base, dat_size, backend="cuda")
        dt = time.perf_counter() - t0
        decode_launches = codec_cuda.coded_matmul.launches
        same = sha256(base + ".dat") == orig
        log(f"[5e] write_dat_file with shards {{0, 5, 11}} gone: {dt:.3f} s"
            f", {DAT_BYTES / dt / 1e6:.1f} MB/s, kernel launches "
            f"{decode_launches}, sha256 equal to the original: {same}, "
            f"parity shard 11 left absent: "
            f"{not os.path.exists(paths[11])}")
        if not same:
            fail("the decoded .dat differs from the original")
        if decode_launches <= 0:
            fail("the decode launched the kernel no time")
        gone = int(ecx["key"][len(ecx) // 2])
        decoder.append_ecj(base, gone)
        decoder.write_idx_from_ecx(base)
        idx = idxmod.read_index(base + ".idx")
        ok = (np.array_equal(idx[:len(ecx)], ecx) and len(idx) == len(ecx) + 1
              and int(idx["key"][-1]) == gone and int(idx["offset"][-1]) == 0
              and decoder.read_ecj(base) == [gone])
        log(f"[5e] write_idx_from_ecx: {len(idx)} entries = the .ecx's "
            f"{len(ecx)} + 1 tombstone: {ok}")
        if not ok:
            fail("write_idx_from_ecx did not reproduce the .ecx entries")
        return sweep_launches, decode_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _read_pass(store, live: dict, label: str) -> dict:
    """Read every live needle through Store.read_needle with its cookie;
    fail on any byte or cookie mismatch. -> wall, bytes and per-read
    latencies (host clock)."""
    lat = np.empty(len(live))
    nbytes = 0
    t0 = time.perf_counter()
    for i, (key, (cookie, digest)) in enumerate(live.items()):
        r0 = time.perf_counter()
        n = store.read_needle(1, key, cookie)
        lat[i] = time.perf_counter() - r0
        if n.cookie != cookie or \
                hashlib.sha256(n.data).hexdigest() != digest:
            fail(f"{label}: needle {key} read back other bytes")
        nbytes += len(n.data)
    wall = time.perf_counter() - t0
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    return {"wall": wall, "bytes": nbytes, "p50_ms": p50, "p99_ms": p99}


def _expect_gone(store, keys, label: str) -> None:
    for key in keys:
        try:
            store.read_needle(1, key)
        except KeyError:
            continue
        fail(f"{label}: deleted needle {key} still reads")


def phase_store():
    """Phase 6: the Store the volume server calls, at 1 GiB. -> kernel
    launches of (generate_ec_shards, rebuild_ec_shards)."""
    from seaweedfs_tpu_torch.ec import geometry as geo
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.storage.needle import Needle
    from seaweedfs_tpu_torch.storage.store import Store

    tmp = tempfile.mkdtemp(prefix="ec-smoke6-")
    try:
        store = Store([tmp], ec_backend="cuda")
        vol = store.add_volume(1)
        base = vol.file_name()
        rng = np.random.default_rng(SEED + 6)
        lo, hi = np.log(1 << 10), np.log(1 << 20)
        live: dict[int, tuple[int, str]] = {}
        writes = overwrites = 0
        t0 = time.perf_counter()
        while vol.content_size() < DAT_BYTES:
            data = rng.bytes(int(np.exp(rng.uniform(lo, hi))))
            if live and rng.random() < 0.05:
                keys = list(live)
                key = keys[int(rng.integers(0, len(keys)))]
                overwrites += 1
            else:
                key = int(rng.integers(1, 1 << 48))
            cookie = int(rng.integers(0, 1 << 32))
            store.write_needle(1, Needle(id=key, cookie=cookie, data=data))
            live[key] = (cookie, hashlib.sha256(data).hexdigest())
            writes += 1
        dead = [int(k) for k in rng.choice(list(live), len(live) // 50,
                                           replace=False)]
        for key in dead:
            store.delete_needle(1, key)
            del live[key]
        dt = time.perf_counter() - t0
        dat_size = vol.content_size()
        log(f"[6] 1. Store([dir], ec_backend='cuda'), add_volume(1); "
            f"{writes} writes ({overwrites} overwrites, sizes log-uniform "
            f"1 KiB - 1 MiB), {len(dead)} deletes: {len(live)} live "
            f"needles, .dat {dat_size} B, {dt:.3f} s, "
            f"{dat_size / dt / 1e6:.1f} MB/s")

        store.mark_readonly(1)
        before = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        store.generate_ec_shards(1)
        dt = time.perf_counter() - t0
        gen_launches = codec_cuda.coded_matmul.launches
        sp = _latest_span("ec.write_ec_files")
        log(f"[6] 3. generate_ec_shards(1) (fsync of the .dat, .dat -> 14 "
            f"shards, .ecx): {dt:.3f} s, {dat_size / dt / 1e6:.1f} MB/s "
            f"(.dat bytes in), of which the ec.write_ec_files span "
            f"{sp and round(sp['duration'], 4)} s (peer {sp and sp['peer']!r}"
            f"), kernel launches {gen_launches}, {stages_since(before, dt)}")
        if sp is None or sp["peer"] != "cuda":
            fail("generate_ec_shards recorded no ec.write_ec_files span on "
                 "the cuda backend")
        if gen_launches <= 0:
            fail("generate_ec_shards launched the kernel no time")
        store.mount_ec_shards(1, "", range(14))
        paths = [base + geo.shard_ext(i) for i in range(14)]
        orig = [sha256(p) for p in paths]
        store.delete_volume(1)
        if os.path.exists(base + ".dat"):
            fail("delete_volume left the .dat behind")
        log(f"[6] 3. mounted shards 0-13 ({os.path.getsize(paths[0])} B "
            f"each), hashed them, deleted volume 1: every read now goes "
            f"through the EC volume")

        recon = []
        real = store._reconstruct_interval

        def counted(ecv, sid, off, size):
            recon.append(size)
            return real(ecv, sid, off, size)

        store._reconstruct_interval = counted
        for step, label in ((4, "all 14 shards"),
                            (5, "shards {0, 5, 11} lost")):
            if step == 5:
                store.delete_ec_shards(1, [0, 5, 11])
            n0, r0 = codec_cuda.coded_matmul.launches, len(recon)
            st = _read_pass(store, live, f"step {step}")
            log(f"[6] {step}. read {len(live)} live needles, {label}: "
                f"{st['wall']:.3f} s, {st['bytes'] / st['wall'] / 1e6:.1f} "
                f"MB/s, {len(live) / st['wall']:.1f} reads/s, latency p50 "
                f"{st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms; "
                f"intervals reconstructed {len(recon) - r0} "
                f"({sum(recon[r0:])} B, CPU codec), kernel launches "
                f"{codec_cuda.coded_matmul.launches - n0}")
            if step == 4:
                _expect_gone(store, dead, "step 4")
                more = list(live)[::100]
                for key in more:
                    store.delete_needle(1, key)
                    del live[key]
                _expect_gone(store, more, "step 4 (.ecj)")
                log(f"[6] 4. {len(dead)} ids deleted before sealing and "
                    f"{len(more)} deleted through the .ecj raise KeyError")
        if len(recon) == 0:
            fail("no interval was reconstructed with shards 0 and 5 lost")

        before = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        rebuilt = store.rebuild_ec_shards(1)
        dt = time.perf_counter() - t0
        reb_launches = codec_cuda.coded_matmul.launches
        shard_size = os.path.getsize(paths[1])
        log(f"[6] 6. rebuild_ec_shards(1) -> {rebuilt}: {dt:.3f} s, "
            f"{10 * shard_size / dt / 1e6:.1f} MB/s (input shard bytes "
            f"in), kernel launches {reb_launches}, "
            f"{stages_since(before, dt)}")
        if rebuilt != [0, 5, 11]:
            fail(f"rebuilt {rebuilt}, expected [0, 5, 11]")
        if reb_launches <= 0:
            fail("rebuild_ec_shards launched the kernel no time")
        store.mount_ec_shards(1, "", [0, 5, 11])
        bad = [i for i in (0, 5, 11) if sha256(paths[i]) != orig[i]]
        if bad:
            fail(f"rebuilt shards {bad} differ from the originals")
        r0 = len(recon)
        st = _read_pass(store, live, "step 6")
        log(f"[6] 6. remounted {{0, 5, 11}}, sha256-equal to step 3's; "
            f"read {len(live)} needles: {st['wall']:.3f} s, "
            f"{len(live) / st['wall']:.1f} reads/s, p50 {st['p50_ms']:.3f}"
            f" ms p99 {st['p99_ms']:.3f} ms, intervals reconstructed "
            f"{len(recon) - r0}")
        if len(recon) != r0:
            fail("reads after the remount still reconstructed")
        store.close()
        return gen_launches, reb_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _http_read_pass(server: str, live: dict, label: str) -> dict:
    """GET every live needle from `server` over HTTP; fail on any status
    or byte mismatch. -> wall, bytes and per-read latencies (host clock)."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    lat = np.empty(len(live))
    nbytes = 0
    t0 = time.perf_counter()
    for i, (fid, digest) in enumerate(live.items()):
        r0 = time.perf_counter()
        r = session().get(f"http://{server}/{fid}", timeout=(5.0, 60.0))
        body = r.content
        lat[i] = time.perf_counter() - r0
        if r.status_code != 200 or \
                hashlib.sha256(body).hexdigest() != digest:
            fail(f"{label}: GET {fid} from {server} gave status "
                 f"{r.status_code} and other bytes")
        nbytes += len(body)
    wall = time.perf_counter() - t0
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    return {"wall": wall, "bytes": nbytes, "p50_ms": p50, "p99_ms": p99}


def sha256_prefix(path: str, size: int) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while size > 0:
            piece = f.read(min(8 << 20, size))
            if not piece:
                break
            h.update(piece)
            size -= len(piece)
    return h.hexdigest()


def _records(path: str, start: int, end: int) -> list[tuple[int, int, int]]:
    """(offset, needle id, record bytes) of the records in [start, end)
    of a .dat."""
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage import types as t

    out = []
    with open(path, "rb") as f:
        off = start
        while off < end:
            f.seek(off)
            head = f.read(t.NEEDLE_HEADER_SIZE)
            key = int.from_bytes(head[4:12], "big")
            size = t.u32_to_size(int.from_bytes(head[12:16], "big"))
            out.append((off, key, ndl.disk_size(max(size, 0))))
            off += out[-1][2]
    return out


def _shard_paths(cluster, vid: int) -> dict[int, str]:
    """{shard id: file} of every mounted shard of `vid` in the cluster."""
    out = {}
    for store in cluster.stores:
        ecv = store.ec_volumes.get(vid)
        for sid, shard in (ecv.shards.items() if ecv else ()):
            out[sid] = shard.path
    return out


def _fill_volume_http(cluster, env, collection: str, seed: int,
                      target: int, replication: str = "") -> dict:
    """Grow one volume of `collection` and fill it with seeded needles
    through assign + upload over HTTP until its .dat holds `target`
    bytes (1 KiB - 1 MiB log-uniform; 5% of writes overwrite an earlier
    id), then delete 2% of the ids. -> vid, the primary's url and
    Volume, {fid: sha256} of the live needles, the deleted fids, and
    the counts and seconds of the writes."""
    from seaweedfs_tpu_torch.operation import verbs

    grown = env.master_get("/vol/grow", collection=collection, count=1,
                           **({"replication": replication}
                              if replication else {}))
    if grown.get("count") != 1:
        fail(f"/vol/grow answered {grown}")
    rng = np.random.default_rng(seed)
    lo, hi = np.log(1 << 10), np.log(1 << 20)
    live: dict[str, str] = {}
    writes = overwrites = 0
    vid, vol, url = None, None, None
    t0 = time.perf_counter()
    while vol is None or vol.content_size() < target:
        data = rng.bytes(int(np.exp(rng.uniform(lo, hi))))
        if live and rng.random() < 0.05:
            fids = list(live)
            fid = fids[int(rng.integers(0, len(fids)))]
            overwrites += 1
        else:
            a = verbs.assign(env.master_url, collection=collection,
                             replication=replication)
            fid = a.fid
            if vid is None:
                vid, url = int(fid.split(",")[0]), a.url
                vol = next(s.find_volume(vid) for s in cluster.stores
                           if s.has_volume(vid) and
                           f"{s.ip}:{s.port}" == url)
            elif int(fid.split(",")[0]) != vid or a.url != url:
                fail(f"assign left volume {vid}: {fid} on {a.url}")
        verbs.upload(f"http://{url}/{fid}", data)
        live[fid] = hashlib.sha256(data).hexdigest()
        writes += 1
    dead = [live_fid for live_fid in rng.choice(
        sorted(live), len(live) // 50, replace=False)]
    for fid in dead:
        verbs.delete(f"http://{url}/{fid}")
        del live[fid]
    return {"vid": vid, "url": url, "vol": vol, "live": live,
            "dead": dead, "writes": writes, "overwrites": overwrites,
            "seconds": time.perf_counter() - t0}


def phase_cluster(card: str) -> dict:
    """Phase 7: the master, three volume servers and the shell over HTTP
    at 1 GiB. -> kernel launches of each shell command."""
    from seaweedfs_tpu_torch.ec import geometry as geo
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import commands_ec, repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.storage import types as t
    from seaweedfs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ec-smoke7-")
    cluster = Cluster(tmp, n_volume_servers=3, max_volumes=8,
                      volume_size_limit=2 * DAT_BYTES, ec_backend="cuda")
    launches: dict[str, int] = {}
    try:
        master = cluster.master_url
        env = CommandEnv(master)
        log(f"[7] {card}")
        log(f"[7] Cluster: master {master}, volume servers "
            f"{[th.address for th in cluster.volume_threads]}, "
            f"ec_backend='cuda', volume size limit {2 * DAT_BYTES} B")
        w = _fill_volume_http(cluster, env, "smoke7", SEED + 7, DAT_BYTES)
        vid, url, vol, live, dead = (w["vid"], w["url"], w["vol"],
                                     w["live"], w["dead"])
        writes, overwrites, dt = w["writes"], w["overwrites"], w["seconds"]
        dat_path = vol.file_name() + ".dat"
        dat_size = vol.content_size()
        sealed = sha256(dat_path)
        # a decode ends at the last live needle's record (SeaweedFS's
        # FindDatFileSize): what comes back is this prefix, and the tail
        # past it holds only records of deleted needles
        keys = {t.parse_file_id(f)[1] for f in live}
        gone = {t.parse_file_id(f)[1] for f in dead}
        recs = _records(dat_path, vol.super_block.block_size, dat_size)
        live_end = max(off + n for off, key, n in recs if key in keys)
        tail = [key for off, key, n in recs if off >= live_end]
        prefix = sha256_prefix(dat_path, live_end)
        if not set(tail) <= gone:
            fail("the sealed .dat holds live needles past its last live one")
        log(f"[7] 2. volume {vid} on {url}: {writes} uploads over HTTP "
            f"({overwrites} overwrites, 1 KiB - 1 MiB log-uniform), "
            f"{len(dead)} deletes: {len(live)} live needles, .dat "
            f"{dat_size} B, {dt:.3f} s, {dat_size / dt / 1e6:.1f} MB/s; "
            f"sealed .dat sha256 {sealed[:16]}")

        def shell(line: str, op: str, fn=None) -> tuple[dict, float]:
            before = feed_stage_seconds()
            codec_cuda.coded_matmul.launches = 0
            t0 = time.perf_counter()
            out = fn() if fn is not None else repl.run_command(env, line)
            dt = time.perf_counter() - t0
            launches[op] = codec_cuda.coded_matmul.launches
            if feed_stage_seconds() != before:
                stages = stages_since(before, dt)
            else:
                stages = ("no stage of the staged feed ran: its codec "
                          "calls went to CudaCodec.coded_matmul chunk by "
                          "chunk")
            log(f"[7] {line}: {dt:.3f} s, kernel launches {launches[op]}, "
                f"{stages}")
            if launches[op] <= 0:
                fail(f"{line} launched the kernel no time")
            return out, dt

        def reads(step: int, server: str, label: str) -> None:
            n0 = codec_cuda.coded_matmul.launches
            f0, r0 = len(fetched), len(recon)
            st = _http_read_pass(server, live, f"step {step}")
            log(f"[7] {step}. GET {len(live)} live needles from {server}, "
                f"{label}: {st['wall']:.3f} s, "
                f"{st['bytes'] / st['wall'] / 1e6:.1f} MB/s, "
                f"{len(live) / st['wall']:.1f} reads/s, latency p50 "
                f"{st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms; remote "
                f"shard intervals fetched over ec/shard_read "
                f"{len(fetched) - f0} ({sum(fetched[f0:])} B), intervals "
                f"reconstructed {len(recon) - r0} ({sum(recon[r0:])} B, "
                f"CPU codec), kernel launches "
                f"{codec_cuda.coded_matmul.launches - n0}")
            if codec_cuda.coded_matmul.launches != n0:
                fail(f"step {step}: a read pass launched the kernel")

        # 3. ec.encode through the shell
        repl.run_command(env, "lock")
        placement, dt = shell(f"ec.encode -volumeId={vid}", "encode")
        log(f"[7] 3. ec.encode: {dat_size / dt / 1e6:.1f} MB/s (.dat bytes "
            f"in); placement {placement}")
        if any(s.has_volume(vid) for s in cluster.stores):
            fail("ec.encode left the original volume behind")
        paths = _shard_paths(cluster, vid)
        if sorted(paths) != list(range(14)):
            fail(f"mounted shards {sorted(paths)} after ec.encode")
        orig = {sid: sha256(p) for sid, p in paths.items()}

        # count remote interval fetches and reconstructs on every server
        fetched: list[int] = []
        recon: list[int] = []
        for store in cluster.stores:
            real_fetch = store.remote_shards_fetcher
            real_recon = store._reconstruct_interval

            def counted_fetch(vid_, sids, off, size, need, deadline,
                              _real=real_fetch):
                got = _real(vid_, sids, off, size, need, deadline)
                fetched.extend(len(v) for v in got.values())
                return got

            def counted_recon(ecv, sid, off, size, _real=real_recon):
                recon.append(size)
                return _real(ecv, sid, off, size)

            store.remote_shards_fetcher = counted_fetch
            store._reconstruct_interval = counted_recon
        reader = placement[1]
        reads(4, reader, "all 14 shards")
        if not fetched:
            fail("step 4: no interval came from another server")

        def drop(sids) -> None:
            locs = env.ec_shard_locations(vid)
            for sid in sids:
                for holder in locs.get(sid, []):
                    env.vs_post(holder, "/admin/ec/delete",
                                {"volume": vid, "shard_ids": [sid]})
            deadline = time.monotonic() + 30
            while set(sids) & set(env.ec_shard_locations(vid)):
                if time.monotonic() > deadline:
                    fail(f"the master still lists shards {sids}")
                time.sleep(0.05)

        drop((0, 5, 11))
        reads(5, reader, "shards {0, 5, 11} deleted")
        if not recon:
            fail("step 5: no interval was reconstructed")

        # 6. partial, then full rebuild
        copy0 = metrics.counter_value("repair_read_bytes_total",
                                      {"mode": "full"})
        out, dt = shell(f"ec.rebuild -volumeId={vid}", "partial")
        shard_size = os.path.getsize(paths[1])
        log(f"[7] 6. partial rebuild on {out.get('rebuilder')}: mode "
            f"{out.get('mode')!r}, rebuilt {out.get('rebuilt')}, read_bytes "
            f"{out.get('read_bytes')} B over HTTP, rebuilt_bytes "
            f"{out.get('rebuilt_bytes')} B, {10 * shard_size / dt / 1e6:.1f}"
            f" MB/s (input shard bytes)")
        if out.get("mode") != "partial" or out.get("rebuilt") != [0, 5, 11]:
            fail(f"ec.rebuild did not rebuild {{0, 5, 11}} partially: {out}")

        def check_rebuilt(label: str) -> None:
            now = _shard_paths(cluster, vid)
            bad = [i for i in range(14) if i not in now
                   or sha256(now[i]) != orig[i]]
            if bad:
                fail(f"{label}: shards {bad} missing or differ")
            log(f"[7] 6. {label}: all 14 shards mounted, sha256-equal to "
                f"step 3's")

        check_rebuilt("after the partial rebuild")
        drop((0, 5, 11))
        out, dt = shell(f"commands_ec.ec_rebuild(env, {vid}, partial=False)",
                        "full", lambda: commands_ec.ec_rebuild(
                            env, vid, partial=False))
        copied = metrics.counter_value("repair_read_bytes_total",
                                       {"mode": "full"}) - copy0
        log(f"[7] 6. full rebuild on {out.get('rebuilder')}: mode "
            f"{out.get('mode')!r}, rebuilt {out.get('rebuilt')}, ec/copy "
            f"{copied} B over HTTP, rebuilt_bytes {out.get('rebuilt_bytes')}"
            f" B, {10 * shard_size / dt / 1e6:.1f} MB/s (input shard bytes)")
        if out.get("mode") != "full" or sorted(out.get("rebuilt", [])) != \
                [0, 5, 11]:
            fail(f"full rebuild did not rebuild {{0, 5, 11}}: {out}")
        check_rebuilt("after the full rebuild")
        reads(6, reader, "after both rebuilds")

        # 7. lose data shards 0 and 5, decode back to a volume
        drop((0, 5))
        out, dt = shell(f"ec.decode -volumeId={vid}", "decode")
        server = out["server"]
        store = next(s for s in cluster.stores
                     if f"{s.ip}:{s.port}" == server)
        v = store.find_volume(vid)
        if v is None:
            fail(f"ec.decode left no volume {vid} on {server}")
        dec_path = v.file_name() + ".dat"
        dec_size = os.path.getsize(dec_path)
        decoded = sha256(dec_path)
        log(f"[7] 7. ec.decode on {server} with data shards 0 and 5 "
            f"deleted: {dec_size / dt / 1e6:.1f} MB/s (.dat bytes out); "
            f"decoded .dat {dec_size} B sha256 {decoded[:16]}; the sealed "
            f".dat up to its last live needle: {live_end} B sha256 "
            f"{prefix[:16]} (whole .dat {dat_size} B {sealed[:16]}; its "
            f"tail holds {len(tail)} records, all of deleted needles)")
        if dec_size != live_end or decoded != prefix:
            fail("the decoded .dat differs from the sealed one")
        reads(7, server, "from the decoded volume")
        log(f"[7] phase 7 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches}")
        return launches
    finally:
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 8: the mesh codec and the batched feeds
# ----------------------------------------------------------------------

GROUP = 8                        # volumes per batched block (8b)
BLOCK_COLS = 4 << 20             # columns per batched block
VOLUMES = 64                     # BASELINE config #3: 64 x 1 GiB
VOLUME_ROW = -(-DAT_BYTES // 10)  # bytes per shard row of a 1 GiB volume
POOL = 4                         # distinct seeded blocks the feeds reuse
SCRUB_COLS = 1 << 20             # 8e's stripe width, phase 4's shape
MESH_DEVICE = "cuda"             # the platform phase 8's meshes span


class Checker:
    """Compares results with their expected arrays on 4 threads (numpy
    drops the GIL), at most 8 behind the feed."""

    def __init__(self):
        from concurrent.futures import ThreadPoolExecutor

        self.ex = ThreadPoolExecutor(4, thread_name_prefix="smoke-check")
        self.pending = []
        self.n = self.bad = 0

    def add(self, got, want) -> None:
        self.pending.append(self.ex.submit(np.array_equal, got, want))
        while len(self.pending) > 8:
            self._pop()

    def _pop(self) -> None:
        self.n += 1
        self.bad += not self.pending.pop(0).result()

    def close(self) -> tuple[int, int]:
        while self.pending:
            self._pop()
        self.ex.shutdown()
        return self.n, self.bad


def _plan() -> list[tuple[int, int]]:
    """(pool entry, width) of each of 8b's blocks: 8 groups of 8 volumes,
    each group's 107,374,183-column rows cut into 4 Mi-column blocks."""
    out = []
    for g in range(VOLUMES // GROUP):
        for c0 in range(0, VOLUME_ROW, BLOCK_COLS):
            out.append((len(out) % POOL, min(BLOCK_COLS, VOLUME_ROW - c0)))
    return out


def _mesh_codec_phase(tmp: str, orig: list[str]) -> tuple[int, dict]:
    """8a -> (launches over the encode and rebuild, launches by card)."""
    from seaweedfs_tpu_torch.ec import backend as ecb
    from seaweedfs_tpu_torch.ec import geometry as geo
    from seaweedfs_tpu_torch.ec.encoder import (rebuild_ec_files,
                                                write_ec_files)
    from seaweedfs_tpu_torch.ops import codec_cuda, rs_matrix

    codec = ecb.get_backend("mesh")
    log(f"[8a] MeshCodec().describe(): {json.dumps(codec.describe())}")
    dev0 = torch.device(MESH_DEVICE, 0)
    rng = np.random.default_rng(SEED + 8)
    lost = [1, 4, 11, 13]
    rec4, _ = rs_matrix.recovery_rows(
        10, 4, [i for i in range(14) if i not in lost], lost)
    for label, coef in (("rs10.4 parity", rs_matrix.parity_rows(10, 4)),
                        ("rs28.4 parity", rs_matrix.parity_rows(28, 4)),
                        ("rs10.4 recover {1,4,11,13}", rec4)):
        m, k = coef.shape
        tables = torch.from_numpy(codec_cuda.packed_tables(coef)).to(dev0)
        for n in (CHUNK + 777, 1):
            x = rng.integers(0, 256, (k, n), dtype=np.uint8)
            t0 = time.perf_counter()
            got = codec.coded_matmul(coef, x)
            dt = time.perf_counter() - t0
            want = codec_cuda.coded_matmul(
                tables, torch.from_numpy(x).to(dev0), m).cpu().numpy()
            ok = np.array_equal(got, want)
            log(f"[8a] coded_matmul {label} n={n}: mesh equal to the kernel "
                f"on one card: {ok} ({dt:.3f} s host to host)")
            if not ok:
                fail(f"mesh coded_matmul {label} n={n} differs")

    base = os.path.join(tmp, "1")
    write_seeded_dat(base + ".dat")
    paths = [base + geo.shard_ext(i) for i in range(14)]
    codec_cuda.reset_launches()
    before = feed_stage_seconds("mesh")
    t0 = time.perf_counter()
    write_ec_files(base, backend="mesh")
    dt = time.perf_counter() - t0
    enc = dict(codec_cuda.coded_matmul.launches_by_device)
    bad = [i for i in range(14) if sha256(paths[i]) != orig[i]]
    log(f"[8a] write_ec_files(backend='mesh'): {dt:.3f} s, "
        f"{DAT_BYTES / dt / 1e6:.1f} MB/s, launches by card {enc}, shards "
        f"sha256-equal to phase 3's: {not bad}; "
        f"{stages_since(before, dt, 'mesh')}")
    if bad:
        fail(f"mesh shards {bad} differ from phase 3's")
    for i in lost:
        os.remove(paths[i])
    before = feed_stage_seconds("mesh")
    t0 = time.perf_counter()
    got = rebuild_ec_files(base, backend="mesh")
    dt = time.perf_counter() - t0
    bad = [i for i in lost if sha256(paths[i]) != orig[i]]
    by_dev = dict(codec_cuda.coded_matmul.launches_by_device)
    shard = os.path.getsize(paths[0])
    log(f"[8a] rebuild_ec_files(backend='mesh') of {lost}: {dt:.3f} s, "
        f"{10 * shard / dt / 1e6:.1f} MB/s (input shard bytes), rebuilt "
        f"{got}, sha256-equal: {not bad}; launches by card over encode + "
        f"rebuild {by_dev}; {stages_since(before, dt, 'mesh')}")
    if got != lost or bad:
        fail(f"mesh rebuild gave {got}, differing shards {bad}")
    idle = [d.index for d in codec.mesh.device_list
            if by_dev.get(d.index, 0) <= 0]
    if idle:
        fail(f"the mesh launched the kernel no time on cards {idle}")
    return sum(by_dev.values()), by_dev


def _pool_blocks():
    """POOL seeded (8, 10, 4 Mi) blocks and their parity from the native
    codec."""
    from seaweedfs_tpu_torch.ec import backend as ecb
    from seaweedfs_tpu_torch.ops import rs_matrix

    parity = rs_matrix.parity_rows(10, 4)
    native = ecb.get_backend("native")
    dev0 = torch.device(MESH_DEVICE, 0)
    gen = torch.Generator(device=dev0).manual_seed(SEED + 80)
    pool, exp = [], []
    t0 = time.perf_counter()
    for _ in range(POOL):
        blk = torch.randint(0, 256, (GROUP, 10, BLOCK_COLS), dtype=torch.uint8,
                            device=dev0, generator=gen).cpu().numpy()
        pool.append(blk)
        exp.append(np.stack([native.coded_matmul(parity, v) for v in blk]))
    log(f"[8b] pool: {POOL} seeded {pool[0].shape} blocks "
        f"({pool[0].nbytes} B each) and their native-codec parity in "
        f"{time.perf_counter() - t0:.2f} s")
    return pool, exp


def _feed_run(label: str, backend: str, outs, expect, n_in: int) -> dict:
    """Drive one feed, check every result, print its rate and stages."""
    before = feed_stage_seconds(backend)
    check = Checker()
    n = 0
    t0 = time.perf_counter()
    for out, want in zip(outs, expect, strict=True):
        n += 1
        if want is not None:
            check.add(out, want)
    wall = time.perf_counter() - t0
    checked, bad = check.close()
    now = feed_stage_seconds(backend)
    stages = {s: round(now[s] - before[s], 4) for s in now}
    rate = n_in / wall / 1e6
    log(f"[8b] {label}: {n} blocks, {n_in} B in {wall:.3f} s = "
        f"{rate:.1f} MB/s; results checked: {checked - bad} equal, {bad} "
        f"differ; stage seconds {json.dumps(stages)}")
    if bad:
        fail(f"{label}: {bad} blocks differ")
    return {"wall_s": wall, "mbps": rate, "blocks": n, "stages_s": stages}


def _batched_phase() -> dict:
    """8b and 8c -> rates of every feed."""
    from seaweedfs_tpu_torch.ec import backend as ecb
    from seaweedfs_tpu_torch.models import ec_pipeline as ep
    from seaweedfs_tpu_torch.ops import rs_matrix
    from seaweedfs_tpu_torch.parallel import mesh as pmesh

    pool, exp = _pool_blocks()
    plan = _plan()
    n_in = sum(GROUP * 10 * w for _, w in plan)
    mesh = pmesh.make_mesh(device=MESH_DEVICE)
    log(f"[8b] pipelined_encode_stream, BASELINE config #3: {VOLUMES} x "
        f"{DAT_BYTES} B volumes, RS(10,4), depth 2: {len(plan)} blocks of "
        f"({GROUP}, 10, <= {BLOCK_COLS}), {n_in} B in; mesh "
        f"{json.dumps(pmesh.describe(mesh))}")

    def stripes():
        return (pool[p][:, :, :w] for p, w in plan)

    def expected():
        return (exp[p][:, :, :w] for p, w in plan)

    res = {}
    for name, m in (("none", None), ("mesh", mesh)):
        res[f"ec_pipeline_{name}"] = _feed_run(
            f"pipelined_encode_stream(mesh={name})",
            "ec_pipeline" if m is None else "ec_pipeline_mesh",
            ep.pipelined_encode_stream(stripes(), depth=2, mesh=m,
                                       device=MESH_DEVICE),
            expected(), n_in)

    # the kernel's route over the same bytes, per volume, and the link's
    # ceiling through the same feed
    def per_volume():
        return (pool[p][v][:, :w] for p, w in plan for v in range(GROUP))

    def per_volume_expected():
        return (exp[p][v][:, :w] for p, w in plan for v in range(GROUP))

    parity = rs_matrix.parity_rows(10, 4)
    cuda = ecb.get_backend("cuda")
    res["cuda_route"] = _feed_run(
        "CudaCodec.coded_matmul_stream per volume", "cuda",
        cuda.coded_matmul_stream(parity, per_volume(), depth=2),
        per_volume_expected(), n_in)
    res["cuda_ceiling"] = _feed_run(
        "transfer-only ceiling, CudaCodec.transfer_stream per volume "
        "(one card)", "cuda-ceiling",
        cuda.transfer_stream(4, per_volume(), depth=2),
        (None for _ in range(len(plan) * GROUP)), n_in)
    if mesh.devices.size > 1:
        codec = ecb.get_backend("mesh")
        res["mesh_route"] = _feed_run(
            "MeshCodec.coded_matmul_stream per volume", "mesh",
            codec.coded_matmul_stream(parity, per_volume(), depth=2),
            per_volume_expected(), n_in)
        res["mesh_ceiling"] = _feed_run(
            "transfer-only ceiling, MeshCodec.transfer_stream per volume "
            "(every card)", "mesh-ceiling",
            codec.transfer_stream(4, per_volume(), depth=2),
            (None for _ in range(len(plan) * GROUP)), n_in)
        log(f"[8b] mesh ceiling {res['mesh_ceiling']['mbps']:.1f} MB/s in "
            f"total, {res['mesh_ceiling']['mbps'] / mesh.devices.size:.1f}"
            f" MB/s per card; one card alone "
            f"{res['cuda_ceiling']['mbps']:.1f} MB/s")

    # 8c: the scrub over the same blocks (BASELINE config #5, cut from
    # 1000 volumes to 64)
    def pairs():
        return ((pool[p][:, :, :w], exp[p][:, :, :w]) for p, w in plan)

    fed = sum(1 for p, _ in plan if p == 1)
    n_pairs = n_in + sum(GROUP * 4 * w for _, w in plan)
    for flip in (False, True):
        if flip:
            exp[1][3, 2, 12345] ^= 0xFF
        for name, m in (("none", None), ("mesh", mesh)):
            t0 = time.perf_counter()
            total, n = ep.pipelined_scrub(pairs(), depth=2, mesh=m,
                                          device=MESH_DEVICE)
            wall = time.perf_counter() - t0
            want = fed if flip else 0
            log(f"[8c] pipelined_scrub(mesh={name}) "
                f"{'one byte flipped in pool entry 1' if flip else 'clean'}"
                f": {total} mismatches over {n} blocks (want {want} over "
                f"{len(plan)}), {n_pairs} B in {wall:.3f} s = "
                f"{n_pairs / wall / 1e6:.1f} MB/s")
            if (total, n) != (want, len(plan)):
                fail(f"scrub counted {total} over {n} blocks")
            res[f"scrub_{name}{'_flipped' if flip else ''}_mbps"] = \
                n_pairs / wall / 1e6
    exp[1][3, 2, 12345] ^= 0xFF
    return res


def _events_ms(devices, fn):
    """Run fn() with an event pair on each device's current stream ->
    (result, the slowest device's ms); the host clock on the CPU."""
    if devices[0].type == "cpu":
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    starts, ends = [], []
    for d in devices:
        with torch.cuda.device(d):
            starts.append(torch.cuda.Event(enable_timing=True))
            ends.append(torch.cuda.Event(enable_timing=True))
            starts[-1].record()
    out = fn()
    for d, e in zip(devices, ends):
        with torch.cuda.device(d):
            e.record()
    for e in ends:
        e.synchronize()
    return out, max(s.elapsed_time(e) for s, e in zip(starts, ends))


def _sharded_rebuild_phase() -> dict:
    """8d -> the two halves' times."""
    from seaweedfs_tpu_torch.models import ec_pipeline as ep
    from seaweedfs_tpu_torch.ops import codec_cuda

    missing = [0, 3, 11, 13]
    present = [i for i in range(14) if i not in missing]
    mesh = ep.rebuild_mesh(device=MESH_DEVICE)
    devices = mesh.device_list
    rebuild, a_bits, coef = ep.sharded_rebuild(mesh, present=present,
                                               missing=missing)
    gen = torch.Generator(device=devices[0]).manual_seed(SEED + 84)
    x = torch.randint(0, 256, (10, CHUNK), dtype=torch.uint8,
                      device=devices[0], generator=gen)
    tables = torch.from_numpy(codec_cuda.packed_tables(coef)).to(x.device)
    want = codec_cuda.coded_matmul(tables, x, 4).cpu()
    placed = rebuild.place(x.cpu().numpy())
    rebuild(a_bits, placed)                          # warm
    if devices[0].type == "cuda":
        torch.cuda.synchronize()
    partials, prod_ms = _events_ms(
        devices, lambda: rebuild.partials(a_bits, placed))
    out, red_ms = _events_ms(devices, lambda: rebuild.reduce(partials))
    got = out.gather()
    ok = torch.equal(got, want)
    d = len(devices)
    part_bytes = partials[0].numel() * 4
    log(f"[8d] sharded_rebuild over rebuild_mesh() ({d} cards), missing "
        f"{missing}, (10, {CHUNK}) shards: per-device product "
        f"{prod_ms:.3f} ms (slowest card; each reads its "
        f"{placed[0].numel()} B of shard rows and writes "
        f"{part_bytes} B of int32 counts), reduce-scatter + & 1 + pack "
        f"{red_ms:.3f} ms (each card's {part_bytes} B of counts in, "
        f"{(d - 1) * part_bytes // d} B of ring traffic per card, "
        f"{part_bytes // d} B out); equal to the kernel's reconstruction: "
        f"{ok}")
    if not ok:
        fail("sharded_rebuild differs from the kernel's reconstruction")
    return {"product_ms": prod_ms, "reduce_ms": red_ms, "devices": d}


def _sharded_scrub_phase() -> None:
    """8e."""
    from seaweedfs_tpu_torch.models import ec_pipeline as ep
    from seaweedfs_tpu_torch.ops import codec_cuda, rs_matrix
    from seaweedfs_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(device=MESH_DEVICE)
    step, a_bits, place = ep.sharded_encode_scrub(mesh)
    dev0 = mesh.device_list[0]
    gen = torch.Generator(device=dev0).manual_seed(SEED + 85)
    stripes = torch.randint(0, 256, (64, 10, SCRUB_COLS), dtype=torch.uint8,
                            device=dev0, generator=gen)
    tables = torch.from_numpy(
        codec_cuda.packed_tables(rs_matrix.parity_rows(10, 4))).to(dev0)
    expected = torch.stack([codec_cuda.coded_matmul(tables, s, 4)
                            for s in stripes]).cpu().numpy()
    s_sh = place(stripes.cpu().numpy())
    for flip in (False, True):
        if flip:
            expected[7, 2, 12345] ^= 1
        t0 = time.perf_counter()
        parity, mism = step(a_bits, s_sh, place(expected))
        mism = int(mism)
        dt = time.perf_counter() - t0
        log(f"[8e] sharded_encode_scrub over {json.dumps(pmesh.describe(mesh))}"
            f" on (64, 10, {SCRUB_COLS}): {mism} mismatches "
            f"{'after one flipped byte' if flip else 'clean'} ({dt:.3f} s "
            f"host to host, {len(parity.pieces)} pieces)")
        if mism != int(flip):
            fail(f"sharded scrub counted {mism}")


def phase_mesh(orig: list[str]) -> dict:
    """Phase 8 -> the numbers the kernels' line carries."""
    from seaweedfs_tpu_torch.ec import backend as ecb
    from seaweedfs_tpu_torch.ec import probe

    t_phase = time.perf_counter()
    cuda = MESH_DEVICE == "cuda"
    cur = torch.cuda.current_device() if cuda else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke8-")
    os.environ["SEAWEEDFS_TPU_EC_PROBE_CACHE"] = os.path.join(
        tmp, "ec_probe.json")
    try:
        launches, by_dev = _mesh_codec_phase(tmp, orig)
        batched = _batched_phase()
        rebuild = _sharded_rebuild_phase()
        _sharded_scrub_phase()
        now = torch.cuda.current_device() if cuda else None
        log(f"[8f] current device before phase 8: {cur}, after: {now}")
        if now != cur:
            fail(f"phase 8 moved the current device from {cur} to {now}")
        if cuda and torch.cuda.device_count() > 1:
            curve = probe.get_curve(refresh=True)
            for key in ("rows", "mesh_rows"):
                for row in curve.get(key, []):
                    log(f"[8f] probe {key}: {json.dumps(row)}")
            log(f"[8f] probe summary: {json.dumps(probe.summary(curve))}")
            for size in (1 << 20, 64 << 20, 1 << 30):
                log(f"[8f] router at {size} B: "
                    f"{ecb.choose_backend_for_size(size)}, depth "
                    f"{ecb.pipeline_depth_for(size)}")
        log(f"[8] phase 8 took {time.perf_counter() - t_phase:.3f} s")
        return {"mesh_launches": launches, "mesh_launches_by_device": by_dev,
                "batched": batched, "sharded_rebuild": rebuild}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 9: the self-healing plane (watchdog, scrub, vacuum)
# ----------------------------------------------------------------------
HEAL_TOPOLOGY = [("dc1", "rA"), ("dc1", "rA"), ("dc1", "rB"),
                 ("dc1", "rB"), ("dc1", "rC")]
HEAL_PULSE = 0.5                 # seconds between heartbeats
HEAL_INTERVAL = 1.0              # the watchdog's scan interval
# -repair.grace: ec.encode mounts its shards server by server, and with
# no grace the watchdog rebuilds the shards not yet mounted (the admin
# lock is per shell without a filer, so nothing serializes the two);
# 10 s is twice the longest ec.encode seen on the card
HEAL_GRACE = 10.0
HEAL_DEADLINE = 120.0            # longest wait for a deficit to heal
REPLICA_BYTES = 256 << 20        # 9c's replicated volume


def _poll(pred, deadline: float, what: str, step: float = 0.05):
    """Poll pred() until it returns a true value; fail at the deadline
    (seconds from now). -> that value."""
    end = time.monotonic() + deadline
    while True:
        out = pred()
        if out:
            return out
        if time.monotonic() > end:
            fail(f"{what}: not reached in {deadline:.0f} s")
        time.sleep(step)


def _repair_results(env, since: float = 0.0, vid: int = 0,
                    kind: str = "") -> list[dict]:
    """The watchdog's results finished after `since` (wall clock), of
    volume `vid` and `kind` where given, newest first; fail on any
    result that did not succeed (a failed repair is never passed
    over)."""
    rep = env.master_get("/debug/repair")
    bad = [r for r in rep["recent"] if not r["ok"]]
    if bad:
        fail(f"the watchdog recorded a failed repair: {bad[0]}")
    return [r for r in rep["recent"] if r["finished_at"] >= since
            and (not vid or r["volume"] == vid)
            and (not kind or r["kind"] == kind)]


def _live_shard_files(cluster, env, vid: int) -> dict[int, str]:
    """{shard id: file} of the shards the master lists for `vid`, each
    from the store of its first holder."""
    by_url = {f"{s.ip}:{s.port}": s for s in cluster.stores}
    out = {}
    for sid, urls in env.ec_shard_locations(vid).items():
        ecv = by_url[urls[0]].ec_volumes.get(vid)
        if ecv is None or sid not in ecv.shards:
            fail(f"the master lists shard {sid} on {urls[0]}, which has "
                 f"no such shard mounted")
        out[sid] = ecv.shards[sid].path
    return out


def _repair_metrics() -> dict:
    from seaweedfs_tpu_torch.utils import metrics

    return {
        "read_partial": metrics.counter_value("repair_read_bytes_total",
                                              {"mode": "partial"}),
        "read_full": metrics.counter_value("repair_read_bytes_total",
                                           {"mode": "full"}),
        "seconds_sum": {k: metrics.counter_value(
            "repair_seconds_sum", {"kind": k, "outcome": "ok"})
            for k in ("ec", "replica")},
        "seconds_count": {k: metrics.counter_value(
            "repair_seconds_count", {"kind": k, "outcome": "ok"})
            for k in ("ec", "replica")},
    }


def _metrics_since(before: dict) -> str:
    now = _repair_metrics()
    return (f"repair_read_bytes_total{{mode=partial}} "
            f"+{now['read_partial'] - before['read_partial']:.0f} B, "
            f"{{mode=full}} +{now['read_full'] - before['read_full']:.0f} "
            f"B; repair_seconds{{kind=ec,outcome=ok}} +"
            f"{now['seconds_count']['ec'] - before['seconds_count']['ec']:.0f}"
            f" repairs, +"
            f"{now['seconds_sum']['ec'] - before['seconds_sum']['ec']:.3f} s; "
            f"{{kind=replica,outcome=ok}} +"
            f"{now['seconds_count']['replica'] - before['seconds_count']['replica']:.0f}"
            f" repairs, +"
            f"{now['seconds_sum']['replica'] - before['seconds_sum']['replica']:.3f} s")


def phase_heal(card: str) -> dict:
    """Phase 9: the self-healing plane on 5 volume servers over 3 racks,
    with the watchdog's repairs enabled. -> kernel launches of 9a's
    repair, 9b's verify and 9b's repair."""
    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import commands_ec, repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.storage import needle as ndl
    from seaweedfs_tpu_torch.storage import types as t

    t_phase = time.perf_counter()
    # None when rehearsed on a host without a card
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke9-")
    cluster = Cluster(tmp, n_volume_servers=len(HEAL_TOPOLOGY),
                      max_volumes=8, volume_size_limit=2 * DAT_BYTES,
                      pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                      topology=HEAL_TOPOLOGY, repair_enabled=True,
                      repair_interval=HEAL_INTERVAL,
                      repair_grace=HEAL_GRACE)
    launches: dict[str, int] = {}
    try:
        env = CommandEnv(cluster.master_url)
        by_url = {f"{s.ip}:{s.port}": i
                  for i, s in enumerate(cluster.stores)}
        log(f"[9] {card}")
        log(f"[9] Cluster: master {cluster.master_url}, volume servers "
            f"{[(th.address, *HEAL_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f", ec_backend='cuda', pulse {HEAL_PULSE} s, repair enabled, "
            f"interval {HEAL_INTERVAL} s, grace {HEAL_GRACE} s")

        # 9a. lose the server with the fewest shards
        w = _fill_volume_http(cluster, env, "smoke9", SEED + 7, DAT_BYTES)
        vid, live = w["vid"], w["live"]
        log(f"[9a] volume {vid} on {w['url']}: {w['writes']} uploads "
            f"({w['overwrites']} overwrites), {len(w['dead'])} deletes, "
            f".dat {w['vol'].content_size()} B, {w['seconds']:.3f} s")
        repl.run_command(env, "lock")
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t0 = time.perf_counter()
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        dt = time.perf_counter() - t0
        launches["encode"] = codec_cuda.coded_matmul.launches
        if launches["encode"] <= 0:
            fail("ec.encode launched the kernel no time")
        if _repair_results(env, since):
            fail(f"the watchdog repaired during ec.encode: "
                 f"{_repair_results(env, since)}")
        paths = _live_shard_files(cluster, env, vid)
        if sorted(paths) != list(range(14)):
            fail(f"shards {sorted(paths)} after ec.encode")
        orig = {sid: sha256(p) for sid, p in paths.items()}
        shard_size = os.path.getsize(paths[0])
        locs = env.ec_shard_locations(vid)
        if any(len(urls) != 1 for urls in locs.values()):
            fail(f"ec.encode left shards on more than one server: {locs}")
        held: dict[str, list[int]] = {u: [] for u in by_url}
        for sid, urls in locs.items():
            for u in urls:
                held[u].append(sid)
        victim = min(held, key=lambda u: (len(held[u]), u))
        log(f"[9a] ec.encode {dt:.3f} s, {launches['encode']} launches; "
            f"shards per server "
            f"{ {u: sorted(s) for u, s in held.items()} }; 14 shards of "
            f"{shard_size} B hashed")
        if not 0 < len(held[victim]) <= 4:
            fail(f"the server with the fewest shards, {victim}, holds "
                 f"{len(held[victim])}: not 1..m=4")
        lost = sorted(held[victim])
        m0 = _repair_metrics()
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_kill = time.monotonic()
        cluster.volume_threads[by_url[victim]].stop()

        def deficit():
            st = env.master_get("/cluster/status")
            return any(e["volume"] == vid for e in st["UnderParity"])

        _poll(deficit, HEAL_DEADLINE, f"volume {vid} in UnderParity")
        t_seen = time.monotonic()

        def healed():
            st = env.master_get("/cluster/status")
            return not st["UnderParity"] and \
                len(env.ec_shard_locations(vid)) == 14

        _poll(healed, HEAL_DEADLINE, f"volume {vid} back to 14 shards")
        t_done = time.monotonic()
        recent = _poll(lambda: _repair_results(env, since, vid, "ec"),
                       HEAL_DEADLINE, "the watchdog's EC repair result")
        launches["9a repair"] = codec_cuda.coded_matmul.launches
        rec = recent[0]
        now = _live_shard_files(cluster, env, vid)
        bad = [sid for sid in range(14) if sha256(now[sid]) != orig[sid]]
        log(f"[9a] killed {victim} ({HEAL_TOPOLOGY[by_url[victim]]}, "
            f"shards {lost}): detection {t_seen - t_kill:.3f} s (kill -> "
            f"UnderParity lists it; 5 silent pulses of {HEAL_PULSE} s), "
            f"repair {t_done - t_seen:.3f} s (deficit -> 14 live shards; "
            f"the first {HEAL_GRACE} s are the grace, "
            f"{t_done - t_seen - HEAL_GRACE:.3f} s after it); "
            f"the watchdog's repair: reason {rec['reason']!r}, mode "
            f"{rec['detail'].get('mode')!r}, rebuilt "
            f"{rec['detail'].get('rebuilt')} on "
            f"{rec['detail'].get('rebuilder')}, {rec['seconds']} s, "
            f"{rec['bytes']} B; kernel launches during the repair "
            f"{launches['9a repair']}; {_metrics_since(m0)}")
        if rec["reason"] != "watchdog" or \
                sorted(rec["detail"].get("rebuilt", [])) != lost:
            fail(f"the watchdog's repair was not the rebuild of {lost}: "
                 f"{rec}")
        if launches["9a repair"] <= 0:
            fail("the watchdog's rebuild launched the kernel no time")
        if bad:
            fail(f"rebuilt shards {bad} differ from the originals")
        reader = env.ec_shard_locations(vid)[0][0]
        st = _http_read_pass(reader, live, "9a")
        log(f"[9a] all 14 shards sha256-equal to the originals; GET "
            f"{len(live)} live needles from {reader}: {st['wall']:.3f} s, "
            f"{len(live) / st['wall']:.1f} reads/s, p50 "
            f"{st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms, all equal")

        # 9b. silent corruption in one shard
        paths = _live_shard_files(cluster, env, vid)
        sid = 7
        off = shard_size // 2
        with open(paths[sid], "r+b") as f:
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ 0x5A]))
        m0 = _repair_metrics()
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t0 = time.perf_counter()
        out = commands_ec.ec_verify(env, vid, sample_mb=0, backend="cuda")
        dt = time.perf_counter() - t0
        launches["9b verify"] = codec_cuda.coded_matmul.launches
        log(f"[9b] flipped byte {off} of shard {sid} ({paths[sid]}); "
            f"ec.verify -sample_mb=0 -backend=cuda: {dt:.3f} s, "
            f"{14 * shard_size / dt / 1e6:.1f} MB/s over the 14 shards, "
            f"kernel launches from its start to its return "
            f"{launches['9b verify']}; {out}")
        want = {"verified": False, "corrupt_shard": sid,
                "quarantined": True, "repair_enqueued": True}
        if {k: out.get(k) for k in want} != want:
            fail(f"ec.verify answered {out}, wanted {want}")
        if launches["9b verify"] <= 0:
            fail("ec.verify -backend=cuda launched the kernel no time")
        t1 = time.monotonic()
        done = _poll(lambda: _repair_results(env, since, vid, "ec"),
                     HEAL_DEADLINE,
                     "the watchdog's rebuild of the quarantined shard")
        _poll(lambda: len(env.ec_shard_locations(vid)) == 14,
              HEAL_DEADLINE, f"shard {sid} registered again")
        launches["9b repair"] = codec_cuda.coded_matmul.launches - \
            launches["9b verify"]
        rec = done[0]
        now = _live_shard_files(cluster, env, vid)
        log(f"[9b] the watchdog's repair: reason {rec['reason']!r}, mode "
            f"{rec['detail'].get('mode')!r}, rebuilt "
            f"{rec['detail'].get('rebuilt')}, {rec['seconds']} s "
            f"({time.monotonic() - t1:.3f} s after ec.verify returned); "
            f"kernel launches after ec.verify returned "
            f"{launches['9b repair']}; {_metrics_since(m0)}")
        if rec["reason"] != "scrub" or rec["detail"].get("rebuilt") != [sid]:
            fail(f"the repair was not the rebuild of shard {sid}: {rec}")
        if launches["9b repair"] <= 0:
            fail("the rebuild of the quarantined shard launched the "
                 "kernel no time")
        if sha256(now[sid]) != orig[sid]:
            fail(f"rebuilt shard {sid} differs from the original")
        t0 = time.perf_counter()
        again = commands_ec.ec_verify(env, vid, sample_mb=0, backend="cuda")
        dt = time.perf_counter() - t0
        log(f"[9b] shard {sid} sha256-equal to the original; ec.verify "
            f"again: verified {again['verified']}, {dt:.3f} s, "
            f"{14 * shard_size / dt / 1e6:.1f} MB/s")
        if again.get("verified") is not True:
            fail(f"the second ec.verify answered {again}")

        # 9c. scrub of a replicated volume (host only)
        w = _fill_volume_http(cluster, env, "smoke9c", SEED + 9,
                              REPLICA_BYTES, replication="010")
        rvid, rlive = w["vid"], w["live"]
        holders = env.volume_locations(rvid)
        if len(holders) != 2:
            fail(f"volume {rvid} (010) has replicas on {holders}")
        racks = {HEAL_TOPOLOGY[by_url[u]][1] for u in holders}
        bad_url = holders[1]
        v = cluster.stores[by_url[bad_url]].find_volume(rvid)
        v.sync()
        key, noff, _size = next(v.nm.live_items())
        byte_off = t.offset_to_actual(noff) + t.NEEDLE_HEADER_SIZE + 2
        orig_byte = v.dat.read_at(1, byte_off)
        v.dat.write_at(bytes([orig_byte[0] ^ 0xFF]), byte_off)
        log(f"[9c] volume {rvid} (replication 010) on {holders} (racks "
            f"{sorted(racks)}): {w['writes']} uploads, {len(rlive)} live "
            f"needles, .dat {v.content_size()} B, {w['seconds']:.3f} s; "
            f"flipped a data byte of needle {key} in {bad_url}'s .dat")
        m0 = _repair_metrics()
        since = time.time()
        t0 = time.perf_counter()
        report = repl.run_command(env, f"volume.scrub -volumeId={rvid}")
        dt = time.perf_counter() - t0
        rows = {r["server"]: r for r in report}
        log(f"[9c] volume.scrub: {dt:.3f} s; "
            f"{ {u: {k: r[k] for k in ('checked', 'bad', 'quarantine') if k in r} for u, r in rows.items()} }")
        if [b["id"] for b in rows[bad_url]["bad"]] != [key] or \
                rows[bad_url].get("quarantine") != {
                    "action": "unmounted", "repair_enqueued": True}:
            fail(f"volume.scrub did not quarantine {bad_url}: {report}")
        if any(r["bad"] for u, r in rows.items() if u != bad_url):
            fail(f"volume.scrub found the healthy replica bad: {report}")
        t1 = time.monotonic()
        done = _poll(lambda: _repair_results(env, since, rvid, "replica"),
                     HEAL_DEADLINE, "the watchdog's re-replication")
        holders = _poll(lambda: (lambda h: h if len(h) == 2 else None)(
            env.volume_locations(rvid)), HEAL_DEADLINE, "2 replicas again")
        rec = done[0]
        log(f"[9c] the watchdog's volume.fix.replication: reason "
            f"{rec['reason']!r}, {rec['detail']['fixes']}, "
            f"{rec['seconds']} s, {rec['bytes']} B "
            f"({time.monotonic() - t1:.3f} s after the scrub); replicas "
            f"now {holders}; {_metrics_since(m0)}")
        if rec["reason"] != "scrub":
            fail(f"the re-replication was not scrub's request: {rec}")
        for u in holders:
            st = _http_read_pass(u, rlive, f"9c {u}")
            log(f"[9c] GET {len(rlive)} live needles from {u}: "
                f"{st['wall']:.3f} s, {len(rlive) / st['wall']:.1f} "
                f"reads/s, all equal")

        # 9d. vacuum
        rng = np.random.default_rng(SEED + 10)
        gone = [str(f) for f in rng.choice(sorted(rlive),
                                           int(len(rlive) * 0.3),
                                           replace=False)]
        for fid in gone:
            verbs.delete(f"http://{holders[0]}/{fid}")
            del rlive[fid]
        vols = {u: cluster.stores[by_url[u]].find_volume(rvid)
                for u in holders}
        before = {}
        for u, vv in vols.items():
            vv.sync()
            before[u] = os.path.getsize(vv.file_name() + ".dat")
        t0 = time.perf_counter()
        r = env.master_get("/vol/vacuum", garbageThreshold="0.2")
        dt = time.perf_counter() - t0
        log(f"[9d] deleted {len(gone)} of {len(gone) + len(rlive)} needles "
            f"(30%); /vol/vacuum?garbageThreshold=0.2: {dt:.3f} s, {r}")
        compacted = [x for x in r["results"] if x.get("volume") == rvid]
        if not compacted or sorted(compacted[0]["replicas"]) != \
                sorted(holders):
            fail(f"/vol/vacuum did not compact both replicas: {r}")
        for u, vv in vols.items():
            vv.sync()
            after = os.path.getsize(vv.file_name() + ".dat")
            expect = vv.super_block.block_size + sum(
                ndl.disk_size(size, vv.version)
                for _k, _o, size in vv.nm.live_items())
            log(f"[9d] {u}: .dat {before[u]} -> {after} B; the live "
                f"records need {expect} B")
            if after != expect or after >= before[u]:
                fail(f"{u}: the compacted .dat holds {after} B, the live "
                     f"records {expect} B")
            st = _http_read_pass(u, rlive, f"9d {u}")
            for fid in gone:
                r = session().get(f"http://{u}/{fid}", timeout=30)
                if r.status_code != 404:
                    fail(f"9d: deleted needle {fid} answers "
                         f"{r.status_code} on {u}")
            log(f"[9d] GET {len(rlive)} live needles from {u}: "
                f"{st['wall']:.3f} s, all equal; the {len(gone)} deleted "
                f"ones answer 404")
        repl.run_command(env, "volume.vacuum.disable")
        resp = session().get(f"{cluster.master_url}/vol/vacuum",
                             timeout=30)
        log(f"[9d] volume.vacuum.disable; /vol/vacuum answers "
            f"{resp.status_code} {resp.text.strip()}")
        if resp.status_code != 409:
            fail("/vol/vacuum ran while vacuum was disabled")
        repl.run_command(env, "volume.vacuum.enable")
        _repair_results(env)
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        log(f"[9] current device before phase 9: {cur}, after: {now_dev}")
        if now_dev != cur:
            fail(f"phase 9 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[9] phase 9 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches}")
        return launches
    finally:
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 10: S3 objects through the filer, erasure-coded and healed
# ----------------------------------------------------------------------
S3_BUCKET = "smoke10"
S3_BIG = 80                       # warp's default object: 10 MiB
S3_BIG_BYTES = 10 << 20
S3_PARTS = 10                     # one multipart object, 10 x 16 MiB
S3_PART_BYTES = 16 << 20
S3_SMALL = 4096                   # 1-64 KiB, uniform
S3_SMALL_LO, S3_SMALL_HI = 1 << 10, 64 << 10
S3_JSON_EVERY = 8                 # every 8th small object is .json text
S3_THREADS = 8                    # client threads of the PUT / GET passes
S3_VOLUME_LIMIT = DAT_BYTES       # the bucket's volumes fill to 1 GiB
S3_DEGRADED_SAMPLE = 512          # objects GET while a server is down
S3_RANGES = 64                    # seeded Range GETs on the multipart one
S3_KEY, S3_SECRET = "SMOKE10ACCESS", "smoke10-secret-key"
S3_CONFIG = {"identities": [{
    "name": "smoke", "actions": ["Admin"],
    "credentials": [{"accessKey": S3_KEY, "secretKey": S3_SECRET}]}]}


def _s3_object(i: int) -> tuple[str, bytes]:
    """Object i of the bucket: (key, bytes), regenerated from the seed
    on demand so no pass holds the bucket in memory. i < S3_BIG: 10 MiB;
    i == S3_BIG: the multipart object; above: the small ones."""
    rng = np.random.default_rng([SEED, 10, i])
    if i < S3_BIG:
        return f"big/obj-{i:03d}.bin", rng.bytes(S3_BIG_BYTES)
    if i == S3_BIG:
        return "multipart/object.bin", rng.bytes(S3_PARTS * S3_PART_BYTES)
    j = i - S3_BIG - 1
    size = int(rng.integers(S3_SMALL_LO, S3_SMALL_HI + 1))
    if j % S3_JSON_EVERY == 0:
        words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]
        rows, n = [], 0
        while n < size:
            row = json.dumps({"id": int(rng.integers(1 << 30)),
                              "tag": words[int(rng.integers(6))],
                              "value": float(rng.random())})
            rows.append(row)
            n += len(row) + 2
        return f"small/{j:05d}.json", ("[" + ",\n".join(rows) + "]") \
            .encode()[:max(size, 2)]
    return f"small/{j:05d}.bin", rng.bytes(size)


class _S3Client:
    """SigV4-signed requests to the gateway, one pooled session per
    thread."""

    def __init__(self, url: str):
        self.url = url

    def __call__(self, method: str, path: str, data: bytes = b"",
                 headers: dict | None = None, stream: bool = False):
        from seaweedfs_tpu_torch.rpc.httpclient import session
        from seaweedfs_tpu_torch.s3.auth import sign_request

        url = self.url + path
        hdrs = sign_request(method, url, S3_KEY, S3_SECRET, payload=data,
                            extra_headers=headers)
        return session().request(method, url, data=data or None,
                                 headers=hdrs, timeout=(5.0, 300.0),
                                 stream=stream)


def _pool_map(fn, items, threads: int = S3_THREADS) -> list:
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(fn, items))


def _lat(lat: list[float]) -> str:
    p50, p99 = np.percentile(np.array(lat), [50, 99]) * 1e3
    return f"p50 {p50:.3f} ms p99 {p99:.3f} ms"


def _bucket_vids(env, collection: str) -> list[int]:
    vids = set()
    for n in env.data_nodes():
        for vid, col in n.get("collections", {}).items():
            if col == collection:
                vids.add(int(vid))
    return sorted(vids)


def _encode_launches(dat_size: int) -> int:
    """Kernel launches ec.encode makes for a .dat of this size: below
    one large row (10 GiB) every stripe row is 10 x 1 MiB, and
    encoder.DEFAULT_CHUNK groups 32 rows into one launch."""
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.ec import geometry as geo

    if dat_size >= geo.DATA_SHARDS * geo.LARGE_BLOCK:
        fail(f"a {dat_size} B volume has large rows; the launch count "
             "below assumes small rows only")
    rows = -(-dat_size // (geo.DATA_SHARDS * geo.SMALL_BLOCK))
    per = max(1, encoder.DEFAULT_CHUNK // geo.SMALL_BLOCK)
    return -(-rows // per)


def _gzipped_json(cluster, want: dict) -> int:
    """How many .json objects' needles the volume servers stored with
    FLAG_IS_COMPRESSED (read straight from the stores)."""
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.storage import types as t

    n = 0
    for key in want:
        if not key.endswith(".json"):
            continue
        meta = session().get(f"{cluster.filer_url}/buckets/{S3_BUCKET}/"
                             f"{key}", params={"meta": "1"}, timeout=30)
        for c in meta.json().get("chunks", []):
            vid, nid, cookie = t.parse_file_id(c["fid"])
            for s in cluster.stores:
                if s.has_volume(vid):
                    n += bool(s.read_needle(vid, nid, cookie).is_compressed)
                    break
    return n


def phase_s3(card: str) -> dict:
    """Phase 10: S3 objects through the filer into erasure-coded
    volumes, ec.encode under a live watchdog at grace 0 behind the
    filer's DLM lock, a lost server healed by the watchdog, every
    object read back through S3. -> kernel launches of its steps."""
    from seaweedfs_tpu_torch.cluster.lock_manager import DlmClient
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import commands_ec, repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke10-")
    cluster = Cluster(tmp, n_volume_servers=len(HEAL_TOPOLOGY),
                      max_volumes=8, volume_size_limit=S3_VOLUME_LIMIT,
                      pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                      topology=HEAL_TOPOLOGY, repair_enabled=True,
                      repair_interval=HEAL_INTERVAL, repair_grace=0.0,
                      with_filer=True, filer_store="sqlite",
                      with_s3=True, s3_config=S3_CONFIG)
    launches: dict[str, int] = {}
    env = None
    try:
        s3 = _S3Client(cluster.s3_url)
        env = CommandEnv(cluster.master_url, filer_url=cluster.filer_url)
        by_url = {f"{s.ip}:{s.port}": i
                  for i, s in enumerate(cluster.stores)}
        log(f"[10] {card}")
        log(f"[10] Cluster: master {cluster.master_url}, volume servers "
            f"{[(th.address, *HEAL_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f", filer {cluster.filer_url} (sqlite), s3 {cluster.s3_url}; "
            f"ec_backend='cuda', pulse {HEAL_PULSE} s, repair enabled, "
            f"interval {HEAL_INTERVAL} s, grace 0 s, volume limit "
            f"{S3_VOLUME_LIMIT} B")

        # 10a. PUT everything
        r = s3("PUT", f"/{S3_BUCKET}")
        if r.status_code != 200:
            fail(f"CreateBucket answered {r.status_code}: {r.text}")
        want: dict[str, tuple[str, str]] = {}   # key -> (md5, etag)

        def put_one(i: int) -> tuple[str, float, int]:
            key, data = _s3_object(i)
            t0 = time.perf_counter()
            resp = s3("PUT", f"/{S3_BUCKET}/{key}", data)
            dt = time.perf_counter() - t0
            md5 = hashlib.md5(data).hexdigest()
            if resp.status_code != 200 or \
                    resp.headers.get("ETag") != f'"{md5}"':
                fail(f"PUT {key}: {resp.status_code} ETag "
                     f"{resp.headers.get('ETag')} for md5 {md5}")
            want[key] = (md5, md5)
            return key, dt, len(data)

        def check_one(i: int) -> tuple[float, int]:
            k, _d = _s3_object(i) if i != S3_BIG else (
                "multipart/object.bin", b"")
            r0 = time.perf_counter()
            resp = s3("GET", f"/{S3_BUCKET}/{k}", stream=True)
            md5 = hashlib.md5()
            n = 0
            for piece in resp.iter_content(1 << 20):
                md5.update(piece)
                n += len(piece)
            dt = time.perf_counter() - r0
            if resp.status_code != 200 or md5.hexdigest() != want[k][0] \
                    or resp.headers.get("ETag") != f'"{want[k][1]}"':
                fail(f"GET {k}: {resp.status_code}, ETag "
                     f"{resp.headers.get('ETag')} for {want[k]}")
            return dt, n

        t0 = time.perf_counter()
        big = _pool_map(put_one, range(S3_BIG), threads=4)
        t_big = time.perf_counter() - t0
        big_bytes = sum(n for _, _, n in big)
        log(f"[10a] PUT {S3_BIG} objects of {S3_BIG_BYTES} B (2 filer "
            f"chunks each, 4 client threads): {t_big:.3f} s, "
            f"{big_bytes / t_big / 1e6:.1f} MB/s, "
            f"{S3_BIG / t_big:.2f} objects/s, "
            f"{_lat([dt for _, dt, _ in big])}")

        key, data = _s3_object(S3_BIG)
        t0 = time.perf_counter()
        r = s3("POST", f"/{S3_BUCKET}/{key}?uploads")
        upload_id = ET.fromstring(r.content).find(
            "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId").text
        part_md5 = []

        def put_part(n: int) -> str:
            piece = data[(n - 1) * S3_PART_BYTES:n * S3_PART_BYTES]
            resp = s3("PUT", f"/{S3_BUCKET}/{key}?partNumber={n}"
                      f"&uploadId={upload_id}", piece)
            md5 = hashlib.md5(piece).hexdigest()
            if resp.status_code != 200 or \
                    resp.headers.get("ETag") != f'"{md5}"':
                fail(f"UploadPart {n}: {resp.status_code} "
                     f"{resp.headers.get('ETag')}")
            return md5

        part_md5 = _pool_map(put_part, range(1, S3_PARTS + 1), threads=4)
        body = "<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>\"{m}\"</ETag></Part>"
            for n, m in enumerate(part_md5, 1)) + \
            "</CompleteMultipartUpload>"
        r = s3("POST", f"/{S3_BUCKET}/{key}?uploadId={upload_id}",
               body.encode())
        mp_etag = hashlib.md5(b"".join(
            bytes.fromhex(m) for m in part_md5)).hexdigest() + \
            f"-{S3_PARTS}"
        t_mp = time.perf_counter() - t0
        if r.status_code != 200 or f'"{mp_etag}"' not in r.text:
            fail(f"CompleteMultipartUpload: {r.status_code} {r.text}")
        want[key] = (hashlib.md5(data).hexdigest(), mp_etag)
        log(f"[10a] multipart {key}: {S3_PARTS} parts of "
            f"{S3_PART_BYTES} B, initiate -> complete {t_mp:.3f} s, "
            f"{len(data) / t_mp / 1e6:.1f} MB/s; ETag {mp_etag}")
        del data

        t0 = time.perf_counter()
        small = _pool_map(put_one, range(S3_BIG + 1, S3_BIG + 1 + S3_SMALL))
        t_small = time.perf_counter() - t0
        small_bytes = sum(n for _, _, n in small)
        n_json = sum(1 for k, _, _ in small if k.endswith(".json"))
        log(f"[10a] PUT {S3_SMALL} small objects ({S3_SMALL_LO}-"
            f"{S3_SMALL_HI} B, {n_json} .json), {S3_THREADS} client "
            f"threads: {t_small:.3f} s, {S3_SMALL / t_small:.1f} objects/s, "
            f"{small_bytes / t_small / 1e6:.2f} MB/s, "
            f"{_lat([dt for _, dt, _ in small])}")
        total = big_bytes + S3_PARTS * S3_PART_BYTES + small_bytes
        log(f"[10a] the bucket holds {len(want)} objects, {total} B "
            f"({total / (1 << 30):.3f} GiB)")
        if total < DAT_BYTES:
            fail(f"the bucket holds {total} B, under {DAT_BYTES} B")

        # the large objects read back from the plain volumes: the
        # yardstick 10d's reads over EC shards are held against
        t0 = time.perf_counter()
        healthy = _pool_map(check_one, range(S3_BIG + 1), threads=4)
        dt = time.perf_counter() - t0
        nbytes = sum(n for _, n in healthy)
        log(f"[10a] GET the {S3_BIG + 1} large objects back before "
            f"ec.encode (plain volumes, 4 client threads): {dt:.3f} s, "
            f"{nbytes / dt / 1e6:.1f} MB/s, "
            f"{_lat([x for x, _ in healthy])}; every md5 and ETag equal")

        # 10b. ec.encode every volume of the bucket under the DLM lock
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        vids = _bucket_vids(env, S3_BUCKET)
        sizes = {}
        for vid in vids:
            for s in cluster.stores:
                v = s.find_volume(vid)
                if v is not None:
                    v.sync()
                    sizes[vid] = v.content_size()
        n_gz = _gzipped_json(cluster, want)
        repl.run_command(env, "lock")
        holder = DlmClient(cluster.filer_url).find_owner("admin")
        log(f"[10b] volumes of collection {S3_BUCKET}: {sizes} (.dat "
            f"bytes); {n_gz} of the .json objects' needles stored gzipped "
            f"(FLAG_IS_COMPRESSED); `lock` through the filer DLM: owner "
            f"{holder!r}")
        if not n_gz:
            fail("no .json object was stored gzipped")
        if holder != "shell":
            fail(f"the filer's DLM names {holder!r} as the admin lock's "
                 "owner, not the shell")
        err0 = metrics.counter_value("repair_seconds_count",
                                     {"kind": "ec", "outcome": "error"})
        ok0 = metrics.counter_value("repair_seconds_count",
                                    {"kind": "ec", "outcome": "ok"})
        bytes0 = metrics.counter_value("repair_bytes_total",
                                       {"kind": "ec"})
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t0 = time.perf_counter()
        walls = {}
        for vid in vids:
            t1 = time.perf_counter()
            repl.run_command(env, f"ec.encode -volumeId={vid}")
            walls[vid] = round(time.perf_counter() - t1, 3)
        dt = time.perf_counter() - t0
        launches["encode"] = codec_cuda.coded_matmul.launches
        rep = env.master_get("/debug/repair")
        repl.run_command(env, "unlock")
        until = time.time()
        own = sum(_encode_launches(sizes[v]) for v in vids)
        window = [x for x in rep["recent"]
                  if since <= x["finished_at"] <= until]
        rebuilt = [x for x in window if x["ok"] and
                   x["detail"].get("rebuilt")]
        refused = [x for x in window if not x["ok"]]
        other = [x for x in refused
                 if "cannot acquire admin lock" not in x["error"]]
        n_refused = metrics.counter_value(
            "repair_seconds_count", {"kind": "ec", "outcome": "error"}) \
            - err0
        n_ok = metrics.counter_value(
            "repair_seconds_count", {"kind": "ec", "outcome": "ok"}) - ok0
        rbytes = metrics.counter_value("repair_bytes_total",
                                       {"kind": "ec"}) - bytes0
        log(f"[10b] ec.encode of {len(vids)} volumes {dt:.3f} s "
            f"({walls}), {launches['encode']} launches (the encodes' own: "
            f"{own}); the watchdog meanwhile: {n_refused:.0f} repair "
            f"attempts refused the lock, {n_ok:.0f} succeeded with "
            f"{rbytes:.0f} B rebuilt; e.g. "
            f"{refused[0]['error'] if refused else None!r}")
        if rebuilt or rbytes or other:
            fail(f"the watchdog repaired during ec.encode: "
                 f"{rebuilt or other}, {rbytes} B")
        if launches["encode"] != own:
            fail(f"{launches['encode']} launches during ec.encode, the "
                 f"encodes' own are {own}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)) or \
                    any(len(u) != 1 for u in locs.values()):
                fail(f"volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        for vid in vids:
            out = commands_ec.ec_verify(env, vid, sample_mb=0,
                                        backend="cuda")
            if out.get("verified") is not True:
                fail(f"ec.verify of volume {vid}: {out}")
        dt = time.perf_counter() - t0
        launches["verify"] = codec_cuda.coded_matmul.launches
        log(f"[10b] ec.verify -sample_mb=0 -backend=cuda of every volume "
            f"clean: {dt:.3f} s, {launches['verify']} launches; shards per "
            f"server { {u: len(s) for u, s in held.items()} }")

        # 10c. lose the server holding the fewest shards
        victim = min((u for u in held if held[u]),
                     key=lambda u: (len(held[u]), u))
        lost = sorted(held[victim])
        per_vid = {vid: [s for v, s in lost if v == vid] for vid in vids}
        if any(len(s) > 4 for s in per_vid.values()):
            fail(f"{victim} holds more than m=4 shards of a volume: "
                 f"{per_vid}")
        m0 = _repair_metrics()
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_kill = time.monotonic()
        cluster.volume_threads[by_url[victim]].stop()
        rng = np.random.default_rng(SEED + 11)
        sample = [int(i) for i in rng.choice(
            np.arange(S3_BIG + 1, S3_BIG + 1 + S3_SMALL),
            S3_DEGRADED_SAMPLE, replace=False)]
        degraded: dict[str, object] = {}

        def get_one(i: int) -> tuple[float, float]:
            k, _d = _s3_object(i)
            r0 = time.perf_counter()
            resp = s3("GET", f"/{S3_BUCKET}/{k}")
            if resp.status_code != 200 or \
                    hashlib.md5(resp.content).hexdigest() != want[k][0]:
                fail(f"GET {k} during the deficit: {resp.status_code}")
            return time.perf_counter() - r0, time.monotonic()

        def degraded_pass() -> None:
            t1 = time.perf_counter()
            try:
                degraded["lat"] = _pool_map(get_one, sample)
            except BaseException as e:  # noqa: BLE001 — failed below
                degraded["error"] = e
            degraded["wall"] = time.perf_counter() - t1

        reader = threading.Thread(target=degraded_pass)
        reader.start()

        def deficit():
            st = env.master_get("/cluster/status")
            return any(e["volume"] in vids for e in st["UnderParity"])

        _poll(deficit, HEAL_DEADLINE, "a bucket volume in UnderParity")
        t_seen = time.monotonic()

        def healed():
            st = env.master_get("/cluster/status")
            return not st["UnderParity"] and all(
                len(env.ec_shard_locations(v)) == 14 for v in vids)

        _poll(healed, HEAL_DEADLINE, "every bucket volume back to 14 "
              "shards")
        t_done = time.monotonic()
        reader.join()
        if "error" in degraded:
            fail(f"degraded GETs: {degraded['error']}")
        want_vids = sorted(v for v, s in per_vid.items() if s)
        rep = env.master_get("/debug/repair")
        recs = [x for x in rep["recent"] if x["finished_at"] >= since
                and x["kind"] == "ec" and x["ok"]
                and x["detail"].get("rebuilt")]
        launches["repair"] = codec_cuda.coded_matmul.launches
        got = {x["volume"]: sorted(x["detail"]["rebuilt"]) for x in recs}
        lat = [x[0] for x in degraded["lat"]]
        before_heal = sum(1 for x in degraded["lat"] if x[1] <= t_done)
        log(f"[10c] killed {victim} ({HEAL_TOPOLOGY[by_url[victim]]}, "
            f"shards {per_vid}): detection {t_seen - t_kill:.3f} s (kill "
            f"-> UnderParity lists it), repair {t_done - t_seen:.3f} s "
            f"(deficit -> 14 live shards on every volume, grace 0); the "
            f"watchdog's rebuilds: "
            f"{[(x['volume'], x['detail'].get('rebuilt'), x['detail'].get('mode'), x['seconds']) for x in recs]}"
            f"; kernel launches during the repair {launches['repair']}; "
            f"{_metrics_since(m0)}")
        log(f"[10c] degraded GETs through S3 from the kill on: "
            f"{len(lat)} objects in {degraded['wall']:.3f} s, "
            f"{len(lat) / degraded['wall']:.1f} reads/s, {_lat(lat)}; "
            f"{before_heal} finished before the heal, all equal")
        if got != {v: per_vid[v] for v in want_vids}:
            fail(f"the watchdog rebuilt {got}, wanted {per_vid}")
        if launches["repair"] <= 0:
            fail("the watchdog's rebuild launched the kernel no time")

        # 10d. every object back through S3, ranges, listing, deletes
        t0 = time.perf_counter()
        got_big = _pool_map(check_one, range(S3_BIG + 1), threads=4)
        t1 = time.perf_counter()
        got_small = _pool_map(check_one, range(S3_BIG + 1,
                                               S3_BIG + 1 + S3_SMALL))
        t2 = time.perf_counter()
        nbig = sum(n for _, n in got_big)
        nsmall = sum(n for _, n in got_small)
        log(f"[10d] GET all {len(got_big) + len(got_small)} objects "
            f"through S3 after the repair (EC shards), every md5 and ETag "
            f"equal: the {len(got_big)} large ones (4 client threads) "
            f"{t1 - t0:.3f} s, {nbig / (t1 - t0) / 1e6:.1f} MB/s, "
            f"{_lat([x for x, _ in got_big])}; the {len(got_small)} small "
            f"ones ({S3_THREADS} threads) {t2 - t1:.3f} s, "
            f"{len(got_small) / (t2 - t1):.1f} objects/s, "
            f"{nsmall / (t2 - t1) / 1e6:.2f} MB/s, "
            f"{_lat([x for x, _ in got_small])}")
        key, data = _s3_object(S3_BIG)
        rng = np.random.default_rng(SEED + 12)
        t0 = time.perf_counter()
        for _ in range(S3_RANGES):
            a = int(rng.integers(0, len(data) - 1))
            b = min(len(data) - 1, a + int(rng.integers(1, 24 << 20)))
            resp = s3("GET", f"/{S3_BUCKET}/{key}",
                      headers={"Range": f"bytes={a}-{b}"})
            if resp.status_code != 206 or resp.content != data[a:b + 1] \
                    or resp.headers.get("Content-Range") != \
                    f"bytes {a}-{b}/{len(data)}":
                fail(f"Range bytes={a}-{b} of {key}: "
                     f"{resp.status_code}")
        log(f"[10d] {S3_RANGES} seeded Range GETs of {key} (up to 24 MiB, "
            f"across part and chunk edges): {time.perf_counter() - t0:.3f}"
            f" s, all equal")
        del data

        def list_keys() -> list[str]:
            keys, token = [], ""
            while True:
                q = "?list-type=2&max-keys=1000" + (
                    f"&continuation-token={token}" if token else "")
                resp = s3("GET", f"/{S3_BUCKET}{q}")
                root = ET.fromstring(resp.content)
                ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                keys += [c.find(ns + "Key").text
                         for c in root.findall(ns + "Contents")]
                nxt = root.find(ns + "NextContinuationToken")
                if nxt is None:
                    return keys
                token = nxt.text

        t0 = time.perf_counter()
        listed = list_keys()
        dt = time.perf_counter() - t0
        if listed != sorted(want):
            fail(f"ListObjectsV2 gave {len(listed)} keys, "
                 f"{len(set(listed) ^ set(want))} off the PUT set")
        gone = sorted(str(k) for k in np.random.default_rng(
            SEED + 13).choice(sorted(want), len(want) // 10,
                              replace=False))
        t1 = time.perf_counter()
        for at in range(0, len(gone), 1000):
            body = "<Delete>" + "".join(
                f"<Object><Key>{k}</Key></Object>"
                for k in gone[at:at + 1000]) + "</Delete>"
            resp = s3("POST", f"/{S3_BUCKET}?delete", body.encode())
            if resp.status_code != 200 or "<Error>" in resp.text:
                fail(f"DeleteObjects: {resp.status_code} {resp.text[:200]}")
        t_del = time.perf_counter() - t1
        after = list_keys()
        if after != sorted(set(want) - set(gone)):
            fail(f"after DeleteObjects the listing holds {len(after)} "
                 f"keys, wanted {len(want) - len(gone)}")
        log(f"[10d] ListObjectsV2 by pages of 1000: {len(listed)} keys in "
            f"{dt:.3f} s, exactly the PUT set; DeleteObjects of a seeded "
            f"tenth ({len(gone)} keys): {t_del:.3f} s; the listing drops "
            f"exactly those")
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        log(f"[10] current device before phase 10: {cur}, after: {now_dev}")
        if now_dev != cur:
            fail(f"phase 10 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[10] phase 10 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches}; {card}")
        return launches
    finally:
        if env is not None:
            env.close()
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 11: raft-replicated masters, a leader failover, and the new
# leader's watchdog rebuilding EC shards through the kernel
# ----------------------------------------------------------------------
HA_MASTERS = 3                   # k8s/seaweedfs-tpu.yaml: replicas: 3
HA_DEADLINE = 60.0               # longest wait for a failover step
HA_BATCHES = 8                   # assigns of count=128 after the failover


def _get_json(url: str, timeout: float = 3.0, **params):
    """GET url -> its JSON, or None when the server does not answer."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    try:
        return session().get(url, params=params or None,
                             timeout=timeout).json()
    except (OSError, ValueError):
        return None


def _raft_leader(urls: list[str]) -> str | None:
    """The url of the one master every live master names as leader."""
    states = {u: _get_json(f"{u}/raft/status") for u in urls}
    live = {u: st for u, st in states.items() if st}
    leaders = [u for u, st in live.items() if st["state"] == "leader"]
    if len(leaders) != 1:
        return None
    me = live[leaders[0]]["me"]
    if all(st["leader"] == me for st in live.values()):
        return leaders[0]
    return None


def _spawn(args: list[str], log_path: str) -> subprocess.Popen:
    """A process of the port's CLI, from the repository root, without a
    card (the masters and the follower run no codec)."""
    out = open(log_path, "ab")
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=out, stderr=subprocess.STDOUT)
    finally:
        out.close()


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")
    except OSError:
        return ""


def _raft_events(paths: list[str]) -> str:
    """The raft lines of the masters' logs (elections, leaders)."""
    out = []
    for i, path in enumerate(paths):
        out += [f"  master {i}: {line.strip()}" for line in
                _tail(path, 1 << 20).splitlines() if "raft " in line]
    return "\n".join(out[-40:])


def _fid_keys(fids) -> set[int]:
    from seaweedfs_tpu_torch.storage import types as t

    return {t.parse_file_id(f)[1] for f in fids}


def phase_ha(card: str) -> int:
    """Phase 11: three raft masters (processes of the port's CLI), five
    volume servers and a sqlite filer in this process; a 1 GiB volume
    filled through a follower and erasure-coded from a shell that lists
    the follower first; the leader SIGKILLed; the new leader's
    registry, its repair hold, its watchdog's rebuild of a lost server
    through the kernel; ids and the max volume id after the failover; the
    killed master back as a follower; a master.follower's lookups.
    -> kernel launches of the phase."""
    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.wdclient.client import MasterClient

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke11-")
    ports = free_ports(HA_MASTERS + 1)
    peers = [f"127.0.0.1:{p}" for p in ports[:HA_MASTERS]]
    urls = [f"http://{p}" for p in peers]
    logs = [os.path.join(tmp, f"master{i}.log") for i in range(HA_MASTERS)]

    def master_args(i: int) -> list[str]:
        return ["master", "-ip", "127.0.0.1", "-port", str(ports[i]),
                "-peers", ",".join(peers),
                "-raftDir", os.path.join(tmp, f"m{i}"),
                "-pulseSeconds", str(HEAL_PULSE),
                "-volumeSizeLimitMB", str(max(1, DAT_BYTES >> 20)),
                "-repair.enabled", "-repair.interval", str(HEAL_INTERVAL),
                "-repair.grace", "0"]

    procs: dict[str, subprocess.Popen] = {}
    cluster = env = None
    launches: dict[str, int] = {}

    def wait(pred, what: str, deadline: float = HA_DEADLINE):
        end = time.monotonic() + deadline
        while True:
            out = pred()
            if out:
                return out
            if time.monotonic() > end:
                for i, path in enumerate(logs):
                    log(f"[11] master {i} log tail:\n{_tail(path)}")
                fail(f"{what}: not reached in {deadline:.0f} s")
            time.sleep(0.05)

    try:
        log(f"[11] {card}")
        t0 = time.monotonic()
        for i in range(HA_MASTERS):
            procs[urls[i]] = _spawn(master_args(i), logs[i])
        # 11a. one stable leader
        leader = wait(lambda: _raft_leader(urls), "one stable raft leader")
        t_lead = time.monotonic() - t0
        follower = next(u for u in urls if u != leader)
        log(f"[11a] masters {peers} (processes of `python -m "
            f"seaweedfs_tpu_torch master -peers ... -raftDir ...`, pulse "
            f"{HEAL_PULSE} s, volume limit {DAT_BYTES} B, repair enabled, "
            f"interval {HEAL_INTERVAL} s, grace 0): leader {leader} "
            f"{t_lead:.3f} s from the start of the processes; {card}")
        cluster = Cluster(tmp, n_volume_servers=len(HEAL_TOPOLOGY),
                          max_volumes=8, pulse_seconds=HEAL_PULSE,
                          ec_backend="cuda", topology=HEAL_TOPOLOGY,
                          with_filer=True, filer_store="sqlite",
                          external_masters=urls)
        by_url = {f"{s.ip}:{s.port}": i
                  for i, s in enumerate(cluster.stores)}
        log(f"[11a] volume servers "
            f"{[(th.address, *HEAL_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f" with -mserver {','.join(peers)}, ec_backend='cuda'; filer "
            f"{cluster.filer_url} (sqlite); all registered at the leader "
            f"{time.monotonic() - t0:.3f} s from the start")

        # 11b. fill through the follower, ec.encode from a shell that
        # lists the follower first
        via_follower = CommandEnv(follower)
        w = _fill_volume_http(cluster, via_follower, "smoke11", SEED + 14,
                              DAT_BYTES)
        vid, live = w["vid"], w["live"]
        log(f"[11b] volume {vid} on {w['url']} filled through the follower "
            f"{follower} (every /vol/grow and /dir/assign 307'd to the "
            f"leader): {w['writes']} uploads ({w['overwrites']} "
            f"overwrites), {len(w['dead'])} deletes, .dat "
            f"{w['vol'].content_size()} B, {w['seconds']:.3f} s")
        env = CommandEnv(",".join([follower] + [u for u in urls
                                                if u != follower]),
                         filer_url=cluster.filer_url)
        leader = wait(lambda: _raft_leader(urls), "one stable raft leader")
        if env.master_url != leader:
            fail(f"the shell found {env.master_url}, the leader is {leader}")
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry the final size
        repl.run_command(env, "lock")
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t1 = time.perf_counter()
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        dt = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        rep = env.master_get("/debug/repair")
        repl.run_command(env, "unlock")
        window = [x for x in rep["recent"] if x["finished_at"] >= since]
        rebuilt = [x for x in window if x["ok"]]
        other = [x for x in window if not x["ok"] and
                 "cannot acquire admin lock" not in x["error"]]
        log(f"[11b] ec.encode -volumeId={vid} from a shell listing "
            f"{follower} first: {dt:.3f} s, {launches['encode']} kernel "
            f"launches; the leader's watchdog meanwhile: {len(rebuilt)} "
            f"repairs, {len(window) - len(rebuilt)} attempts refused the "
            f"admin lock")
        if launches["encode"] <= 0:
            fail("ec.encode launched the kernel no time")
        if rebuilt or other:
            fail(f"the watchdog repaired during ec.encode: "
                 f"{rebuilt or other}")
        paths = _live_shard_files(cluster, env, vid)
        if sorted(paths) != list(range(14)):
            fail(f"shards {sorted(paths)} after ec.encode")
        orig = {sid: sha256(p) for sid, p in paths.items()}

        # 11c. SIGKILL the leader
        leader = wait(lambda: _raft_leader(urls), "one stable raft leader")
        terms = {u: (_get_json(f"{u}/raft/status") or {}).get("term")
                 for u in urls}
        log(f"[11c] raft terms before the kill {terms}; the masters' raft "
            f"events so far:\n{_raft_events(logs[:HA_MASTERS])}")
        max_before = max(st["max_volume_id"] for st in
                         (_get_json(f"{u}/raft/status") for u in urls) if st)
        fids_before = list(live) + list(w["dead"])
        codec_cuda.coded_matmul.launches = 0
        dead = leader
        t_kill = time.monotonic()
        procs[dead].kill()
        procs[dead].wait(timeout=30)
        rest = [u for u in urls if u != dead]
        leader = wait(lambda: _raft_leader(rest), "a new raft leader")
        t_new = time.monotonic() - t_kill
        seen: list[dict] = []

        def sample_repairs() -> str | None:
            """Record what the current leader has queued; -> its url."""
            now = _raft_leader(rest)
            rep = _get_json(f"{now}/debug/repair") if now else None
            if rep is None:
                return None
            seen.extend(rep["recent"] + rep["in_flight"])
            if rep["queue_depth"]:
                seen.append({"queue_depth": rep["queue_depth"]})
            return now

        def registered() -> bool:
            now = sample_repairs()
            if now is None:
                return False
            st = _get_json(f"{now}/cluster/status")
            ec = _get_json(f"{now}/cluster/ec_shards", volumeId=vid)
            if not st or not ec:
                return False
            nodes = sum(len(r["nodes"]) for dc in
                        st["Topology"]["datacenters"] for r in dc["racks"])
            return nodes == len(HEAL_TOPOLOGY) and \
                sum(len(h) for h in ec["shards"].values()) == 14

        wait(registered, "the new leader's registry whole")
        t_reg = time.monotonic() - t_kill
        in_window = list(seen)
        l_window = codec_cuda.coded_matmul.launches
        # on through the fresh leader's repair hold (5 pulses) and two
        # more scans
        hold_end = t_kill + t_new + 5 * HEAL_PULSE + 2 * HEAL_INTERVAL
        while time.monotonic() < hold_end:
            sample_repairs()
            time.sleep(0.1)
        launches["failover"] = codec_cuda.coded_matmul.launches
        leader = wait(lambda: _raft_leader(rest), "one stable raft leader")
        homes = {vs.master_url for vs in cluster.volume_servers}
        log(f"[11c] SIGKILLed the leader {dead}: new leader {leader} after "
            f"{t_new:.3f} s; it lists all {len(HEAL_TOPOLOGY)} volume "
            f"servers and all 14 shards of volume {vid} {t_reg:.3f} s after "
            f"the kill; repairs the new leader queued in that window "
            f"{len(in_window)}, through its repair hold "
            f"{len(seen)}; kernel launches in the window {l_window}, "
            f"through the hold {launches['failover']}; heartbeats now go "
            f"to {sorted(homes)}; {card}")
        if in_window or seen:
            fail(f"the fresh leader queued repairs: {seen}")
        if l_window or launches["failover"]:
            fail("the kernel launched during the failover")
        if homes != {leader}:
            fail(f"heartbeats go to {homes}, not the leader {leader}")

        # 11d. lose a volume server under the new leader
        locs = env.ec_shard_locations(vid)
        held: dict[str, list[int]] = {u: [] for u in by_url}
        for sid, hosts in locs.items():
            held[hosts[0]].append(sid)
        victim = min(held, key=lambda u: (len(held[u]), u))
        lost = sorted(held[victim])
        if not 0 < len(lost) <= 4:
            fail(f"the server with the fewest shards, {victim}, holds "
                 f"{lost}: not 1..m=4")
        m0 = _repair_metrics()
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_stop = time.monotonic()
        cluster.volume_threads[by_url[victim]].stop()

        def deficit():
            st = env.master_get("/cluster/status")
            return any(e["volume"] == vid for e in st["UnderParity"])

        wait(deficit, f"volume {vid} in UnderParity", HEAL_DEADLINE)
        t_seen = time.monotonic()

        def healed():
            st = env.master_get("/cluster/status")
            return not st["UnderParity"] and \
                len(env.ec_shard_locations(vid)) == 14

        wait(healed, f"volume {vid} back to 14 shards", HEAL_DEADLINE)
        t_done = time.monotonic()
        rec = wait(lambda: _repair_results(env, since, vid, "ec"),
                   "the new leader's EC repair result")[0]
        launches["repair"] = codec_cuda.coded_matmul.launches
        now_paths = _live_shard_files(cluster, env, vid)
        bad = [sid for sid in range(14)
               if sha256(now_paths[sid]) != orig[sid]]
        log(f"[11d] stopped {victim} ({HEAL_TOPOLOGY[by_url[victim]]}, "
            f"shards {lost}): detection {t_seen - t_stop:.3f} s, repair "
            f"{t_done - t_seen:.3f} s by the new leader's watchdog (mode "
            f"{rec['detail'].get('mode')!r}, rebuilt "
            f"{rec['detail'].get('rebuilt')} on "
            f"{rec['detail'].get('rebuilder')}, {rec['seconds']} s, "
            f"{rec['bytes']} B); kernel launches {launches['repair']}; "
            f"the volume servers' repair_read_bytes_total{{mode=partial}} "
            f"+{_repair_metrics()['read_partial'] - m0['read_partial']:.0f}"
            f" B, {{mode=full}} "
            f"+{_repair_metrics()['read_full'] - m0['read_full']:.0f} B; "
            f"{card}")
        if sorted(rec["detail"].get("rebuilt", [])) != lost:
            fail(f"the repair was not the rebuild of {lost}: {rec}")
        if launches["repair"] <= 0:
            fail("the new leader's rebuild launched the kernel no time")
        if bad:
            fail(f"rebuilt shards {bad} differ from the originals")
        reader_mc = MasterClient(",".join([dead] + rest))
        reader = reader_mc.lookup(vid)[0]["url"]
        st = _http_read_pass(reader, live, "11d")
        log(f"[11d] all 14 shards sha256-equal to the originals; GET "
            f"{len(live)} live needles from {reader} (located through "
            f"{reader_mc.masters}, the dead leader first): "
            f"{st['wall']:.3f} s, {len(live) / st['wall']:.1f} reads/s, "
            f"p50 {st['p50_ms']:.3f} ms p99 {st['p99_ms']:.3f} ms, all "
            f"equal")

        # 11e. the state after the failover
        leader = wait(lambda: _raft_leader(rest), "one stable raft leader")
        grown = env.master_get("/vol/grow", collection="smoke11g")
        max_after = _get_json(f"{leader}/raft/status")["max_volume_id"]
        keys_after = _fid_keys(
            verbs.assign(follower, collection="smoke11g").fid
            for _ in range(64))
        for _ in range(HA_BATCHES):
            a = verbs.assign(leader, count=128, collection="smoke11g")
            first = min(_fid_keys([a.fid]))
            keys_after |= set(range(first, first + 128))
        reused = keys_after & _fid_keys(fids_before)
        log(f"[11e] /vol/grow after the failover: {grown}, max volume id "
            f"{max_after} (every master's mark before the kill: at most "
            f"{max_before}); {len(keys_after)} needle keys assigned after "
            f"the failover (64 single, {HA_BATCHES} batches of 128), "
            f"{len(reused)} equal to one of the {len(fids_before)} before")
        if grown.get("count") != 1 or max_after <= max_before:
            fail(f"the grown volume id {max_after} is not above "
                 f"{max_before}")
        if reused:
            fail(f"needle keys reused across the failover: {sorted(reused)[:5]}")
        t2 = time.monotonic()
        procs[dead] = _spawn(master_args(urls.index(dead)),
                             logs[urls.index(dead)])

        def caught_up():
            st = _get_json(f"{dead}/raft/status")
            return st if st and st["state"] == "follower" and \
                st["leader"] == leader.split("//", 1)[1] and \
                st["max_volume_id"] == max_after else None

        back = wait(caught_up, "the restarted master caught up")
        log(f"[11e] {dead} restarted from its -raftDir: a follower of "
            f"{back['leader']} with max volume id {back['max_volume_id']} "
            f"(term {back['term']}, commit {back['commit_index']}) "
            f"{time.monotonic() - t2:.3f} s after the restart")
        fport = ports[HA_MASTERS]
        t3 = time.monotonic()
        flog = os.path.join(tmp, "follower.log")
        logs.append(flog)
        procs["follower"] = _spawn(
            ["master.follower", "-ip", "127.0.0.1", "-port", str(fport),
             "-masters", ",".join(urls)], flog)
        furl = f"http://127.0.0.1:{fport}"
        wait(lambda: (_get_json(f"{furl}/status") or {}).get(
            "cachedVolumes", 0) >= 2, "the master follower's stream cache")
        t_warm = time.monotonic() - t3
        by_vid = _get_json(f"{furl}/dir/lookup", volumeId=vid)
        fid = next(iter(live))
        by_fid = _get_json(f"{furl}/dir/lookup", fileId=fid)
        truth = _get_json(f"{leader}/dir/lookup", volumeId=vid)
        log(f"[11e] master.follower {furl}, its cache warm "
            f"{t_warm:.3f} s after its start: /status "
            f"{_get_json(f'{furl}/status')}; /dir/lookup?volumeId={vid} "
            f"{len((by_vid or {}).get('locations', []))} holders, "
            f"?fileId={fid} the same: "
            f"{by_fid == by_vid}")
        if not by_vid or not by_vid.get("locations") or by_fid != by_vid \
                or sorted(l["url"] for l in by_vid["locations"]) != \
                sorted(l["url"] for l in truth["locations"]):
            fail(f"master.follower lookups {by_vid} / {by_fid}, the "
                 f"leader's {truth}")

        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        log(f"[11f] the masters' raft events:\n"
            f"{_raft_events(logs[:HA_MASTERS])}")
        log(f"[11f] current device before phase 11: {cur}, after: "
            f"{now_dev}")
        if now_dev != cur:
            fail(f"phase 11 moved the current device from {cur} to "
                 f"{now_dev}")
        total = sum(launches.values())
        log(f"[11] phase 11 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches} ({total}); {card}")
        return total
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import seaweedfs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository: {e}")
    card = phase_device()
    max_err, timings = phase_kernel()
    launches, shard_hashes = phase_main_path()
    phase_batched()
    sweep_launches, decode_launches = phase_router_lifecycle()
    gen_launches, reb_launches = phase_store()
    cluster_launches = phase_cluster(card)
    mesh = phase_mesh(shard_hashes)
    heal_launches = phase_heal(card)
    s3_launches = phase_s3(card)
    ha_launches = phase_ha(card)
    ms, plain_ms, bound_ms = timings["encode m=4"]
    rs28_ms, rs28_plain_ms, rs28_bound_ms = timings["encode k=28 m=4"]
    rebuild_ms, rebuild_plain_ms, rebuild_bound_ms = timings["rebuild m=1"]
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
        "rebuild_ms": rebuild_ms,
        "rebuild_plain_ms": rebuild_plain_ms,
        "rebuild_bound_ms": rebuild_bound_ms,
        "sweep_launches": sweep_launches,
        "decode_launches": decode_launches,
        "store_launches": gen_launches + reb_launches,
        "cluster_launches": sum(cluster_launches.values()),
        "cluster_launches_by_command": cluster_launches,
        "rs28_ms": rs28_ms,
        "rs28_plain_ms": rs28_plain_ms,
        "rs28_bound_ms": rs28_bound_ms,
        "mesh_launches": mesh["mesh_launches"],
        "mesh_launches_by_device": mesh["mesh_launches_by_device"],
        "batched_mbps": {k: round(v["mbps"], 1) if isinstance(v, dict)
                         else round(v, 1)
                         for k, v in mesh["batched"].items()},
        "sharded_rebuild_ms": mesh["sharded_rebuild"],
        "heal_launches": heal_launches,
        "s3_launches": s3_launches,
        "ha_launches": ha_launches,
    }]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
