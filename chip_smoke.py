#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (seaweedfs_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a host with one GPU

Phases, each fatal on failure (exit code 1, no result line):

1. Device and build: the card's name and power limit (nvidia-smi), and the
   build of every kernel in seaweedfs_tpu_torch/csrc/ with nvcc; the host
   codec and (in the background, for phase 15) the native data plane
   build with g++.
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

12. The tiered-storage lifecycle, driven by the master's tiering
   controller. The cold tier is a second port cluster in this process
   (a master, one volume server, a sqlite filer and its S3 gateway,
   bucket `cold`, no tiering), standing in for the S3 endpoint a
   deployment offloads to. The main cluster: phase 9's five volume
   servers over three racks on "cuda", a sqlite filer (the DLM), the
   watchdog's repairs at grace 0, -tier.enabled, -tier.interval=1,
   -tier.sealAfterIdle=5, -tier.offloadAfterIdle=5,
   -tier.recallReads=1000, -tier.recallWindow=120, -tier.remote the
   SigV4 s3 conf of `cold`, -tier.stateDir, and tier_backends
   {"s3.default": cold}. Each step is fatal on failure, as is any
   transition the controller fails:
   a. Phase 9's seeded needles fill one collection's volume to the
      1 GiB limit.
   b. The controller seals the idle volume: seconds from the last write
      to `ec` in /debug/tiering, its ec.encode's wall, kernel launches
      (> 0), repairs during the seal (must be 0).
   c. It offloads the shard bytes: `remote` within 60 s; `cold` holds
      exactly the 14 objects tier-ec/<col>/<vid>/NN.ec, each
      sha256-equal to the shard it replaced; no local .ecNN, the .ecx
      kept; /cluster/status Tiering.BytesMoved.offload > 0; seconds,
      MB/s and the process's peak RSS.
   d. 512 seeded needles read cold (ranged SigV4 GETs of the cold
      gateway), all equal: reads/s, p50 / p99.
   e. The server with the fewest shards stopped: the watchdog rebuilds
      them through the kernel (launches > 0) from the remote-backed
      survivors; detection and repair seconds; rebuilt shards
      sha256-equal; 256 needles equal; then the controller adopts `ec`,
      offloads the rebuilt shards onto the same keys and the volume is
      `remote` again (the tier state tests/test_torch_tiering.py shows
      the reference reaching): seconds from the stop.
   f. Reads (4 threads) until the controller recalls the volume to
      `hot`: the recall's seconds, MB/s, its decode's launches and the
      peak RSS; every needle equal from the plain volume, no object of
      the volume in `cold`, no .rsm left.
   g. With the controller stopped (it would seal the hot volume
      again), volume.tier.upload of the .dat to s3.default, 256 needles
      through ranged GETs, volume.tier.download: the object gone, every
      needle equal; each wall.
   h. The current device is what it was before phase 12.

13. The robustness and observability layer under the reference's
   seeded chaos spec (tests/test_chaos_deterministic.py:
   volume:*:error=0.05, filer:*:error=0.05, 30 ms delays on both, seed
   20240817, 5 attempts per hop). The master is a process of `python
   -m seaweedfs_tpu_torch -fault.spec ... -fault.seed ... -trace.sample
   1 -retry.maxAttempts 5 master` (pulse 0.5 s, the watchdog at grace
   0, -tier.enabled, -master.scrapeInterval 0.5); phase 9's five volume servers over three racks on "cuda", a
   sqlite filer (the DLM) and the S3 gateway run here, with one span
   pusher to the master. Each step is fatal on failure:
   a. No faults: phase 9's seeded needles fill a 1 GiB volume; 512
      seeded reads and 200 S3 PUT/GET cycles (the reference chaos
      test's objects) are the baseline; a copy of the .dat is encoded
      with the native codec.
   b. Faults on, in this process (the master has them from its flags).
   c. The tiering controller's seal (POST /debug/tiering): one
      attempt, exactly ec.encode's launches (4 at 1 GiB), no repair
      during it, 14 shards sha256-equal to the fault-free encode.
   d. The server with the fewest shards stopped: the master's breaker
      for it reads open in its topology dump and at /debug/breakers
      (its federation scrape trips it); the watchdog's partial rebuild
      in one attempt with one launch per 4 MiB chunk of a shard (26 at
      1 GiB), 14 live shards, rebuilt ones sha256-equal; 512 degraded
      reads run meanwhile; the server restarted at its address (an
      empty disk) re-registers and the master's breaker reads closed.
   e. 200 S3 PUT/GET cycles: md5 and ETag equal, the listing exact, one
      needle per PUT in the bucket's volumes.
   f. /cluster/traces holds the seal's trace (the controller's `tier
      seal` span, the volume server's handle_ec_generate span and its
      ec.write_ec_files span) and the rebuild's (the watchdog's `repair
      ec` span, its client span over the rebuilder's
      handle_ec_rebuild_partial span), each across both processes, no
      span_id twice, as many spans in ?format=otlp, none at the
      collector's 512-span guard; no pusher dropped a span; faults fired on the volume and filer hops. Printed: each
      operation's root and server span beside the launches' CUDA-event
      time.
   g. /debug/workload: cluster.read_size.count > 0.
   h. The master answers a 1 MiB + 1 body with 413.
   i. The current device is what it was before phase 13.

14. The secured, durable write path. The master is a process of `python
   -m seaweedfs_tpu_torch -security <json> master -jwt.secret ...` on
   HTTPS (pulse 0.5 s, the watchdog at grace 0, -tier.enabled), with
   certificates from utils/tls.generate_self_signed and SSL_CERT_FILE /
   REQUESTS_CA_BUNDLE naming their CA; four volume servers at
   -commit.durability=batch under the same secret over three racks on
   "cuda", a sqlite filer (plain: the watchdog's DLM lock reaches it
   over http://, as the reference's does) and the S3 gateway on HTTPS
   with per-tenant qos (a provisioned tenant and a greedy one) run here;
   the fifth volume server, the victim, is a process of `volume
   -commit.durability batch -jwt.secret ...`. Each step is fatal:
   a. 401 on a replicated volume's primary and replica for no token, a
      tampered signature, an expired token and another fid's token; the
      signed write and two `_N` slots under the base fid's token 201
      with X-Sw-Durability: batch; then a 1 GiB volume filled through
      /dir/assign and Bearer uploads of 4 MiB needles on 8 threads,
      every ack 201 with X-Sw-Durability: batch.
   b. The primary's /debug/commit over the fill: fewer fsyncs than
      acked writes (writes per fsync printed); each of its acks came
      after a durable commit (fdatasync) of its volume that began after
      the write's append (its CommitScheduler wrapped in-process).
   c. 200 S3 PUT/GET cycles over https, md5- and ETag-equal; a client
      without the CA fails verification and plain HTTP fails at the
      gateway and the master; a master.follower on HTTPS locates the
      volume from its KeepConnected stream over wss://.
   d. The greedy tenant bursts 10x its provisioned rate for 5 s beside
      the provisioned tenant: the excess is shed 503 with Retry-After
      and X-Sw-Retryable, exactly as counted in qos_shed_total; the
      provisioned tenant never fails (p50 / p99); every acked object of
      both reads back. Then limits in the filer KV `s3/circuit_breaker`:
      after the reload a writeCount-0 bucket answers 503
      TooManyRequests, a PUT with no length 411, a DELETE with none 204.
   e. The tiering controller's seal of the 1 GiB volume (POST
      /debug/tiering): exactly ec.encode's 4 launches in one attempt, 0
      repairs, 14 shards sha256-equal to the plain version's encode of
      the same .dat on the card.
   f. The victim SIGKILLed at a seeded point while 8 writers are
      mid-write to a second volume on it (its /debug/commit just before:
      fewer fsyncs than writes); the watchdog rebuilds the victim's
      shards of the sealed volume elsewhere through the kernel (26
      launches), the 14 live shards sha256-equal to step e's; the
      victim restarted on the same directories reads every acked write
      back byte-equal, its .dat on the 8-byte record grid.
   g. The walls, launches, CUDA-event times and the device's busy share
      of the phase.
   The victim runs `-dataplane python`: its checks read the Python
   commit scheduler, which the native front's own queue bypasses.

15. The native C++ data plane (seaweedfs_tpu_torch/native/dataplane.cc,
   built with g++ at first use). An in-process master (volume limit
   2 GiB); two volume servers started through the CLI's own `volume`
   wiring (cli._start_volume) in this process — so the seal's launches
   are counted here — one `-dataplane native`, one `-dataplane python`,
   both `-jwt.secret` and `-commit.durability batch`, `-ec.backend
   cuda`. Each step is fatal on failure:
   a. One seeded fill: 1 GiB of needles (1 KiB - 1 MiB log-uniform, as
      phase 6) on one volume, then 8,192 needles of 1-64 KiB on a
      second, as signed POSTs replayed by the port's C++ bench client
      (native.dataplane.bench_raw) on 8 keep-alive connections; then a
      GET of every needle the same way. The native front takes all of
      it, the Python front its first 128 MiB and 1,024 small needles
      (at its rates the whole would take two minutes). Requests/s, MB/s,
      p50 / p99 of each pass on each front. Every body GET through the
      native front byte-equal; the Python front's checked in its store
      and on 512 seeded GETs. The native process's /status fast_post and
      fast_get and its native_front_requests_total grow by at least the
      requests served.
   b. An unsigned POST answered 401 by the front (jwt_reject +1); 8
      signed POSTs 201 with X-Sw-Durability: batch (fast_post +8);
      writes per fsync from the native_commit_* lines of /metrics.
   c. ec.encode of the natively filled 1 GiB volume (detached from the
      plane first): exactly 4 launches (CUDA events); 512 seeded
      needles GET through the native front's port, relayed to the EC
      volume, byte-equal.
   d. `Cluster(with_s3=True, s3_native=True, filer_native=True)` on
      one volume server: the first 1,024 of phase 10's 4,096 signed
      objects of 1-64 KiB (the sqlite filer's per-entry commit holds
      the PUTs near phase 10's rate) PUT and GET through the native S3
      front on phase 10's 8 client threads
      (objects/s, p50 / p99 beside phase 10's Python-front numbers of
      this run); md5 and ETag equal; native_fronts_requests_total
      {front="s3"} counts them; the bucket's volumes sealed (launches as
      their sizes give) and 256 seeded objects read back through S3.
   e. 512 files of 1-64 KiB PUT and GET through the native filer
      front, each GET beside the Python filer's GET of the same path:
      equal statuses and bodies.

The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import glob
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
# numbers an earlier phase measured that a later one prints beside its
# own (phase 10's Python S3 front beside phase 15's native one)
SAME_RUN: dict = {}
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
    from seaweedfs_tpu_torch.native import build as native_build

    # the data plane (phase 15) compiles with g++ meanwhile: its file
    # lock makes phase 15's load wait for this build, not start another
    threading.Thread(target=native_build.build_dataplane,
                     kwargs={"verbose": False}, daemon=True,
                     name="dataplane-build").start()
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


FILL_ASSIGN_BATCH = 64           # fids per /dir/assign?count= of a fill


def _fill_volume_http(cluster, env, collection: str, seed: int,
                      target: int, replication: str = "") -> dict:
    """Grow one volume of `collection` and fill it with seeded needles
    through assign + upload over HTTP until its .dat holds `target`
    bytes (1 KiB - 1 MiB log-uniform; 5% of writes overwrite an earlier
    id), then delete 2% of the ids. Each /dir/assign asks for
    FILL_ASSIGN_BATCH fids (the slots fid, fid_1, ..., as the filer's
    batched assigns). -> vid, the primary's url and Volume, {fid:
    sha256} of the live needles, the deleted fids, and the counts and
    seconds of the writes."""
    from seaweedfs_tpu_torch.operation import verbs

    grown = env.master_get("/vol/grow", collection=collection, count=1,
                           **({"replication": replication}
                              if replication else {}))
    if grown.get("count") != 1:
        fail(f"/vol/grow answered {grown}")
    rng = np.random.default_rng(seed)
    lo, hi = np.log(1 << 10), np.log(1 << 20)
    live: dict[str, str] = {}
    slots: collections.deque = collections.deque()
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
            if not slots:
                a = verbs.assign(env.master_url, collection=collection,
                                 replication=replication,
                                 count=FILL_ASSIGN_BATCH)
                if vid is None:
                    vid, url = int(a.fid.split(",")[0]), a.url
                    vol = next(s.find_volume(vid) for s in cluster.stores
                               if s.has_volume(vid) and
                               f"{s.ip}:{s.port}" == url)
                elif int(a.fid.split(",")[0]) != vid or a.url != url:
                    fail(f"assign left volume {vid}: {a.fid} on {a.url}")
                slots.extend([a.fid] + [f"{a.fid}_{i}"
                                        for i in range(1, int(a.count))])
            fid = slots.popleft()
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
    """SigV4-signed requests to the gateway as one identity (phase 10's
    by default), one pooled session per thread."""

    def __init__(self, url: str, key: str = S3_KEY, secret: str = S3_SECRET):
        self.url = url
        self.key, self.secret = key, secret

    def __call__(self, method: str, path: str, data: bytes = b"",
                 headers: dict | None = None, stream: bool = False):
        from seaweedfs_tpu_torch.rpc.httpclient import session
        from seaweedfs_tpu_torch.s3.auth import sign_request

        url = self.url + path
        hdrs = sign_request(method, url, self.key, self.secret,
                            payload=data, extra_headers=headers)
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
        SAME_RUN["10a small PUT"] = (S3_SMALL / t_small,
                                     [dt for _, dt, _ in small])
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
        SAME_RUN["10d small GET (EC shards)"] = (
            len(got_small) / (t2 - t1), [x for x, _ in got_small])
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
        # the polls above met the masters before they listened: their
        # refusals opened this process's breakers for them, which would
        # refuse the first hops below until a half-open probe closes them
        from seaweedfs_tpu_torch.utils import retry

        for u in urls:
            retry.reset_peer_breaker(u.split("://", 1)[1])
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


# ----------------------------------------------------------------------
# phase 12: the tiered-storage lifecycle (hot -> ec -> remote -> hot)
# ----------------------------------------------------------------------
TIER_INTERVAL = 1.0              # -tier.interval
TIER_IDLE = 5.0                  # -tier.sealAfterIdle, -tier.offloadAfterIdle
TIER_RECALL_READS = 1000         # -tier.recallReads
TIER_RECALL_WINDOW = 120.0       # -tier.recallWindow
TIER_COLD_READS = 512            # 12d's cold reads
TIER_SAMPLE = 256                # 12e's and 12g's samples
TIER_THREADS = 8                 # client threads of the full read passes
TIER_DEADLINE = 90.0             # longest wait for a transition
TIER_BUCKET = "cold"              # signed with phase 10's identity


class _RssPeak:
    """Samples this process's resident set (VmRSS) every 0.1 s on a
    thread; peak(label) is the largest sample since mark(label)."""

    def __init__(self):
        self._peaks: dict[str, int] = {}
        self._base: dict[str, int] = {}
        self._label = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    @staticmethod
    def rss() -> int:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) << 10
        return 0

    def _run(self) -> None:
        while not self._stop.wait(0.1):
            label = self._label
            if label:
                self._peaks[label] = max(self._peaks.get(label, 0),
                                         self.rss())

    def mark(self, label: str) -> None:
        self._base[label] = self._peaks[label] = self.rss()
        self._label = label

    def peak(self, label: str) -> str:
        return (f"{self._peaks.get(label, 0) / 2**30:.2f} GiB (from "
                f"{self._base.get(label, 0) / 2**30:.2f} GiB at its start)")

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


def _tier_snapshot(env) -> dict:
    return env.master_get("/debug/tiering")


def _tier_results(env, vid: int, transition: str) -> list[dict]:
    """The controller's results for `vid` and `transition`, newest
    first; fail on any that did not succeed (a transition that failed
    or gave up is never passed over)."""
    out = []
    for r in _tier_snapshot(env)["recent"]:
        if r["volume"] != vid:
            continue
        if not r["ok"]:
            fail(f"the tiering controller's {r['transition']} of volume "
                 f"{vid} failed (attempt {r['attempts']}): {r['error']}")
        if r["transition"] == transition:
            out.append(r)
    return out


def _tier_state(env, vid: int) -> str | None:
    return _tier_snapshot(env)["volumes"].get(str(vid), {}).get("state")


def _get_pass(fids: list, where, live: dict, label: str,
              threads: int = 1) -> dict:
    """GET each fid over HTTP from where(fid) (host:port), each read
    sha256-equal to `live`, or fail. -> wall, bytes, latencies."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    def one(fid):
        r0 = time.perf_counter()
        r = session().get(f"http://{where(fid)}/{fid}", timeout=(5.0, 60.0))
        body = r.content
        dt = time.perf_counter() - r0
        if r.status_code != 200 or \
                hashlib.sha256(body).hexdigest() != live[fid]:
            fail(f"{label}: GET {fid} from {where(fid)} gave status "
                 f"{r.status_code} and other bytes")
        return dt, len(body)

    t0 = time.perf_counter()
    out = _pool_map(one, fids, threads=threads) if threads > 1 else \
        [one(f) for f in fids]
    wall = time.perf_counter() - t0
    lat = [dt for dt, _ in out]
    return {"wall": wall, "bytes": sum(n for _, n in out), "n": len(out),
            "lat": _lat(lat), "rate": len(out) / wall}


def _cold_objects(client, prefix: str) -> dict[str, int]:
    return {o.key: o.size for o in client.list_objects(prefix)}


def phase_tier(card: str) -> dict:
    """Phase 12: the tiered-storage lifecycle at 1 GiB, driven by the
    master's tiering controller; the cold tier is a second port cluster
    behind its S3 gateway. -> kernel launches of its steps."""
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.s3.client import S3Client
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.storage import store as store_mod
    from seaweedfs_tpu_torch.utils import metrics

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke12-")
    launches: dict[str, int] = {}
    cold = cluster = env = None
    col = "smoke12"
    rss = _RssPeak()
    try:
        # the cold tier: a port cluster of its own, one volume server,
        # a sqlite filer and the S3 gateway, bucket "cold", no tiering
        cold = Cluster(os.path.join(tmp, "cold"), n_volume_servers=1,
                       max_volumes=16, volume_size_limit=DAT_BYTES,
                       pulse_seconds=HEAL_PULSE, ec_backend="native",
                       with_filer=True, filer_store="sqlite",
                       with_s3=True, s3_config=S3_CONFIG)
        s3 = _S3Client(cold.s3_url)
        r = s3("PUT", f"/{TIER_BUCKET}")
        if r.status_code != 200:
            fail(f"CreateBucket {TIER_BUCKET}: {r.status_code} {r.text}")
        conf = {"endpoint": cold.s3_url, "bucket": TIER_BUCKET,
                "access_key": S3_KEY, "secret_key": S3_SECRET}
        remote = {"type": "s3", **conf}
        bucket = S3Client(**conf)
        cluster = Cluster(os.path.join(tmp, "main"),
                          n_volume_servers=len(HEAL_TOPOLOGY),
                          max_volumes=8, volume_size_limit=DAT_BYTES,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                          topology=HEAL_TOPOLOGY, repair_enabled=True,
                          repair_interval=HEAL_INTERVAL, repair_grace=0.0,
                          with_filer=True, filer_store="sqlite",
                          tier_enabled=True, tier_interval=TIER_INTERVAL,
                          tier_seal_after_idle=TIER_IDLE,
                          tier_offload_after_idle=TIER_IDLE,
                          tier_recall_reads=TIER_RECALL_READS,
                          tier_recall_window=TIER_RECALL_WINDOW,
                          tier_remote=remote,
                          tier_state_dir=os.path.join(tmp, "tierstate"),
                          tier_backends={"s3.default": conf})
        env = CommandEnv(cluster.master_url, filer_url=cluster.filer_url)
        by_url = {f"{s.ip}:{s.port}": i
                  for i, s in enumerate(cluster.stores)}
        log(f"[12] {card}")
        log(f"[12] cold tier: master {cold.master_url}, one volume "
            f"server, sqlite filer, s3 {cold.s3_url}, bucket "
            f"{TIER_BUCKET!r}; main: master {cluster.master_url}, volume "
            f"servers {[(th.address, *HEAL_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f", sqlite filer {cluster.filer_url}; ec_backend='cuda', "
            f"pulse {HEAL_PULSE} s, repair at grace 0; -tier.enabled "
            f"-tier.interval={TIER_INTERVAL} -tier.sealAfterIdle="
            f"{TIER_IDLE} -tier.offloadAfterIdle={TIER_IDLE} "
            f"-tier.recallReads={TIER_RECALL_READS} -tier.recallWindow="
            f"{TIER_RECALL_WINDOW} -tier.remote=<s3 conf of "
            f"{TIER_BUCKET!r}>, tier_backends s3.default = the same")

        # 12a. fill one collection's volume to the 1 GiB limit
        w = _fill_volume_http(cluster, env, col, SEED + 7, DAT_BYTES)
        vid, live = w["vid"], w["live"]
        t_last = time.time()
        log(f"[12a] volume {vid} on {w['url']}: {w['writes']} uploads "
            f"({w['overwrites']} overwrites), {len(w['dead'])} deletes, "
            f".dat {w['vol'].content_size()} B, {w['seconds']:.3f} s")

        # 12b. the controller seals the idle volume
        codec_cuda.coded_matmul.launches = 0
        rep0 = env.master_get("/debug/repair")["recent"]
        ec_at = _poll(lambda: _tier_state(env, vid) in
                      ("ec", "offloading", "remote") and time.time(),
                      TIER_DEADLINE, f"volume {vid} sealed", step=0.05)
        launches["seal"] = codec_cuda.coded_matmul.launches
        seal = _poll(lambda: _tier_results(env, vid, "seal"),
                     TIER_DEADLINE, "the seal's result")[0]
        until = time.time()
        paths = _live_shard_files(cluster, env, vid)
        if sorted(paths) != list(range(14)):
            fail(f"shards {sorted(paths)} after the seal")
        orig = {sid: sha256(p) for sid, p in paths.items()}
        shard_size = os.path.getsize(paths[0])
        window = [x for x in env.master_get("/debug/repair")["recent"]
                  if x not in rep0 and t_last <= x["finished_at"] <= until]
        rebuilt = [x for x in window if x["ok"]]
        refused = [x for x in window if not x["ok"]]
        other = [x for x in refused
                 if "cannot acquire admin lock" not in x["error"]]
        log(f"[12b] sealed: ec in /debug/tiering {ec_at - t_last:.3f} s "
            f"after the last write (-tier.sealAfterIdle={TIER_IDLE}); "
            f"the controller's ec.encode {seal['seconds']} s, reason "
            f"{seal['reason']!r}; kernel launches {launches['seal']}; "
            f"repairs during the seal {len(rebuilt)} (attempts the lock "
            f"refused: {len(refused)}); 14 shards of {shard_size} B hashed")
        if launches["seal"] <= 0:
            fail("the controller's seal launched the kernel no time")
        if rebuilt or other:
            fail(f"the watchdog repaired during the seal: "
                 f"{rebuilt or other}")

        # 12c. the controller offloads the shard bytes to the cold tier
        rss.mark("12c")
        off0 = metrics.counter_value("tier_bytes_moved_total",
                                     {"dir": "offload"})
        remote_at = _poll(lambda: _tier_state(env, vid) == "remote" and
                          time.time(), 60.0,
                          f"volume {vid} remote", step=0.05)
        off = _poll(lambda: _tier_results(env, vid, "offload"),
                    TIER_DEADLINE, "the offload's result")[0]
        moved = metrics.counter_value(
            "tier_bytes_moved_total", {"dir": "offload"}) - off0
        prefix = f"tier-ec/{col}/{vid}/"
        objs = _cold_objects(bucket, prefix)
        want = {store_mod.tier_shard_key(col, vid, sid) for sid in range(14)}
        if set(objs) != want:
            fail(f"the cold bucket holds {sorted(objs)} under {prefix}, "
                 f"not the 14 shard keys")
        bad = []
        for sid in range(14):
            blob = bucket.get_object(store_mod.tier_shard_key(col, vid, sid))
            if hashlib.sha256(blob).hexdigest() != orig[sid]:
                bad.append(sid)
        if bad:
            fail(f"cold objects of shards {bad} differ from the shards")
        left = glob.glob(os.path.join(tmp, "main", "*",
                                      f"{col}_{vid}.ec[0-9][0-9]"))
        ecx = glob.glob(os.path.join(tmp, "main", "*", f"{col}_{vid}.ecx"))
        if left or not ecx:
            fail(f"after the offload: local shards {left}, .ecx {ecx}")
        peak_c = rss.peak("12c")
        offloaded = _poll(lambda: env.master_get("/cluster/status")[
            "Tiering"]["BytesMoved"].get("offload", 0), 30.0,
            "BytesMoved.offload in /cluster/status")
        log(f"[12c] remote {remote_at - ec_at:.3f} s after ec "
            f"(-tier.offloadAfterIdle={TIER_IDLE}); the controller's "
            f"offload {off['seconds']} s, {off['bytes']} B, "
            f"{off['bytes'] / off['seconds'] / 1e6:.1f} MB/s "
            f"(tier_bytes_moved_total{{dir=offload}} +{moved:.0f} B); "
            f"{TIER_BUCKET!r} holds the 14 objects under {prefix}, each "
            f"sha256-equal to its shard; no local .ecNN, .ecx on "
            f"{len(ecx)} servers; peak RSS of this process (both "
            f"clusters) through the offload {peak_c}; /cluster/status Tiering.BytesMoved."
            f"offload {offloaded:.0f} (the federated sum over every "
            f"scraped server of this one process, each rendering the "
            f"same registry)")

        # 12d. cold reads
        rng = np.random.default_rng(SEED + 12)
        fids = sorted(live)
        holder = env.ec_shard_locations(vid)[0][0]
        sample = [fids[i] for i in rng.choice(
            len(fids), min(TIER_COLD_READS, len(fids)), replace=False)]
        st = _get_pass(sample, lambda f: holder, live, "12d")
        log(f"[12d] GET {st['n']} needles from {holder} (remote-backed "
            f"shards: each interval a ranged SigV4 GET of the cold "
            f"gateway -> filer -> its volume server): {st['wall']:.3f} s, "
            f"{st['rate']:.1f} reads/s, {st['lat']}, all equal")

        # 12e. lose the cold holder with the fewest shards
        locs = env.ec_shard_locations(vid)
        held: dict[str, list[int]] = {u: [] for u in by_url}
        for sid, urls in locs.items():
            for u in urls:
                held[u].append(sid)
        victim = min((u for u in held if held[u]),
                     key=lambda u: (len(held[u]), u))
        lost = sorted(held[victim])
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_kill = time.monotonic()
        cluster.volume_threads[by_url[victim]].stop()

        def deficit():
            st = env.master_get("/cluster/status")
            return any(e["volume"] == vid for e in st["UnderParity"])

        _poll(deficit, HEAL_DEADLINE, f"volume {vid} in UnderParity")
        t_seen = time.monotonic()
        _poll(lambda: not env.master_get("/cluster/status")["UnderParity"]
              and len(env.ec_shard_locations(vid)) == 14,
              HEAL_DEADLINE, f"volume {vid} back to 14 shards")
        t_done = time.monotonic()

        def repaired():
            # attempts the admin lock refused are retried; any other
            # failed repair fails the run
            recent = [x for x in env.master_get("/debug/repair")["recent"]
                      if x["finished_at"] >= since]
            other = [x for x in recent if not x["ok"] and
                     "cannot acquire admin lock" not in x["error"]]
            if other:
                fail(f"the watchdog recorded a failed repair: {other[0]}")
            return [x for x in recent if x["ok"] and x["volume"] == vid
                    and x["kind"] == "ec"]

        rec = _poll(repaired, HEAL_DEADLINE,
                    "the watchdog's EC repair result")[0]
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        if rec["reason"] != "watchdog" or \
                sorted(rec["detail"].get("rebuilt", [])) != lost:
            fail(f"the watchdog's repair was not the rebuild of {lost}: "
                 f"{rec}")
        if launches["rebuild"] <= 0:
            fail("the watchdog's rebuild launched the kernel no time")
        locs = env.ec_shard_locations(vid)
        for sid in lost:
            store = cluster.stores[by_url[locs[sid][0]]]
            shard = store.ec_volumes[vid].shards[sid]
            if shard.remote or sha256(shard.path) != orig[sid]:
                fail(f"rebuilt shard {sid} is remote or differs from "
                     f"the original")
        sample = [fids[i] for i in rng.choice(
            len(fids), min(TIER_SAMPLE, len(fids)), replace=False)]
        reader = env.ec_shard_locations(vid)[lost[0]][0]
        st = _get_pass(sample, lambda f: reader, live, "12e")
        log(f"[12e] stopped {victim} (shards {lost}): detection "
            f"{t_seen - t_kill:.3f} s, repair {t_done - t_seen:.3f} s "
            f"(-> 14 live shards); the watchdog's rebuild {rec['seconds']} "
            f"s, {rec['bytes']} B, mode {rec['detail'].get('mode')!r} on "
            f"{rec['detail'].get('rebuilder')}, every survivor's byte "
            f"read from the cold tier; kernel launches "
            f"{launches['rebuild']}; rebuilt shards sha256-equal; GET "
            f"{st['n']} needles from {reader}: {st['rate']:.1f} reads/s, "
            f"{st['lat']}, all equal")
        states = []

        def remote_again():
            s = _tier_state(env, vid)
            if not states or states[-1] != s:
                states.append(s)
            return s == "remote" and \
                len(_tier_results(env, vid, "offload")) == 2

        _poll(remote_again, TIER_DEADLINE, f"volume {vid} remote again",
              step=0.05)
        t_remote = time.monotonic()
        off2 = _tier_results(env, vid, "offload")[0]
        objs = _cold_objects(bucket, prefix)
        if set(objs) != want:
            fail(f"after the second offload the bucket holds "
                 f"{sorted(objs)}")
        for sid in lost:
            blob = bucket.get_object(store_mod.tier_shard_key(col, vid, sid))
            if hashlib.sha256(blob).hexdigest() != orig[sid]:
                fail(f"the re-offloaded object of shard {sid} differs")
        log(f"[12e] tier states after the rebuild {states}: the rebuilt "
            f"shards are local, the controller adopted 'ec' and "
            f"offloaded them again onto the same keys "
            f"({off2['seconds']} s, {off2['bytes']} B); remote again "
            f"{t_remote - t_kill:.3f} s after the stop; still exactly "
            f"14 objects, the re-offloaded ones sha256-equal")

        # 12f. reads until the controller recalls the volume to hot
        codec_cuda.coded_matmul.launches = 0
        rss.mark("12f")
        holder = env.ec_shard_locations(vid)[0][0]
        n_reads = [0]
        t0 = time.monotonic()

        def read_until_recall(i: int) -> int:
            n = 0
            r = np.random.default_rng([SEED, 12, i])
            while _tier_state(env, vid) == "remote" and \
                    time.monotonic() - t0 < TIER_RECALL_WINDOW:
                batch = [fids[j] for j in r.choice(len(fids), 16)]
                n += _get_pass(batch, lambda f: holder, live, "12f")["n"]
            return n

        n_reads[0] = sum(_pool_map(read_until_recall, range(4), threads=4))
        t_stop = time.monotonic()
        _poll(lambda: _tier_state(env, vid) == "hot", TIER_DEADLINE,
              f"volume {vid} recalled to hot", step=0.05)
        t_hot = time.monotonic()
        recall = _poll(lambda: _tier_results(env, vid, "recall"),
                       TIER_DEADLINE, "the recall's result")[0]
        peak_f = rss.peak("12f")
        launches["decode"] = codec_cuda.coded_matmul.launches
        objs = _cold_objects(bucket, prefix)
        # the stopped server's disk keeps its stale files: live servers
        dead = {l.dir for l in cluster.stores[by_url[victim]].locations}
        rsm = [p for p in glob.glob(os.path.join(
            tmp, "main", "*", f"{col}_{vid}.rsm"))
            if os.path.dirname(p) not in dead]
        if objs or rsm:
            fail(f"after the recall: objects {sorted(objs)}, .rsm {rsm}")
        locs = env.volume_locations(vid)
        st = _get_pass(fids, lambda f: locs[0], live, "12f",
                       threads=TIER_THREADS)
        log(f"[12f] {n_reads[0]} reads in {t_stop - t0:.3f} s (4 "
            f"threads) until the recall began; hot {t_hot - t_stop:.3f} s "
            f"later; the controller's recall {recall['seconds']} s, "
            f"{recall['bytes']} B down, "
            f"{recall['bytes'] / recall['seconds'] / 1e6:.1f} MB/s "
            f"(download + ec.decode), decode launches "
            f"{launches['decode']}; peak RSS through the reads and the "
            f"recall {peak_f}; the cold bucket holds no object of "
            f"volume {vid}, no .rsm left; GET all {st['n']} needles from "
            f"the plain volume on {locs}: {st['rate']:.1f} reads/s "
            f"({TIER_THREADS} threads), all equal")

        # 12g. the .dat to the cold tier and back (operator verbs)
        cluster.master.tiering.stop()
        rss.mark("12g")
        repl.run_command(env, "lock")
        t0 = time.perf_counter()
        up = repl.run_command(env, f"volume.tier.upload -volumeId={vid}")
        t_up = time.perf_counter() - t0
        key = up[0]["key"]
        head = bucket.head_object(key)
        dat_size = up[0]["file_size"]
        if head is None or head.size != dat_size:
            fail(f"volume.tier.upload: {up}, the object {head}")
        sample = [fids[i] for i in rng.choice(
            len(fids), min(TIER_SAMPLE, len(fids)), replace=False)]
        st = _get_pass(sample, lambda f: locs[0], live, "12g")
        t0 = time.perf_counter()
        down = repl.run_command(env, f"volume.tier.download -volumeId={vid}")
        t_down = time.perf_counter() - t0
        if bucket.head_object(key) is not None:
            fail(f"the object {key} is still in {TIER_BUCKET!r}")
        peak_g = rss.peak("12g")
        st2 = _get_pass(fids, lambda f: locs[0], live, "12g",
                        threads=TIER_THREADS)
        repl.run_command(env, "unlock")
        log(f"[12g] (the controller stopped first: it would seal the "
            f"hot volume after {TIER_IDLE} idle s) volume.tier.upload "
            f"of the {dat_size} B .dat to s3.default: {t_up:.3f} s, "
            f"{dat_size / t_up / 1e6:.1f} MB/s, key {key!r}; GET "
            f"{st['n']} needles through ranged GETs: {st['rate']:.1f} "
            f"reads/s, {st['lat']}; volume.tier.download {t_down:.3f} s, "
            f"{dat_size / t_down / 1e6:.1f} MB/s ({down}); peak RSS "
            f"through the upload and download {peak_g}; the object "
            f"gone, all {st2['n']} needles equal")

        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        log(f"[12h] current device before phase 12: {cur}, after: "
            f"{now_dev}")
        if now_dev != cur:
            fail(f"phase 12 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[12] phase 12 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches}; {card}")
        return launches
    finally:
        rss.stop()
        if env is not None:
            env.close()
        for c in (cluster, cold):
            if c is not None:
                c.stop()
        shutil.rmtree(tmp, ignore_errors=True)


CHAOS_SPEC = ("volume:*:error=0.05,filer:*:error=0.05,"
              "volume:*:delay=30ms,filer:*:delay=30ms")
CHAOS_SEED = 20240817            # tests/test_chaos_deterministic.py
CHAOS_ATTEMPTS = 5               # its retry budget
CHAOS_CYCLES = 200               # its S3 PUT/GET cycles
CHAOS_READS = 512                # needle reads, before and under faults
CHAOS_SCRAPE = 0.5               # -master.scrapeInterval
REBUILD_CHUNK = 4 << 20          # ec/rebuild_partial's default chunk


class _KernelEvents:
    """CUDA events around each launch of the kernel while active: the
    wrapper stands in for codec_cuda.coded_matmul (the launch counts
    stay on the function the kernel's own code increments), and
    `ms()` is the sum of the launches' device times."""

    def __init__(self):
        self.pairs: list = []

    def __enter__(self):
        from seaweedfs_tpu_torch.ops import codec_cuda

        orig = codec_cuda.coded_matmul
        pairs = self.pairs

        def timed(tables, x, m, out=None):
            if x.device.type != "cuda":
                return orig(tables, x, m, out=out)
            stream = torch.cuda.current_stream(x.device)
            s, e = (torch.cuda.Event(enable_timing=True) for _ in "se")
            s.record(stream)
            r = orig(tables, x, m, out=out)
            e.record(stream)
            pairs.append((s, e))
            return r

        timed.launches = orig.launches
        timed.launches_by_device = orig.launches_by_device
        self._orig, self._timed = orig, timed
        codec_cuda.coded_matmul = timed
        return self

    def __exit__(self, *exc):
        from seaweedfs_tpu_torch.ops import codec_cuda

        codec_cuda.coded_matmul = self._orig
        self._orig.launches = self._timed.launches
        self._orig.launches_by_device = self._timed.launches_by_device
        return False

    def ms(self) -> float:
        if not self.pairs:
            return 0.0
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.pairs)


def _s3_cycles(s3, bucket: str, label: str) -> dict:
    """The reference chaos test's cycles: PUT then GET of object i
    (100 + i bytes), each equal, ETag = md5. -> wall, latencies."""
    lat = []
    t0 = time.perf_counter()
    for i in range(CHAOS_CYCLES):
        body = (f"chaos-{i}-".encode() * 8)[:100 + i]
        key = f"/{bucket}/obj-{i:03d}"
        r0 = time.perf_counter()
        p = s3("PUT", key, data=body)
        if p.status_code != 200 or \
                p.headers.get("ETag", "").strip('"') != \
                hashlib.md5(body).hexdigest():
            fail(f"{label}: PUT {key}: {p.status_code} "
                 f"{p.headers.get('ETag')} {p.text[:200]}")
        g = s3("GET", key)
        if g.status_code != 200 or g.content != body or \
                g.headers.get("ETag", "").strip('"') != \
                hashlib.md5(body).hexdigest():
            fail(f"{label}: GET {key}: {g.status_code}, other bytes or "
                 f"ETag")
        lat.append(time.perf_counter() - r0)
    wall = time.perf_counter() - t0
    r = s3("GET", f"/{bucket}?list-type=2&max-keys=1000")
    keys = [seg.split("</Key>")[0] for seg in r.text.split("<Key>")[1:]]
    if r.status_code != 200 or \
            keys != [f"obj-{i:03d}" for i in range(CHAOS_CYCLES)]:
        fail(f"{label}: the listing of {bucket} is not exactly the "
             f"{CHAOS_CYCLES} keys: {r.status_code} {keys[:5]}...")
    return {"wall": wall, "rate": CHAOS_CYCLES / wall, "lat": _lat(lat)}


def _needle_records(cluster, env, collection: str) -> int:
    """Needle records appended to the .dat files of `collection`'s
    volumes (each server's copy counted once per volume)."""
    seen = set()
    total = 0
    for vid in _bucket_vids(env, collection):
        for store in cluster.stores:
            v = store.find_volume(vid)
            if v is None or vid in seen:
                continue
            seen.add(vid)
            v.sync()
            total += len(_records(v.file_name() + ".dat", 8,
                                  v.content_size()))
    return total


def _diff_chunks(path: str, ref: str, chunk: int, label: str) -> None:
    """Log which `chunk`-sized pieces of `path` differ from `ref`."""
    bad = []
    with open(path, "rb") as a, open(ref, "rb") as b:
        i = 0
        while True:
            x, y = a.read(chunk), b.read(chunk)
            if not x and not y:
                break
            if x != y:
                n = min(len(x), len(y))
                diff = np.flatnonzero(np.frombuffer(x[:n], np.uint8) !=
                                      np.frombuffer(y[:n], np.uint8))
                bad.append((i, len(x), len(y), int(diff.size),
                            int(diff[0]) if diff.size else -1))
            i += 1
    log(f"{label}: {os.path.getsize(path)} B vs {os.path.getsize(ref)} B;"
        f" differing chunks of {chunk} B (index, sizes, bytes differing,"
        f" first offset): {bad[:20]} of {len(bad)}")


def _find_trace(master_url: str, want: set[str]) -> dict | None:
    """The newest stitched trace whose span names hold every name in
    `want`, from the master's /cluster/traces. Fatal: a trace of the
    master and the volume servers that reached the collector's
    per-trace guard (the spans past it were dropped)."""
    from seaweedfs_tpu_torch.master.collector import MAX_SPANS_PER_TRACE

    body = _get_json(f"{master_url}/cluster/traces", timeout=30.0,
                     limit=4096) or {}
    for summary in body.get("traces", []):
        services = set(summary["services"])
        if summary["spans"] < len(want) or "s3" in services or \
                not {"master", "volume"} <= services:
            continue
        tree = _get_json(f"{master_url}/cluster/traces", timeout=30.0,
                         trace_id=summary["trace_id"])
        flat = []
        todo = list((tree or {}).get("tree", []))
        while todo:
            s = todo.pop()
            flat.append(s)
            todo += s.get("children", [])
        if summary["spans"] >= MAX_SPANS_PER_TRACE:
            names = collections.Counter(s["name"] for s in flat)
            fail(f"trace {summary['trace_id']} reached the collector's "
                 f"{MAX_SPANS_PER_TRACE}-span guard (spans past it "
                 f"dropped): {summary['spans']} spans, "
                 f"{dict(names.most_common(8))}")
        if want <= {s["name"] for s in flat}:
            return {"summary": summary, "tree": tree, "flat": flat}
    return None


def phase_chaos(card: str) -> dict:
    """Phase 13: the robustness and observability layer at 1 GiB. The
    master is a process of the port's CLI with the reference's chaos
    spec; five volume servers, a sqlite filer and the S3 gateway run
    here with one span pusher. A fault-free baseline, then under
    seeded faults the controller's seal and a watchdog rebuild through
    the kernel, a dead peer's breaker, S3 cycles, and both operations'
    traces stitched across the two processes. -> kernel launches of the
    seal and the rebuild."""
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.http import ServerThread
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.rpc.trace_push import SpanPusher
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.server.volume_server import VolumeServer
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.storage.store import Store
    from seaweedfs_tpu_torch.utils import faults, retry, tracing

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke13-")
    col = "smoke13"
    (port,) = free_ports(1)
    master = f"http://127.0.0.1:{port}"
    mlog = os.path.join(tmp, "master.log")
    proc = cluster = pusher = None
    launches: dict[str, int] = {}
    tracing.configure(sample_rate=1.0)
    try:
        proc = _spawn(["-fault.spec", CHAOS_SPEC, "-fault.seed",
                       str(CHAOS_SEED), "-trace.sample", "1",
                       "-retry.maxAttempts", str(CHAOS_ATTEMPTS),
                       "master", "-ip", "127.0.0.1", "-port", str(port),
                       "-pulseSeconds", str(HEAL_PULSE),
                       "-volumeSizeLimitMB", str(max(1, DAT_BYTES >> 20)),
                       "-repair.enabled", "-repair.interval",
                       str(HEAL_INTERVAL), "-repair.grace", "0",
                       "-tier.enabled", "-tier.interval",
                       str(TIER_INTERVAL),
                       "-master.scrapeInterval", str(CHAOS_SCRAPE)], mlog)
        _poll(lambda: _get_json(f"{master}/cluster/status"), 60.0,
              f"the master process at {master} answering")
        cluster = Cluster(os.path.join(tmp, "main"),
                          n_volume_servers=len(HEAL_TOPOLOGY),
                          max_volumes=8, pulse_seconds=HEAL_PULSE,
                          ec_backend="cuda", topology=HEAL_TOPOLOGY,
                          with_filer=True, filer_store="sqlite",
                          with_s3=True, s3_config=S3_CONFIG,
                          external_masters=[master])
        # one pusher for this process's servers, as the CLI starts one
        # per server process
        pusher = SpanPusher(master, "cluster",
                            cluster.volume_threads[0].address)
        pusher.start()
        env = CommandEnv(master, filer_url=cluster.filer_url)
        s3 = _S3Client(cluster.s3_url)
        by_url = {f"{s.ip}:{s.port}": i
                  for i, s in enumerate(cluster.stores)}
        log(f"[13] {card}")
        log(f"[13] master {master}: a process of `python -m "
            f"seaweedfs_tpu_torch -fault.spec {CHAOS_SPEC} -fault.seed "
            f"{CHAOS_SEED} -trace.sample 1 -retry.maxAttempts "
            f"{CHAOS_ATTEMPTS} master -pulseSeconds {HEAL_PULSE} "
            f"-repair.enabled -repair.grace 0 -tier.enabled "
            f"-master.scrapeInterval {CHAOS_SCRAPE}`; here: volume servers "
            f"{[(th.address, *HEAL_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f" on 'cuda', sqlite filer {cluster.filer_url}, s3 "
            f"{cluster.s3_url}, one span pusher to the master")

        # 13a. the fault-free baseline
        w = _fill_volume_http(cluster, env, col, SEED + 13, DAT_BYTES)
        vid, live = w["vid"], w["live"]
        rng = np.random.default_rng(SEED + 13)
        fids = sorted(live)
        sample = [fids[i] for i in rng.choice(
            len(fids), min(CHAOS_READS, len(fids)), replace=False)]
        base_reads = _get_pass(sample, lambda f: w["url"], live, "13a")
        if s3("PUT", "/chaos-base").status_code != 200 or \
                s3("PUT", "/chaos").status_code != 200:
            fail("CreateBucket chaos-base / chaos failed")
        base_s3 = _s3_cycles(s3, "chaos-base", "13a")
        log(f"[13a] no faults: volume {vid} filled over HTTP "
            f"({w['writes']} uploads, {w['seconds']:.3f} s); "
            f"{base_reads['n']} reads {base_reads['rate']:.1f} reads/s "
            f"{base_reads['lat']}; {CHAOS_CYCLES} S3 PUT/GET cycles "
            f"{base_s3['rate']:.1f} cycles/s {base_s3['lat']}")
        # the fault-free encode to hold the seal against
        w["vol"].sync()
        ref_base = os.path.join(tmp, "ref", "ref")
        os.makedirs(os.path.dirname(ref_base))
        shutil.copyfile(w["vol"].file_name() + ".dat", ref_base + ".dat")
        encoder.write_ec_files(ref_base, backend="native")
        ref_hashes = {sid: sha256(f"{ref_base}.ec{sid:02d}")
                      for sid in range(14)}

        # 13b. faults on, here and (from its flags) in the master
        faults.configure(CHAOS_SPEC, seed=CHAOS_SEED)
        retry.configure(max_attempts=CHAOS_ATTEMPTS)

        # 13c. the tiering controller's seal, under faults
        codec_cuda.coded_matmul.launches = 0
        rep0 = env.master_get("/debug/repair")["recent"]
        t0 = time.time()
        with _KernelEvents() as seal_ev:
            r = env.master_request("POST", "/debug/tiering", json={
                "volume": vid, "transition": "seal"}, timeout=30)
            if r.status_code != 200 or not r.json().get("accepted"):
                fail(f"POST /debug/tiering seal: {r.status_code} {r.text}")
            seal = _poll(lambda: _tier_results(env, vid, "seal"),
                         TIER_DEADLINE, "the controller's seal")[0]
        launches["seal"] = codec_cuda.coded_matmul.launches
        until = time.time()
        paths = _live_shard_files(cluster, env, vid)
        if sorted(paths) != list(range(14)):
            fail(f"shards {sorted(paths)} after the seal")
        orig = {sid: sha256(p) for sid, p in paths.items()}
        if orig != ref_hashes:
            fail(f"sealed shards {[s for s in orig if orig[s] != ref_hashes[s]]}"
                 f" differ from a fault-free encode of the same .dat")
        shard_size = os.path.getsize(paths[0])
        window = [x for x in env.master_get("/debug/repair")["recent"]
                  if x not in rep0 and t0 <= x["finished_at"] <= until]
        # attempts the admin lock refused touch nothing
        rebuilt = [x for x in window if x["ok"] or
                   "cannot acquire admin lock" not in x["error"]]
        want_seal = _encode_launches(os.path.getsize(ref_base + ".dat"))
        log(f"[13c] under faults: the controller's seal (ec.encode) "
            f"{seal['seconds']} s in {seal['attempts']} attempt(s); "
            f"kernel launches {launches['seal']} (events "
            f"{seal_ev.ms():.3f} ms in all); repairs during it "
            f"{len(rebuilt)} (attempts the lock refused: "
            f"{len(window) - len(rebuilt)}); 14 shards of {shard_size} B "
            f"sha256-equal to the fault-free native encode")
        if launches["seal"] != want_seal or seal["attempts"] != 1:
            fail(f"the seal made {launches['seal']} launches in "
                 f"{seal['attempts']} attempts, not {want_seal} in one")
        if rebuilt:
            fail(f"the watchdog repaired during the seal: {rebuilt}")

        # 13d. lose the holder with the fewest shards, under faults
        locs = env.ec_shard_locations(vid)
        held: dict[str, list[int]] = {u: [] for u in by_url}
        for sid, urls in locs.items():
            for u in urls:
                held[u].append(sid)
        victim = min((u for u in held if held[u]),
                     key=lambda u: (len(held[u]), u))
        lost = sorted(held[victim])
        reader = next(u for u in held if held[u] and u != victim)
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_kill = time.monotonic()
        vi = by_url[victim]
        cluster.volume_threads[vi].stop()
        degraded = {}

        def read_degraded():
            degraded.update(_get_pass(sample, lambda f: reader, live,
                                      "13e degraded", threads=TIER_THREADS))
        reads_thread = threading.Thread(target=read_degraded, daemon=True)
        with _KernelEvents() as rebuild_ev:
            reads_thread.start()
            # the master's federation scrape (every CHAOS_SCRAPE s)
            # trips its breaker for the dead peer while it is still
            # registered (5 pulses)
            seen = {}

            def breaker_open():
                st = _get_json(f"{master}/dir/status") or {}
                nodes = [n for dc in st.get("Topology", {}).get(
                    "datacenters", []) for rk in dc["racks"]
                    for n in rk["nodes"] if n["url"] == victim]
                if nodes and nodes[0].get("breaker") == retry.OPEN:
                    seen.setdefault("topology", time.monotonic() - t_kill)
                brs = (_get_json(f"{master}/debug/breakers") or {}).get(
                    "breakers", [])
                if any(b["peer"] == victim and b["state"] == retry.OPEN
                       for b in brs):
                    seen.setdefault("debug", time.monotonic() - t_kill)
                if not nodes and "topology" not in seen:
                    fail(f"{victim} unregistered before the master's "
                         f"breaker read open in its topology dump")
                return len(seen) == 2
            _poll(breaker_open, HEAL_DEADLINE,
                  f"the master's breaker for {victim} open", step=0.02)

            def deficit():
                st = env.master_get("/cluster/status")
                return any(e["volume"] == vid for e in st["UnderParity"])
            _poll(deficit, HEAL_DEADLINE, f"volume {vid} in UnderParity")
            t_seen = time.monotonic()
            _poll(lambda: not env.master_get("/cluster/status")[
                "UnderParity"] and len(env.ec_shard_locations(vid)) == 14,
                HEAL_DEADLINE, f"volume {vid} back to 14 shards")
            t_done = time.monotonic()

            def repaired():
                recent = [x for x in env.master_get("/debug/repair")[
                    "recent"] if x["finished_at"] >= since]
                bad = [x for x in recent if not x["ok"] and
                       "cannot acquire admin lock" not in x["error"]]
                if bad:
                    fail(f"a repair failed under faults (no retry around "
                         f"the kernel): {bad[0]}")
                return [x for x in recent if x["ok"] and
                        x["volume"] == vid and x["kind"] == "ec"]
            rec = _poll(repaired, HEAL_DEADLINE,
                        "the watchdog's EC repair result")[0]
            reads_thread.join(timeout=HEAL_DEADLINE)
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        want_rebuild = -(-shard_size // REBUILD_CHUNK)
        if rec["reason"] != "watchdog" or \
                sorted(rec["detail"].get("rebuilt", [])) != lost:
            fail(f"the watchdog's repair was not the rebuild of {lost}: "
                 f"{rec}")
        if launches["rebuild"] != want_rebuild:
            fail(f"the rebuild made {launches['rebuild']} launches, not "
                 f"{want_rebuild}")
        locs = env.ec_shard_locations(vid)
        if len(locs) != 14:
            fail(f"{len(locs)} live shards after the rebuild")
        for sid in lost:
            store = cluster.stores[by_url[locs[sid][0]]]
            path = store.ec_volumes[vid].shards[sid].path
            if sha256(path) != orig[sid]:
                _diff_chunks(path, f"{ref_base}.ec{sid:02d}",
                             REBUILD_CHUNK, f"rebuilt shard {sid}")
                fail(f"rebuilt shard {sid} differs from the original")
        if reads_thread.is_alive() or not degraded:
            fail("the degraded reads did not finish")
        here = {b["peer"]: b for b in session().get(
            f"{cluster.volume_url(0 if vi else 1)}/debug/breakers",
            timeout=10).json()["breakers"]}
        log(f"[13d] stopped {victim} (shards {lost}): the master's "
            f"breaker read open in its topology dump "
            f"{seen['topology']:.3f} s and at /debug/breakers "
            f"{seen['debug']:.3f} s after the stop; this process's "
            f"breaker {here.get(victim, {}).get('state')!r} (trips "
            f"{here.get(victim, {}).get('trips')}); detection "
            f"{t_seen - t_kill:.3f} s, repair {t_done - t_seen:.3f} s; "
            f"the watchdog's rebuild {rec['seconds']} s (attempt "
            f"{rec['attempts']}), {rec['detail'].get('mode')!r} "
            f"on {rec['detail'].get('rebuilder')}; kernel launches "
            f"{launches['rebuild']} (events {rebuild_ev.ms():.3f} ms in "
            f"all); 14 live shards, rebuilt ones sha256-equal")
        # the stopped server comes back at its address (an empty disk):
        # its registration resets the master's breaker
        old = cluster.volume_servers[vi]
        fresh = os.path.join(tmp, "main", f"vol{vi}_back")
        os.makedirs(fresh)
        vport = int(victim.rsplit(":", 1)[1])
        store = Store([fresh], ip="127.0.0.1", port=vport,
                      ec_backend="cuda")
        for loc in store.locations:
            loc.max_volumes = 8
        vs = VolumeServer(store, master, data_center=old.data_center,
                          rack=old.rack, pulse_seconds=HEAL_PULSE)
        th = ServerThread(vs.app, port=vport).start()
        store.public_url = th.address
        cluster.volume_servers[vi] = vs
        cluster.volume_threads[vi] = th
        cluster.stores[vi] = store

        def reset():
            st = _get_json(f"{master}/dir/status") or {}
            nodes = [n for dc in st.get("Topology", {}).get(
                "datacenters", []) for rk in dc["racks"]
                for n in rk["nodes"] if n["url"] == victim]
            brs = (_get_json(f"{master}/debug/breakers") or {}).get(
                "breakers", [])
            return nodes and nodes[0]["breaker"] == retry.CLOSED and \
                not any(b["peer"] == victim and b["state"] != retry.CLOSED
                        for b in brs)
        _poll(reset, HEAL_DEADLINE, f"{victim} re-registered, its breaker "
              "reset")
        log(f"[13d] {victim} restarted and re-registered: the master's "
            f"breaker for it reads closed in the topology dump and "
            f"/debug/breakers")

        # 13e. S3 cycles and the degraded reads, under faults; this
        # process's breaker for the restarted peer (opened by the reads
        # that met it dead) first lets its half-open probe through
        _poll(lambda: retry.breaker_for(victim).state != retry.OPEN,
              HEAL_DEADLINE, f"this process's breaker for {victim} past "
              "open")
        chaos_s3 = _s3_cycles(s3, "chaos", "13e")
        records = _needle_records(cluster, env, "chaos")
        if records != CHAOS_CYCLES:
            fail(f"{records} needles in the chaos bucket's volumes for "
                 f"{CHAOS_CYCLES} PUTs: duplicate or lost writes")
        log(f"[13e] under faults: {CHAOS_CYCLES} S3 PUT/GET cycles "
            f"{chaos_s3['rate']:.1f} cycles/s {chaos_s3['lat']}, every "
            f"object md5- and ETag-equal, the listing exact, "
            f"{records} needles for {CHAOS_CYCLES} PUTs; "
            f"{degraded['n']} degraded reads from {reader} on "
            f"{TIER_THREADS} threads while the peer was down (through the "
            f"CPU codec) {degraded['rate']:.1f} reads/s {degraded['lat']}"
            f", all equal")

        # 13f. both operations' traces, stitched across two processes
        found = {}
        for name, want in (("seal", {"tier seal", "handle_ec_generate",
                                     "ec.write_ec_files"}),
                           ("rebuild", {"repair ec",
                                        "handle_ec_rebuild_partial"})):
            found[name] = _poll(lambda: _find_trace(master, want), 30.0,
                                f"the {name}'s trace at /cluster/traces",
                                step=0.5)
        for name, tr in found.items():
            flat = tr["flat"]
            ids = [s["span_id"] for s in flat]
            insts = {s.get("instance") for s in flat}
            if len(ids) != len(set(ids)):
                fail(f"the {name}'s trace holds a span_id twice")
            if len(insts) < 2:
                fail(f"the {name}'s trace spans {insts}, one process")
            otlp = _get_json(f"{master}/cluster/traces", timeout=30.0,
                             trace_id=tr["summary"]["trace_id"],
                             format="otlp")
            n_otlp = sum(len(ss["spans"]) for rs in otlp["resourceSpans"]
                         for ss in rs["scopeSpans"])
            if n_otlp != len(flat) or n_otlp != tr["tree"]["spans"]:
                fail(f"the {name}'s trace: {len(flat)} spans stitched, "
                     f"{n_otlp} in OTLP")
            tr["n"] = len(flat)
            tr["insts"] = sorted(insts)
        rebuild_flat = found["rebuild"]["flat"]
        client = [s for s in rebuild_flat if s["kind"] == "client" and
                  s["name"].startswith("POST ") and
                  any(c["name"] == "handle_ec_rebuild_partial"
                      for c in s.get("children", []))]
        if not client:
            fail("the rebuild's trace has no client span of the master's "
                 "watchdog over the rebuilder's server span")
        obs = env.master_get("/cluster/status")["Observability"]
        dropped = {i: p["SpansDropped"] for i, p in obs["Pushers"].items()}
        if any(dropped.values()):
            fail(f"spans dropped on the way to the collector: {dropped}")
        counts = faults.counts()
        if counts.get("volume:error", 0) <= 0 or \
                counts.get("filer:error", 0) <= 0:
            fail(f"the faults did not fire on both hop classes: {counts}")
        trips = sum(b["trips"] for b in session().get(
            f"{cluster.volume_url(0)}/debug/breakers",
            timeout=10).json()["breakers"])

        def walls(name, root):
            tr = found[name]["flat"]
            top = next(s for s in tr if s["name"] == root)
            srv = next(s for s in tr if s["name"] ==
                       ("handle_ec_generate" if name == "seal" else
                        "handle_ec_rebuild_partial"))
            return (f"{name}: root span {top['duration']:.3f} s, the volume "
                    f"server's span {srv['duration']:.3f} s, spans "
                    f"{found[name]['n']} over {found[name]['insts']} "
                    f"(sum of their durations "
                    f"{sum(s['duration'] for s in tr):.3f} s)")
        log(f"[13f] /cluster/traces: {walls('seal', 'tier seal')}; "
            f"{walls('rebuild', 'repair ec')}; no span_id twice, OTLP span "
            f"counts equal; pushers {obs['Pushers']} (SpansDropped 0); "
            f"injected here {counts} (each injected 503 one replay); "
            f"breaker trips seen from this process {trips}")

        # 13g. the workload aggregator
        wl = _poll(lambda: (lambda b: b["cluster"]["read_size"]["count"]
                            > 0 and b)(env.master_get("/debug/workload")),
                   30.0, "/debug/workload cluster.read_size.count > 0")
        log(f"[13g] /debug/workload: {len(wl['nodes'])} nodes, "
            f"read_size {wl['cluster']['read_size']}")

        # 13h. the master's 1 MiB body cap
        r = session().post(f"{master}/cluster/announce",
                           data=b"{" + b" " * (1 << 20),
                           headers={"Content-Type": "application/json"},
                           timeout=30)
        if r.status_code != 413:
            fail(f"the master answered a 1 MiB + 1 body with "
                 f"{r.status_code}, not 413")
        log(f"[13h] the master answers a 1 MiB + 1 body with 413")
    finally:
        faults.configure(spec=None)
        retry.configure(max_attempts=3)
        if pusher is not None:
            pusher.stop()
        if cluster is not None:
            cluster.stop()
        if proc is not None:
            proc.kill()
            proc.wait(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    if cur is not None and torch.cuda.current_device() != cur:
        fail(f"phase 13 left the current device "
             f"{torch.cuda.current_device()}, not {cur}")
    log(f"[13] done: launches {launches} (the seal's and the rebuild's);"
        f" no faults {base_reads['rate']:.1f} reads/s "
        f"{base_reads['lat']}, {base_s3['rate']:.1f} S3 cycles/s; under "
        f"faults {degraded['rate']:.1f} degraded reads/s "
        f"{degraded['lat']}, {chaos_s3['rate']:.1f} S3 cycles/s; the "
        f"current device unchanged; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


SEC_SECRET = "smoke14-jwt-secret"     # -jwt.secret of the master and volumes
SEC_NEEDLE = 4 << 20                  # 14a's fill: 4 MiB needles
SEC_THREADS = 8                       # client threads of 14a and 14f
SEC_TOPOLOGY = [("dc1", "rA"), ("dc1", "rA"), ("dc1", "rB"),
                ("dc1", "rC")]        # in-process; the victim joins rB
SEC_VICTIM_RACK = "rB"
SEC_PROV = ("SMOKE14PROV", "smoke14-provisioned-secret")
SEC_GREEDY = ("SMOKE14GREEDY", "smoke14-greedy-secret")
SEC_S3_CONFIG = {"identities": [
    {"name": name, "actions": ["Admin"],
     "credentials": [{"accessKey": ak, "secretKey": sk}]}
    for name, (ak, sk) in (("provisioned", SEC_PROV),
                           ("greedy", SEC_GREEDY))]}
SEC_PROV_RATE = 64 << 20              # bytes/s provisioned per tenant
SEC_GREEDY_RATE = 1 << 20
SEC_MAX_DELAY = 0.5                   # -qos.maxDelay
SEC_BURST_SECONDS = 5.0               # the greedy tenant's 10x burst
SEC_BURST_OBJECT = 64 << 10
# the burst's client threads: each admitted request is paced up to
# -qos.maxDelay on the server, so the offered load only stays at 10x
# (open loop) with more requests in flight than maxDelay x rate / object
SEC_BURST_THREADS = 32
SEC_PROV_OBJECT = 16 << 10
# the five servers' -commit.maxBytes / -commit.maxDelay: at the defaults
# (4 MiB, 2 ms) a 4 MiB needle closes its own batch, so the fill would
# coalesce nothing; this window holds up to 16 of them, and stays open
# longer than the gap between the 8 writers' uploads
SEC_COMMIT_MAX_BYTES = 64 << 20
SEC_COMMIT_MAX_DELAY = 0.05
SEC_KILL_AFTER = (1.0, 3.0)           # seeded seconds of 14f's writes
SEC_VICTIM_SIZES = (64 << 10, 1 << 20)


def _plain_cuda_codec():
    """The kernel's plain version (codec_cuda.coded_matmul_plain) in
    CudaCodec's feed, on the card, with CUDA events around each call:
    the reference encode 14e holds the seal's shards against."""
    from seaweedfs_tpu_torch.ops import codec_cuda

    class Plain(codec_cuda.CudaCodec):
        name = "cuda-plain"

        def __init__(self):
            # the card; the CPU only in a rehearsal without one
            super().__init__(device="cuda" if torch.cuda.is_available()
                             else "cpu")
            self.pairs = []

        def _kernel(self, mats, x, out=None):
            tables, m = mats
            timed = x.device.type == "cuda"
            if timed:
                stream = torch.cuda.current_stream(x.device)
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in "se")
                s.record(stream)
            r = codec_cuda.coded_matmul_plain(tables, x, m)
            if out is not None:
                r = out.copy_(r)
            if timed:
                e.record(stream)
                self.pairs.append((s, e))
            return r

        def ms(self) -> float:
            if not self.pairs:
                return 0.0
            torch.cuda.synchronize()
            return sum(s.elapsed_time(e) for s, e in self.pairs)

    return Plain()


class _BatchAckWatch:
    """Ties each batch ack of an in-process volume server to a finished
    fsync. It wraps the server's CommitScheduler: every ticket a write
    handler waits on is checked, when its wait returns (just before the
    201), against the durable commits of its volume that began after the
    ticket was enqueued, after the append, and ended before the ack.
    `uncovered` counts acks with no such commit; `close` unwraps."""

    def __init__(self, sched):
        self.sched = sched
        self.lock = threading.Lock()
        self.commits: dict[int, list[tuple[float, float]]] = {}
        self.acks = self.uncovered = 0
        submit, commit_volume = sched.submit, sched._commit_volume
        watch = self

        def timed_commit(v, durable: bool) -> None:
            t0 = time.monotonic()
            commit_volume(v, durable)
            if durable:
                with watch.lock:
                    watch.commits.setdefault(id(v), []).append(
                        (t0, time.monotonic()))

        class Ticket:
            def __init__(self, t):
                self._t = t

            def __getattr__(self, name):
                return getattr(self._t, name)

            def wait(self, timeout=None) -> bool:
                done = self._t.wait(timeout)
                if done:
                    now, t = time.monotonic(), self._t
                    with watch.lock:
                        watch.acks += 1
                        if not any(s >= t.enqueued_at and e <= now
                                   for s, e in watch.commits.get(
                                       id(t.volume), ())):
                            watch.uncovered += 1
                return done

        sched.submit = lambda v, nbytes: Ticket(submit(v, nbytes))
        sched._commit_volume = timed_commit

    def close(self) -> None:
        del self.sched.submit, self.sched._commit_volume


def _signed_https(host: str, port: int, ctx, key: tuple[str, str],
                  method: str, path: str, body: bytes = b"",
                  chunked: bool = False, conn=None):
    """One SigV4-signed request over `conn` (an HTTPSConnection the
    caller keeps alive) or a connection of its own, with no retry (the
    qos accounting counts every attempt): -> (status, headers, body)."""
    import http.client

    from seaweedfs_tpu_torch.s3.auth import sign_request

    hdrs = sign_request(method, f"https://{host}:{port}{path}", key[0],
                        key[1], payload=body)
    own = conn is None
    if own:
        conn = http.client.HTTPSConnection(host, port, context=ctx,
                                           timeout=60)
    try:
        if chunked:
            conn.request(method, path, body=iter([body]), headers=hdrs,
                         encode_chunked=True)
        else:
            conn.request(method, path, body=body if body or method in (
                "PUT", "POST") else None, headers=hdrs)
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        if own:
            conn.close()


def phase_secure(card: str) -> dict:
    """Phase 14: the secured, durable write path at 1 GiB. The master
    is a process of the port's CLI on HTTPS with -jwt.secret; four
    volume servers at -commit.durability=batch, a sqlite filer (plain:
    the watchdog's DLM lock reaches it over http://, as the reference's
    does) and the S3 gateway on HTTPS with per-tenant qos run here; the
    fifth volume server is a process, SIGKILLed mid-write. -> kernel
    launches of the seal and the rebuild."""
    import signal
    import socket
    import ssl

    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.rpc.http import ServerThread
    from seaweedfs_tpu_torch.rpc.httpclient import (RequestException,
                                                    session)
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.server.master_follower import MasterFollower
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.ec import encoder
    from seaweedfs_tpu_torch.utils import metrics, qos, tls
    from seaweedfs_tpu_torch.utils.security import sign_jwt

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke14-")
    saved_env = {k: os.environ.get(k)
                 for k in ("SSL_CERT_FILE", "REQUESTS_CA_BUNDLE")}
    proc = victim = cluster = follower = None
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    try:
        t0 = time.perf_counter()
        certs = tls.generate_self_signed(os.path.join(tmp, "certs"))
        ca = certs["ca_cert"]
        # this process and the ones it starts trust the CA
        os.environ["SSL_CERT_FILE"] = os.environ["REQUESTS_CA_BUNDLE"] = ca
        ctx = tls.server_ssl_context(certs["cert"], certs["key"])
        sec = os.path.join(tmp, "security.json")
        with open(sec, "w") as f:
            json.dump({"https": {"cert": certs["cert"],
                                 "key": certs["key"]}}, f)
        spec = os.path.join(tmp, "qos.json")
        with open(spec, "w") as f:
            json.dump({"default": {"rate": 0}, "tenants": {
                SEC_PROV[0]: {"rate": SEC_PROV_RATE},
                SEC_GREEDY[0]: {"rate": SEC_GREEDY_RATE}}}, f)
        walls["certs"] = time.perf_counter() - t0
        mport, vport = free_ports(2)
        master = f"https://127.0.0.1:{mport}"
        mlog = os.path.join(tmp, "master.log")
        vlog = os.path.join(tmp, "victim.log")
        proc = _spawn(["-security", sec, "master", "-ip", "127.0.0.1",
                       "-port", str(mport), "-jwt.secret", SEC_SECRET,
                       "-pulseSeconds", str(HEAL_PULSE),
                       "-volumeSizeLimitMB", str((DAT_BYTES >> 20) + 64),
                       "-repair.enabled", "-repair.interval",
                       str(HEAL_INTERVAL), "-repair.grace", "0",
                       "-tier.enabled", "-tier.interval",
                       str(TIER_INTERVAL)], mlog)
        _poll(lambda: _get_json(f"{master}/cluster/status"), 60.0,
              f"the master process at {master} answering over HTTPS")
        cluster = Cluster(os.path.join(tmp, "main"),
                          n_volume_servers=len(SEC_TOPOLOGY),
                          max_volumes=8, pulse_seconds=HEAL_PULSE,
                          ec_backend="cuda", topology=SEC_TOPOLOGY,
                          with_filer=True, filer_store="sqlite",
                          with_s3=True, s3_config=SEC_S3_CONFIG,
                          external_masters=[master],
                          jwt_secret=SEC_SECRET,
                          commit_durability="batch",
                          commit_max_delay=SEC_COMMIT_MAX_DELAY,
                          commit_max_bytes=SEC_COMMIT_MAX_BYTES,
                          tls={"s3": ctx},
                          qos={"enabled": True,
                               "max_delay": SEC_MAX_DELAY, "spec": spec})
        cluster.s3.identity_refresh_seconds = 0.5
        vdir = os.path.join(tmp, "victim")
        os.makedirs(vdir)
        victim_args = ["volume", "-ip", "127.0.0.1", "-port", str(vport),
                       "-dir", vdir, "-max", "8", "-mserver", master,
                       "-dataCenter", "dc1", "-rack", SEC_VICTIM_RACK,
                       "-jwt.secret", SEC_SECRET, "-commit.durability",
                       "batch", "-commit.maxDelay",
                       str(SEC_COMMIT_MAX_DELAY), "-commit.maxBytes",
                       str(SEC_COMMIT_MAX_BYTES), "-ec.backend", "native",
                       # its checks read the Python commit scheduler,
                       # which the native front's own queue bypasses
                       "-dataplane", "python"]
        victim = _spawn(victim_args, vlog)
        env = CommandEnv(master, filer_url=cluster.filer_url)
        victim_url = f"127.0.0.1:{vport}"
        _poll(lambda: len(env.data_nodes()) == len(SEC_TOPOLOGY) + 1,
              60.0, "five volume servers registered at the HTTPS master")
        mf = MasterFollower(master)
        follower = ServerThread(mf.app, ssl_context=ctx).start()
        s3_host, s3_port = "127.0.0.1", cluster.s3_thread.port
        if not cluster.s3_url.startswith("https://"):
            fail(f"the gateway serves {cluster.s3_url}, not HTTPS")
        log(f"[14] {card}")
        log(f"[14] master {master}: a process of `python -m "
            f"seaweedfs_tpu_torch -security {os.path.basename(sec)} "
            f"master -jwt.secret ... -repair.enabled -repair.grace 0 "
            f"-tier.enabled`; here: volume servers "
            f"{[(th.address, *SEC_TOPOLOGY[i]) for i, th in enumerate(cluster.volume_threads)]}"
            f" at -commit.durability=batch -commit.maxDelay "
            f"{SEC_COMMIT_MAX_DELAY} -commit.maxBytes {SEC_COMMIT_MAX_BYTES}"
            f" on 'cuda', sqlite filer "
            f"{cluster.filer_url} (plain), s3 {cluster.s3_url} with qos "
            f"{SEC_PROV[0]} {SEC_PROV_RATE} B/s, {SEC_GREEDY[0]} "
            f"{SEC_GREEDY_RATE} B/s, follower {follower.url}; victim "
            f"{victim_url} (dc1, {SEC_VICTIM_RACK}) a process of `volume "
            f"-commit.durability batch -jwt.secret ...`; certificates "
            f"{walls['certs']:.3f} s")

        # 14a. JWT: 401s on a primary and its replica, then the fill
        grown = env.master_get("/vol/grow", collection="smoke14r",
                               replication="001", count=1,
                               dataNode=cluster.volume_threads[0].address)
        if grown.get("count") != 1:
            fail(f"/vol/grow of smoke14r answered {grown}")
        a = verbs.assign(master, collection="smoke14r", replication="001",
                         count=3)
        other = verbs.assign(master, collection="smoke14r",
                             replication="001")
        if not a.auth:
            fail("the master signed no token for an assign under "
                 "-jwt.secret")
        holders = sorted(x["url"] for x in
                         env.master_get("/dir/lookup",
                                        volumeId=a.fid.split(",")[0])[
                             "locations"])
        replica = next(u for u in holders if u != a.url)
        h, p, sg = a.auth.split(".")
        bad = {"no token": {},
               "tampered": {"Authorization": f"Bearer {h}.{p}.AAAA{sg[4:]}"},
               "expired": {"Authorization":
                           f"Bearer {sign_jwt(SEC_SECRET, a.fid, -5)}"},
               "another fid's": {"Authorization": f"Bearer {other.auth}"}}
        refused = []
        for where in (a.url, replica):
            for name, hdr in bad.items():
                r = session().post(f"http://{where}/{a.fid}",
                                   data=b"refused", headers=hdr, timeout=30)
                refused.append((where, name, r.status_code, r.text))
                if r.status_code != 401:
                    fail(f"a write with {name} token to {where} answered "
                         f"{r.status_code}, not 401: {r.text[:200]}")
        good = {"Authorization": f"Bearer {a.auth}"}
        for fid in (a.fid, f"{a.fid}_1", f"{a.fid}_2"):
            r = session().post(f"http://{a.url}/{fid}", data=b"guarded",
                               headers=good, timeout=30)
            if r.status_code != 201 or \
                    r.headers.get("X-Sw-Durability") != "batch":
                fail(f"the signed write of {fid} answered {r.status_code} "
                     f"{r.headers.get('X-Sw-Durability')}: {r.text[:200]}")
            for where in (a.url, replica):
                g = session().get(f"http://{where}/{fid}", timeout=30)
                if g.status_code != 200 or g.content != b"guarded":
                    fail(f"{fid} from {where}: {g.status_code}")
        log(f"[14a] 401 on the primary {a.url} and the replica {replica} "
            f"for {list(bad)} tokens ({refused[0][3]!r} ...); the signed "
            f"write and the _1, _2 slots under the base fid's token 201 "
            f"X-Sw-Durability: batch, on both copies")

        grown = env.master_get("/vol/grow", collection="smoke14", count=1,
                               dataNode=cluster.volume_threads[0].address)
        if grown.get("count") != 1:
            fail(f"/vol/grow of smoke14 answered {grown}")
        c0 = session().get(f"{cluster.volume_url(0)}/debug/commit",
                           timeout=30).json()
        watch = _BatchAckWatch(cluster.volume_servers[0].commit)
        fill_lock = threading.Lock()
        filled = {"bytes": 0, "n": 0, "lat": [], "vid": None}

        def fill_worker(w: int):
            i = w
            while True:
                with fill_lock:
                    if filled["bytes"] >= DAT_BYTES:
                        return
                    filled["bytes"] += SEC_NEEDLE
                data = np.random.default_rng([SEED, 14, i]).bytes(SEC_NEEDLE)
                r0 = time.perf_counter()
                asg = verbs.assign(master, collection="smoke14")
                r = session().post(
                    f"http://{asg.url}/{asg.fid}", data=data,
                    headers={"Authorization": f"Bearer {asg.auth}"},
                    timeout=(5.0, 120.0))
                dt = time.perf_counter() - r0
                if r.status_code != 201 or \
                        r.headers.get("X-Sw-Durability") != "batch":
                    fail(f"14a: the upload of {asg.fid} answered "
                         f"{r.status_code} {r.headers.get('X-Sw-Durability')}"
                         f": {r.text[:200]}")
                with fill_lock:
                    vid_i = int(asg.fid.split(",")[0])
                    if filled["vid"] not in (None, vid_i):
                        fail(f"14a: assigns left volume {filled['vid']}")
                    filled["vid"] = vid_i
                    filled["n"] += 1
                    filled["lat"].append(dt)
                i += SEC_THREADS
        t0 = time.perf_counter()
        _pool_map(fill_worker, range(SEC_THREADS), threads=SEC_THREADS)
        walls["fill"] = time.perf_counter() - t0
        vid = filled["vid"]
        c1 = session().get(f"{cluster.volume_url(0)}/debug/commit",
                           timeout=30).json()
        watch.close()
        vol = cluster.stores[0].find_volume(vid)
        log(f"[14a] volume {vid} filled to {vol.content_size()} B on "
            f"{cluster.volume_threads[0].address}: {filled['n']} signed "
            f"uploads of {SEC_NEEDLE} B on {SEC_THREADS} threads, "
            f"{walls['fill']:.3f} s, "
            f"{filled['n'] * SEC_NEEDLE / walls['fill'] / 1e6:.1f} MB/s, "
            f"{_lat(filled['lat'])} (assign + upload), every ack 201 "
            f"X-Sw-Durability: batch")

        # 14b. group commit over the fill
        commits = c1["commits"] - c0["commits"]
        fsyncs = c1["fsyncs"] - c0["fsyncs"]
        if commits < filled["n"] or not 0 < fsyncs < commits:
            fail(f"/debug/commit over the fill: {commits} commits, "
                 f"{fsyncs} fsyncs for {filled['n']} acked writes")
        if watch.acks < filled["n"] or watch.uncovered:
            fail(f"14b: {watch.uncovered} of {watch.acks} batch acks came "
                 f"before a durable commit of their volume that began "
                 f"after their append ({filled['n']} writes acked)")
        log(f"[14b] /debug/commit of {cluster.volume_threads[0].address} "
            f"over the fill: {commits} acked writes, {fsyncs} fsyncs in "
            f"{c1['batches'] - c0['batches']} batches: "
            f"{commits / fsyncs:.2f} writes per fsync (batch size "
            f"{c1['batch_size']}); each of its {watch.acks} acks came "
            f"after a durable commit of the volume that began after the "
            f"write's append ({watch.uncovered} before one)")

        # 14c. TLS: S3 cycles over https, refusals, KeepConnected on wss
        prov = _S3Client(cluster.s3_url, *SEC_PROV)
        if prov("PUT", "/secure").status_code != 200:
            fail("CreateBucket secure over https failed")
        tls_s3 = _s3_cycles(prov, "secure", "14c")
        noca = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)   # trusts nothing
        for name, port_ in (("gateway", s3_port), ("master", mport)):
            try:
                with socket.create_connection(("127.0.0.1", port_),
                                              timeout=10) as raw, \
                        noca.wrap_socket(raw, server_hostname="127.0.0.1"):
                    pass
                fail(f"a client without the CA verified the {name}")
            except ssl.SSLCertVerificationError:
                pass
            try:
                r = session().get(f"http://127.0.0.1:{port_}/status",
                                  timeout=5)
                fail(f"plain HTTP to the {name}'s TLS port answered "
                     f"{r.status_code}")
            except RequestException:
                pass
        look = _poll(lambda: (lambda r: r.status_code == 200 and r.json())(
            session().get(f"{follower.url}/dir/lookup", timeout=10,
                          params={"volumeId": vid})), 30.0,
            f"the follower's lookup of volume {vid} over wss")
        if look["locations"][0]["url"] != cluster.volume_threads[0].address:
            fail(f"the follower locates volume {vid} at {look}")
        log(f"[14c] {CHAOS_CYCLES} S3 PUT/GET cycles over https "
            f"{tls_s3['rate']:.1f} cycles/s {tls_s3['lat']}, md5- and "
            f"ETag-equal, listing exact; a client without the CA fails "
            f"verification and plain HTTP fails at the gateway and the "
            f"master; the follower {follower.url} (KeepConnected over "
            f"wss://) locates volume {vid}")

        # 14d. qos: a 10x burst of the greedy tenant beside the
        # provisioned one; then the circuit breaker from the KV
        if prov("PUT", "/tenants").status_code != 200:
            fail("CreateBucket tenants failed")
        cactx = ssl.create_default_context(cafile=ca)
        shed0 = metrics.counter_value("qos_shed_total", {
            "tenant": SEC_GREEDY[0], "reason": "rate"})
        adm0 = metrics.counter_value("qos_admitted_total",
                                     {"tenant": SEC_GREEDY[0]})
        stop = threading.Event()
        prov_out: list = []

        def provisioned():
            j = 0
            while not stop.is_set():
                body = np.random.default_rng([SEED, 140, j]).bytes(
                    SEC_PROV_OBJECT)
                r0 = time.perf_counter()
                r = prov("PUT", f"/tenants/prov-{j:05d}", data=body)
                prov_out.append((j, r.status_code,
                                 time.perf_counter() - r0,
                                 hashlib.md5(body).hexdigest()))
                j += 1

        greedy_out: list = []
        g_lock = threading.Lock()
        per_thread = 10 * SEC_GREEDY_RATE / SEC_BURST_OBJECT / \
            SEC_BURST_THREADS

        def greedy(w: int):
            import http.client

            conn = http.client.HTTPSConnection(s3_host, s3_port,
                                               context=cactx, timeout=60)
            t_end = time.monotonic() + SEC_BURST_SECONDS
            j = w
            nxt = time.monotonic()
            try:
                while time.monotonic() < t_end:
                    body = np.random.default_rng([SEED, 141, j]).bytes(
                        SEC_BURST_OBJECT)
                    st, hd, _ = _signed_https(
                        s3_host, s3_port, cactx, SEC_GREEDY, "PUT",
                        f"/tenants/greedy-{j:05d}", body, conn=conn)
                    with g_lock:
                        greedy_out.append((j, st, hd.get("Retry-After"),
                                           hd.get("X-Sw-Retryable"),
                                           hashlib.md5(body).hexdigest()))
                    j += SEC_BURST_THREADS
                    nxt += 1.0 / per_thread
                    time.sleep(max(0.0, nxt - time.monotonic()))
            finally:
                conn.close()
        pt = threading.Thread(target=provisioned, daemon=True)
        pt.start()
        time.sleep(0.5)          # the provisioned flow is established
        t0 = time.perf_counter()
        _pool_map(greedy, range(SEC_BURST_THREADS),
                  threads=SEC_BURST_THREADS)
        walls["burst"] = time.perf_counter() - t0
        stop.set()
        pt.join(timeout=60)
        shed = [x for x in greedy_out if x[1] == 503]
        acked_g = [x for x in greedy_out if x[1] == 200]
        if len(shed) + len(acked_g) != len(greedy_out):
            fail(f"the greedy burst saw other statuses: "
                 f"{sorted({x[1] for x in greedy_out})}")
        if not shed or any(x[2] is None or x[3] != "1" for x in shed):
            fail(f"{len(shed)} sheds, not every one 503 with Retry-After "
                 f"and X-Sw-Retryable")
        d_shed = metrics.counter_value("qos_shed_total", {
            "tenant": SEC_GREEDY[0], "reason": "rate"}) - shed0
        d_adm = metrics.counter_value(
            "qos_admitted_total", {"tenant": SEC_GREEDY[0]}) - adm0
        if d_shed != len(shed) or d_adm != len(acked_g):
            fail(f"qos_shed_total +{d_shed} / qos_admitted_total +{d_adm} "
                 f"for {len(shed)} 503s / {len(acked_g)} 200s")
        bad_prov = [x for x in prov_out if x[1] != 200]
        if bad_prov or not prov_out:
            fail(f"the provisioned tenant got {bad_prov[:3]}")
        lost = []
        for name, rows in (("prov", [(j, st, md5) for j, st, _, md5
                                     in prov_out]),
                           ("greedy", [(j, st, md5) for j, st, _, _, md5
                                       in acked_g])):
            for j, _st, md5 in rows:
                g = prov("GET", f"/tenants/{name}-{j:05d}")
                if g.status_code != 200 or \
                        hashlib.md5(g.content).hexdigest() != md5:
                    lost.append((name, j, g.status_code))
        if lost:
            fail(f"acked writes lost or changed: {lost[:5]}")
        offered = len(greedy_out) * SEC_BURST_OBJECT / walls["burst"]
        log(f"[14d] the greedy tenant offered {offered / 1e6:.2f} MB/s "
            f"({offered / SEC_GREEDY_RATE:.1f}x its {SEC_GREEDY_RATE} B/s) "
            f"for {walls['burst']:.3f} s: {len(acked_g)} admitted, "
            f"{len(shed)} shed 503 + Retry-After + X-Sw-Retryable "
            f"(qos_shed_total +{d_shed:.0f}); the provisioned tenant "
            f"{len(prov_out)} PUTs all 200, "
            f"{_lat([x[2] for x in prov_out])}; every acked object of "
            f"both read back md5-equal")
        kv = f"{cluster.filer_url}/kv/s3/circuit_breaker"
        r = session().put(kv, data=json.dumps({
            "global": {"writeBytes": 1 << 30},
            "buckets": {"limited": {"writeCount": 0}}}), timeout=30)
        if r.status_code >= 300:
            fail(f"PUT {kv}: {r.status_code}")
        t0 = time.perf_counter()
        _poll(lambda: cluster.s3.circuit_breaker.enabled, 30.0,
              "the gateway loading the breaker's limits from the KV")
        walls["reload"] = time.perf_counter() - t0
        st, _, body = _signed_https(s3_host, s3_port, cactx, SEC_PROV,
                                    "PUT", "/limited", b"")
        st2, _, body2 = _signed_https(s3_host, s3_port, cactx, SEC_PROV,
                                      "PUT", "/tenants/chunked", b"x" * 100,
                                      chunked=True)
        st3, _, _ = _signed_https(s3_host, s3_port, cactx, SEC_PROV,
                                  "DELETE", "/tenants/prov-00000")
        g = prov("GET", "/tenants/prov-00001")
        if st != 503 or b"TooManyRequests" not in body or st2 != 411 or \
                b"MissingContentLength" not in body2 or st3 != 204 or \
                g.status_code != 200:
            fail(f"under the breaker: writeCount 0 PUT {st} {body[:120]}, "
                 f"no-length PUT {st2}, DELETE {st3}, GET {g.status_code}")
        session().put(kv, data=b"{}", timeout=30)
        _poll(lambda: not cluster.s3.circuit_breaker.enabled, 30.0,
              "the gateway dropping the breaker's limits")
        log(f"[14d] the breaker's limits loaded from the filer KV "
            f"{walls['reload']:.3f} s after the PUT: a write to the "
            f"writeCount-0 bucket 503 TooManyRequests, a PUT with no "
            f"length 411 MissingContentLength, a DELETE with none 204, "
            f"reads 200; limits dropped again")

        # 14e. the controller's seal through the kernel
        vol.sync()
        ref_base = os.path.join(tmp, "ref", "ref")
        os.makedirs(os.path.dirname(ref_base))
        shutil.copyfile(vol.file_name() + ".dat", ref_base + ".dat")
        plain = _plain_cuda_codec()
        t0 = time.perf_counter()
        encoder.write_ec_files(ref_base, backend=plain)
        walls["plain encode"] = time.perf_counter() - t0
        ref_hashes = {sid: sha256(f"{ref_base}.ec{sid:02d}")
                      for sid in range(14)}
        codec_cuda.coded_matmul.launches = 0
        rep0 = env.master_get("/debug/repair")["recent"]
        t0 = time.time()
        with _KernelEvents() as seal_ev:
            r = env.master_request("POST", "/debug/tiering", json={
                "volume": vid, "transition": "seal"}, timeout=30)
            if r.status_code != 200 or not r.json().get("accepted"):
                fail(f"POST /debug/tiering seal: {r.status_code} {r.text}")
            seal = _poll(lambda: _tier_results(env, vid, "seal"),
                         TIER_DEADLINE, "the controller's seal")[0]
        launches["seal"] = codec_cuda.coded_matmul.launches
        until = time.time()
        locs = env.ec_shard_locations(vid)
        if sorted(locs) != list(range(14)):
            fail(f"shards {sorted(locs)} after the seal")
        by_url = {f"{s.ip}:{s.port}": s for s in cluster.stores}
        orig = {}
        for sid, urls in locs.items():
            if urls[0] in by_url:
                orig[sid] = sha256(by_url[urls[0]].ec_volumes[vid]
                                   .shards[sid].path)
            else:
                orig[sid] = hashlib.sha256(session().get(
                    f"http://{urls[0]}/admin/ec/shard_read",
                    params={"volume": vid, "shard": sid},
                    timeout=(5.0, 300.0)).content).hexdigest()
        if orig != ref_hashes:
            fail(f"sealed shards "
                 f"{[s for s in orig if orig[s] != ref_hashes[s]]} differ "
                 f"from the plain version's encode of the same .dat")
        shard_size = os.path.getsize(f"{ref_base}.ec00")
        window = [x for x in env.master_get("/debug/repair")["recent"]
                  if x not in rep0 and t0 <= x["finished_at"] <= until]
        rebuilt = [x for x in window if x["ok"] or
                   "cannot acquire admin lock" not in x["error"]]
        want_seal = _encode_launches(os.path.getsize(ref_base + ".dat"))
        if launches["seal"] != want_seal or seal["attempts"] != 1 or \
                rebuilt:
            fail(f"the seal made {launches['seal']} launches in "
                 f"{seal['attempts']} attempts (want {want_seal} in one), "
                 f"repairs during it {rebuilt}")
        held: dict[str, list[int]] = {}
        for sid, urls in locs.items():
            for u in urls:
                held.setdefault(u, []).append(sid)
        lost_sids = sorted(held.get(victim_url, []))
        if not 0 < len(lost_sids) <= 4:
            fail(f"the victim {victim_url} holds shards {lost_sids} of "
                 f"{held}; the phase needs 1 to 4 there (nodes "
                 f"{[(n['url'], n['rack'], n['max_volumes'], len(n.get('volumes', []))) for n in env.data_nodes()]}; the victim's log:\n{_tail(vlog)})")
        log(f"[14e] the controller's seal {seal['seconds']} s in "
            f"{seal['attempts']} attempt; kernel launches "
            f"{launches['seal']} (CUDA events {seal_ev.ms():.3f} ms); 0 "
            f"repairs; 14 shards of {shard_size} B sha256-equal to the "
            f"plain version's encode (CUDA events {plain.ms():.3f} ms, "
            f"{walls['plain encode']:.3f} s); the victim holds {lost_sids}")

        # 14f. SIGKILL of the victim mid-write in batch mode
        grown = env.master_get("/vol/grow", collection="smoke14v",
                               count=1, dataNode=victim_url)
        if grown.get("count") != 1:
            fail(f"/vol/grow of smoke14v on the victim answered {grown}")
        acked: dict[str, str] = {}
        ack_lock = threading.Lock()
        writers_stop = threading.Event()

        def victim_writer(w: int):
            rng = np.random.default_rng([SEED, 142, w])
            lo, hi = np.log(SEC_VICTIM_SIZES[0]), np.log(SEC_VICTIM_SIZES[1])
            while not writers_stop.is_set():
                data = rng.bytes(int(np.exp(rng.uniform(lo, hi))))
                try:
                    asg = verbs.assign(master, collection="smoke14v")
                    if asg.url != victim_url:
                        fail(f"14f: smoke14v assigned on {asg.url}")
                    r = session().post(
                        f"http://{asg.url}/{asg.fid}", data=data,
                        headers={"Authorization": f"Bearer {asg.auth}"},
                        timeout=(5.0, 30.0))
                except (RequestException, RuntimeError):
                    return           # the victim is gone
                if r.status_code == 201:
                    if r.headers.get("X-Sw-Durability") != "batch":
                        fail("14f: an ack without X-Sw-Durability: batch")
                    with ack_lock:
                        acked[asg.fid] = hashlib.sha256(data).hexdigest()
        kill_after = float(np.random.default_rng([SEED, 143]).uniform(
            *SEC_KILL_AFTER))
        wts = [threading.Thread(target=victim_writer, args=(w,),
                                daemon=True) for w in range(SEC_THREADS)]
        for th in wts:
            th.start()
        time.sleep(kill_after)
        vsnap = session().get(f"http://{victim_url}/debug/commit",
                              timeout=10).json()
        with ack_lock:
            acked_at_snap = len(acked)
        codec_cuda.coded_matmul.launches = 0
        since = time.time()
        t_kill = time.monotonic()
        victim.send_signal(signal.SIGKILL)
        victim.wait(timeout=30)
        writers_stop.set()
        for th in wts:
            th.join(timeout=60)
        if vsnap["durability"] != "batch" or \
                not 0 < vsnap["fsyncs"] < vsnap["commits"]:
            fail(f"the victim's /debug/commit before the kill: {vsnap}")
        with _KernelEvents() as rebuild_ev:
            _poll(lambda: any(e["volume"] == vid for e in env.master_get(
                "/cluster/status")["UnderParity"]), HEAL_DEADLINE,
                f"volume {vid} in UnderParity")
            t_seen = time.monotonic()
            _poll(lambda: not env.master_get("/cluster/status")[
                "UnderParity"] and len(env.ec_shard_locations(vid)) == 14
                and victim_url not in {u for us in env.ec_shard_locations(
                    vid).values() for u in us},
                HEAL_DEADLINE, f"volume {vid} back to 14 live shards")
            t_done = time.monotonic()
            def repaired():
                recent = [x for x in env.master_get("/debug/repair")[
                    "recent"] if x["finished_at"] >= since]
                # repairs serialize on the admin lock (ROADMAP Queue 3):
                # a refusal is retried, any other failure is fatal
                bad = [x for x in recent if not x["ok"] and
                       "cannot acquire admin lock" not in x["error"]]
                if bad:
                    fail(f"a repair failed: {bad[0]}")
                return [x for x in recent if x["ok"] and
                        x["volume"] == vid and x["kind"] == "ec"]
            rec = _poll(repaired, HEAL_DEADLINE,
                        "the watchdog's EC repair result")[0]
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        want_rebuild = -(-shard_size // REBUILD_CHUNK)
        if rec["reason"] != "watchdog" or \
                sorted(rec["detail"].get("rebuilt", [])) != lost_sids or \
                launches["rebuild"] != want_rebuild:
            fail(f"the watchdog's repair {rec} with {launches['rebuild']} "
                 f"launches, not the rebuild of {lost_sids} in "
                 f"{want_rebuild}")
        locs = env.ec_shard_locations(vid)
        now = {}
        for sid, urls in locs.items():
            st_ = by_url.get(urls[0])
            if st_ is None:
                fail(f"shard {sid} listed on {urls} after the rebuild")
            now[sid] = sha256(st_.ec_volumes[vid].shards[sid].path)
        if now != orig:
            fail(f"shards {[s for s in now if now[s] != orig.get(s)]} "
                 f"differ from the seal's after the rebuild")
        log(f"[14f] SIGKILL of {victim_url} {kill_after:.3f} s into "
            f"{SEC_THREADS} writers: {len(acked)} writes acked (batch); "
            f"its /debug/commit just before: {vsnap['commits']} writes, "
            f"{vsnap['fsyncs']} fsyncs, "
            f"{vsnap['commits'] / vsnap['fsyncs']:.2f} writes per fsync "
            f"({acked_at_snap} acked by then); detection "
            f"{t_seen - t_kill:.3f} s, repair {t_done - t_seen:.3f} s, the "
            f"watchdog's rebuild of {lost_sids} {rec['seconds']} s "
            f"({rec['detail'].get('mode')!r} on "
            f"{rec['detail'].get('rebuilder')}); kernel launches "
            f"{launches['rebuild']} (CUDA events {rebuild_ev.ms():.3f} ms); "
            f"14 live shards sha256-equal to the seal's")
        t0 = time.perf_counter()
        victim = _spawn(victim_args, vlog)
        _poll(lambda: _get_json(f"http://{victim_url}/status"), 60.0,
              "the victim restarted on its directories")
        walls["restart"] = time.perf_counter() - t0
        vid2 = int(next(iter(acked)).split(",")[0]) if acked else None
        if vid2 is None:
            fail("no write was acked before the kill")
        back = _get_pass(sorted(acked), lambda f: victim_url, acked,
                         "14f read-back after the restart",
                         threads=SEC_THREADS)
        dat = glob.glob(os.path.join(vdir, f"smoke14v_{vid2}.dat"))
        if len(dat) != 1 or os.path.getsize(dat[0]) % 8:
            fail(f"the victim's .dat {dat} does not end on the 8-byte "
                 f"record grid")
        log(f"[14f] the victim restarted on the same directories in "
            f"{walls['restart']:.3f} s: all {back['n']} acked writes read "
            f"back byte-equal ({back['rate']:.1f} reads/s {back['lat']}); "
            f"its .dat {os.path.getsize(dat[0])} B on the 8-byte grid")
        busy = seal_ev.ms() + rebuild_ev.ms() + plain.ms()
        walls["phase"] = time.perf_counter() - t_phase
        log(f"[14g] walls {({k: round(v, 3) for k, v in walls.items()})}; "
            f"launches {launches}; the device busy {busy:.3f} ms of the "
            f"phase's {walls['phase']:.1f} s "
            f"({100 * busy / 1e3 / walls['phase']:.4f}%, CUDA events: the "
            f"seal, the rebuild and the plain encode)")
    finally:
        for p_ in (victim, proc):
            if p_ is not None and p_.poll() is None:
                p_.kill()
                p_.wait(timeout=30)
        if follower is not None:
            follower.stop()
        if cluster is not None:
            cluster.stop()
        qos.reset()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    if cur is not None and torch.cuda.current_device() != cur:
        fail(f"phase 14 left the current device "
             f"{torch.cuda.current_device()}, not {cur}")
    log(f"[14] done: launches {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 15: the native C++ data plane — the volume front with its JWT
# check and group commit, the S3 and filer fronts — beside the Python
# fronts, and volumes filled through it sealed through the kernel
# ----------------------------------------------------------------------
NAT_SECRET = "smoke15-jwt-secret"
NAT_CONNS = 8                    # keep-alive connections of the bench
NAT_FILL_BYTES = DAT_BYTES       # 1 GiB of needles, 1 KiB - 1 MiB
# then this many needles of 1-64 KiB (cut from 16,384: with the 1.5 GiB
# fill phase 15 took 98.6 s on one H100 host of the pool)
NAT_SMALL = 8192
NAT_SMALL_LO, NAT_SMALL_HI = 1 << 10, 64 << 10
# the Python front takes a prefix of the same fill: at its rates (239
# POSTs/s on an H100 host) the whole one would cost two minutes
NAT_PY_FILL_BYTES = 128 << 20
NAT_PY_SMALL = 1024
NAT_SEAL_READS = 512             # seeded GETs after the volume's seal
NAT_S3_READS = 256               # seeded GETs after the bucket's seal
# the first quarter of phase 10's small objects: PUTs wait on the
# sqlite filer's per-entry commit (4,096 took 34.1 s on an H100 host)
NAT_S3_OBJECTS = S3_SMALL // 4
NAT_FILER_FILES = 512            # 1-64 KiB files through the filer front
NAT_POOL = 256 << 20             # the seeded bytes the bodies are cut from
NAT_BUCKET = "smoke15"


def _nat_needles() -> tuple[list, list]:
    """The seeded fill of phase 15: (key, cookie, body) of 1 GiB of
    needles log-uniform in 1 KiB - 1 MiB (as phase 6), and of NAT_SMALL
    needles of 1-64 KiB (uniform). Each body is a slice of NAT_POOL
    seeded bytes at a seeded offset (making 1.6 GB of fresh bytes took
    6.9 s on the card's host); two needles share bytes only when offset
    and size both match."""
    rng = np.random.default_rng([SEED, 15])
    pool = memoryview(rng.bytes(NAT_POOL))

    def body(size: int) -> bytes:
        at = int(rng.integers(0, NAT_POOL - size + 1))
        return bytes(pool[at:at + size])

    lo, hi = np.log(1 << 10), np.log(1 << 20)
    big, total = [], 0
    while total < NAT_FILL_BYTES:
        data = body(int(np.exp(rng.uniform(lo, hi))))
        big.append((len(big) + 1, int(rng.integers(1 << 32)), data))
        total += len(data)
    small = [(i + 1, int(rng.integers(1 << 32)),
              body(int(rng.integers(NAT_SMALL_LO, NAT_SMALL_HI + 1))))
             for i in range(NAT_SMALL)]
    return big, small


def _nat_bench(dpmod, port: int, reqs: list[bytes], what: str) -> dict:
    """Replay prebuilt requests through the C++ bench client on
    NAT_CONNS keep-alive connections; fail on any non-2xx/3xx."""
    wall, lat, errs = dpmod.bench_raw("127.0.0.1", port, reqs, NAT_CONNS)
    if errs:
        fail(f"{what}: {errs} of {len(reqs)} requests failed")
    p50, p99 = np.percentile(lat, [50, 99]) * 1e3
    return {"wall": wall, "n": len(reqs), "p50_ms": p50, "p99_ms": p99}


def _nat_verify(port: int, items: list[tuple[str, bytes]], what: str,
                threads: int = NAT_CONNS) -> int:
    """GET every (path, body written) through 127.0.0.1:port on
    keep-alive connections; fail on any status or byte mismatch. ->
    bytes read.
    Each thread frames its replies by Content-Length on a raw socket,
    reading each body into one buffer (http.client's per-response
    bookkeeping held a 1.6 GB pass to 68 MB/s on the card's host)."""
    import socket

    def run(chunk):
        sock = socket.create_connection(("127.0.0.1", port), timeout=60)
        pending = b""
        total = 0
        try:
            for path, want in chunk:
                sock.sendall(f"GET {path} HTTP/1.1\r\nHost: smoke\r\n"
                             f"\r\n".encode())
                while b"\r\n\r\n" not in pending:
                    got = sock.recv(1 << 16)
                    if not got:
                        fail(f"{what}: connection closed at {path}")
                    pending += got
                head, _, pending = pending.partition(b"\r\n\r\n")
                lines = head.decode("latin-1").split("\r\n")
                status = int(lines[0].split()[1])
                length = next(int(v) for k, _, v in
                              (x.partition(":") for x in lines[1:])
                              if k.strip().lower() == "content-length")
                body = bytearray(length)
                view = memoryview(body)
                n = min(len(pending), length)
                view[:n] = pending[:n]
                pending = pending[n:]
                while n < length:
                    got = sock.recv_into(view[n:])
                    if not got:
                        fail(f"{what}: connection closed in {path}")
                    n += got
                if status != 200 or body != want:
                    fail(f"{what}: GET {path} gave {status} and other "
                         "bytes")
                total += length
        finally:
            sock.close()
        return total

    return sum(_pool_map(run, [items[i::threads] for i in range(threads)],
                         threads=threads))


def _nat_counters(port: int) -> dict:
    """The volume process's native counters: /status's native_dataplane
    and the sum over codes of native_front_requests_total and of
    native_fronts_requests_total by front, and the native_commit_*
    counters of /metrics (requests the front relays to the app)."""
    import re

    from seaweedfs_tpu_torch.rpc.httpclient import session

    st = session().get(f"http://127.0.0.1:{port}/status",
                       timeout=30).json()
    text = session().get(f"http://127.0.0.1:{port}/metrics",
                         timeout=30).text
    out = {"http": st.get("native_dataplane", {}), "front": 0,
           "fronts": {}, "commit": {}}
    for m in re.finditer(r'^native_front_requests_total\{code="\w+"\} '
                         r'(\d+)$', text, re.M):
        out["front"] += int(m.group(1))
    for m in re.finditer(r'^native_fronts_requests_total\{front="(\w+)",'
                         r'code="\w+"\} (\d+)$', text, re.M):
        out["fronts"][m.group(1)] = \
            out["fronts"].get(m.group(1), 0) + int(m.group(2))
    for m in re.finditer(r'^native_commit_(\w+)_total (\S+)$', text, re.M):
        out["commit"][m.group(1)] = float(m.group(2))
    return out


def _nat_rate(label: str, b: dict, nbytes: int) -> str:
    return (f"{label}: {b['n']} requests in {b['wall']:.3f} s, "
            f"{b['n'] / b['wall']:.1f}/s, {nbytes / b['wall'] / 1e6:.1f} "
            f"MB/s, p50 {b['p50_ms']:.3f} ms p99 {b['p99_ms']:.3f} ms")


def phase_native(card: str) -> dict:
    """Phase 15: the native C++ data plane. -> kernel launches of the
    seals of volumes filled through the native volume and S3 fronts."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.native import dataplane as dpmod
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.utils.security import sign_jwt

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke15-")
    launches: dict[str, int] = {}
    master = env = cluster = None
    threads: dict[str, object] = {}
    try:
        t0 = time.perf_counter()
        lib = dpmod._load()._name
        log(f"[15] {card}; the native data plane "
            f"{os.path.basename(lib)} built from "
            f"seaweedfs_tpu_torch/native/dataplane.cc in "
            f"{time.perf_counter() - t0:.3f} s")

        # 15a/b. an in-process master, then two volume servers through
        # the CLI's own `volume` wiring, -dataplane native and python,
        # both under -jwt.secret and -commit.durability=batch
        master = Cluster(os.path.join(tmp, "master"), n_volume_servers=0,
                         volume_size_limit=2 * DAT_BYTES,
                         pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        env = CommandEnv(master.master_url)
        mhost = master.master_url.split("//", 1)[1]
        ports = dict(zip(("native", "python"), free_ports(2)))
        vs = {}
        for mode, port in ports.items():
            d = os.path.join(tmp, mode)
            os.makedirs(d)
            args = cli.build_parser().parse_args([
                "volume", "-ip", "127.0.0.1", "-port", str(port),
                "-dir", d, "-max", "8", "-mserver", mhost,
                "-dataplane", mode, "-jwt.secret", NAT_SECRET,
                "-commit.durability", "batch", "-ec.backend", "cuda"])
            threads[mode], vs[mode] = cli._start_volume(
                args, [d], port, mhost, max_volumes=args.max,
                jwt_secret=args.jwt_secret, **cli._commit_kwargs(args))
        if vs["native"].dp is None or vs["python"].dp is not None:
            fail("-dataplane native did not start the front, or python "
                 "did")
        _poll(lambda: len(env.data_nodes()) == 2, 30.0,
              "both volume servers registered")
        vids = {}
        for mode, port in ports.items():
            for part in ("big", "small"):
                g = env.master_get("/vol/grow", collection=f"nat15{part}",
                                   count=1, dataNode=f"127.0.0.1:{port}")
                if g.get("count") != 1:
                    fail(f"/vol/grow on {mode}: {g}")
        # the grown volume ids, as the servers report them
        for mode, port in ports.items():
            held = {col: int(v) for n in env.data_nodes()
                    if n["url"] == f"127.0.0.1:{port}"
                    for v, col in n.get("collections", {}).items()}
            for part in ("big", "small"):
                vids[mode, part] = held[f"nat15{part}"]
        t0 = time.perf_counter()
        big, small = _nat_needles()
        big_bytes = sum(len(b) for _, _, b in big)
        small_bytes = sum(len(b) for _, _, b in small)
        log(f"[15a] seeded fill: {len(big)} needles, {big_bytes} B "
            f"(1 KiB - 1 MiB log-uniform), then {len(small)} needles, "
            f"{small_bytes} B ({NAT_SMALL_LO}-{NAT_SMALL_HI} B), made in "
            f"{time.perf_counter() - t0:.3f} s")

        def fid(mode, part, key, cookie):
            return f"{vids[mode, part]},{key:x}{cookie:08x}"

        def posts(mode, part, needles):
            out = []
            for key, cookie, body in needles:
                f = fid(mode, part, key, cookie)
                tok = sign_jwt(NAT_SECRET, f, expires_seconds=3600)
                out.append(
                    f"POST /{f} HTTP/1.1\r\nHost: smoke\r\n"
                    f"Authorization: Bearer {tok}\r\n"
                    f"Content-Type: application/octet-stream\r\n"
                    f"Content-Length: {len(body)}\r\n\r\n".encode()
                    + body)
            return out

        def gets(mode, part, needles):
            return [f"GET /{fid(mode, part, k, c)} HTTP/1.1\r\n"
                    f"Host: smoke\r\n\r\n".encode()
                    for k, c, _ in needles]

        n_py, acc = 0, 0
        while acc < NAT_PY_FILL_BYTES and n_py < len(big):
            acc += len(big[n_py][2])
            n_py += 1
        fills = {"native": (big, small),
                 "python": (big[:n_py], small[:NAT_PY_SMALL])}
        rates: dict[str, dict] = {}
        c0 = _nat_counters(ports["native"])
        for mode, port in ports.items():
            mbig, msmall = fills[mode]
            r = rates[mode] = {}
            r["POST 1 KiB-1 MiB"] = _nat_bench(
                dpmod, port, posts(mode, "big", mbig), f"{mode} fill")
            r[f"POST {NAT_SMALL_LO}-{NAT_SMALL_HI} B"] = _nat_bench(
                dpmod, port, posts(mode, "small", msmall),
                f"{mode} small fill")
            r["GET 1 KiB-1 MiB"] = _nat_bench(
                dpmod, port, gets(mode, "big", mbig), f"{mode} reads")
            r[f"GET {NAT_SMALL_LO}-{NAT_SMALL_HI} B"] = _nat_bench(
                dpmod, port, gets(mode, "small", msmall),
                f"{mode} small reads")
            for label, b in r.items():
                nbytes = sum(len(x[2]) for x in
                             (mbig if "1 MiB" in label else msmall))
                log(f"[15a] {mode} front, "
                    + _nat_rate(label, b, nbytes))
        c1 = _nat_counters(ports["native"])
        n_native = 2 * (len(big) + len(small))
        served = {k: c1["http"][k] - c0["http"].get(k, 0)
                  for k in ("fast_get", "fast_post", "proxied")}
        front = c1["front"] - c0["front"]
        if served["fast_post"] < len(big) + len(small) or \
                served["fast_get"] < len(big) + len(small) or \
                front < n_native:
            fail(f"the native front served {served} and counted {front} "
                 f"in native_front_requests_total for {n_native} "
                 "requests")
        # every body through the native front; the Python front's
        # through its store (an HTTP pass of it would contend for this
        # process's GIL with the server for half a minute) and a seeded
        # sample of NAT_SEAL_READS through its port
        t0 = time.perf_counter()
        n = _nat_verify(ports["native"], [
            (f"/{fid('native', part, k, c)}", body)
            for part, needles in (("big", big), ("small", small))
            for k, c, body in needles], "native read-back")
        log(f"[15a] native front: every body of the "
            f"{len(big) + len(small)} needles GET byte-equal ({n} B, "
            f"checked in {time.perf_counter() - t0:.3f} s)")
        t0 = time.perf_counter()
        for part, needles in zip(("big", "small"), fills["python"]):
            for k, c, body in needles:
                if vs["python"].store.read_needle(
                        vids["python", part], k, c).data != body:
                    fail(f"python front: needle {part} {k} differs")
        rng = np.random.default_rng([SEED, 15, 2])
        psmall = fills["python"][1]
        n = _nat_verify(ports["python"], [
            (f"/{fid('python', 'small', psmall[i][0], psmall[i][1])}",
             psmall[i][2])
            for i in rng.choice(len(psmall), min(NAT_SEAL_READS,
                                                 len(psmall)),
                                replace=False)], "python read-back")
        log(f"[15a] python front: every needle byte-equal in its store, "
            f"{NAT_SEAL_READS} seeded ones GET ({n} B); checked in "
            f"{time.perf_counter() - t0:.3f} s")
        log(f"[15a] native process: native_front_requests_total +{front} "
            f"for {n_native} requests; fast_post +{served['fast_post']}, "
            f"fast_get +{served['fast_get']}, relayed +{served['proxied']}")
        SAME_RUN["15a"] = rates

        # 15b. the guard and the ack contract, answered by the front
        j0 = _nat_counters(ports["native"])["http"]
        st = session().post(
            f"http://127.0.0.1:{ports['native']}/"
            f"{fid('native', 'small', 1 << 40, 7)}", data=b"unsigned",
            timeout=30)
        acks = []
        for i in range(8):
            f = fid("native", "small", (1 << 40) + i + 1, 9)
            r = session().post(
                f"http://127.0.0.1:{ports['native']}/{f}",
                data=b"signed-%d" % i, timeout=30,
                headers={"Authorization":
                         f"Bearer {sign_jwt(NAT_SECRET, f)}"})
            acks.append((r.status_code, r.headers.get("X-Sw-Durability")))
        c2 = _nat_counters(ports["native"])
        # the 401 and the 201s came from the front: jwt_reject and
        # fast_post moved by them (the relayed count moves by the
        # counter reads' own /status and /metrics)
        if st.status_code != 401 or \
                c2["http"]["jwt_reject"] - j0["jwt_reject"] != 1 or \
                c2["http"]["fast_post"] - j0["fast_post"] != 8:
            fail(f"unsigned POST: {st.status_code}, jwt_reject "
                 f"{j0['jwt_reject']} -> {c2['http']['jwt_reject']}, "
                 f"fast_post {j0['fast_post']} -> "
                 f"{c2['http']['fast_post']}")
        if acks != [(201, "batch")] * 8:
            fail(f"signed POSTs answered {acks}")
        dw = c2["commit"]["writes"] - c0["commit"].get("writes", 0)
        df = c2["commit"]["fsyncs"] - c0["commit"].get("fsyncs", 0)
        if not 0 < df < dw:
            fail(f"native commit: {dw} writes, {df} fsyncs")
        log(f"[15b] unsigned POST -> 401 from the front (jwt_reject "
            f"+{c2['http']['jwt_reject'] - j0['jwt_reject']}); 8 signed "
            f"POSTs -> 201 X-Sw-Durability: batch; native_commit over the "
            f"fill: {dw:.0f} writes, {df:.0f} fsyncs, "
            f"{dw / df:.1f} writes per fsync, "
            f"{c2['commit'].get('batches', 0) - c0['commit'].get('batches', 0):.0f}"
            f" batches")

        # 15c. ec.encode of the natively filled volume through the kernel
        vid = vids["native", "big"]
        vol = vs["native"].store.find_volume(vid)
        if vol is None or vol.delegate is None:
            fail(f"volume {vid} is not attached to the native plane")
        dat_size = vol.dat.size()
        want = _encode_launches(dat_size)
        repl.run_command(env, "lock")
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        with _KernelEvents() as ev:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        launches["seal volume front"] = codec_cuda.coded_matmul.launches
        dt = time.perf_counter() - t0
        repl.run_command(env, "unlock")
        if launches["seal volume front"] != want:
            fail(f"ec.encode of the {dat_size} B volume made "
                 f"{launches['seal volume front']} launches, want {want}")
        if sorted(env.ec_shard_locations(vid)) != list(range(14)):
            fail(f"shards {sorted(env.ec_shard_locations(vid))} after "
                 "ec.encode")
        rng = np.random.default_rng([SEED, 15, 3])
        pick = rng.choice(len(big), NAT_SEAL_READS, replace=False)
        p0 = _nat_counters(ports["native"])["http"]["proxied"]
        t1 = time.perf_counter()
        _nat_verify(ports["native"], [
            (f"/{fid('native', 'big', big[i][0], big[i][1])}", big[i][2])
            for i in pick], "EC read-back")
        t2 = time.perf_counter()
        relayed = _nat_counters(ports["native"])["http"]["proxied"] - p0
        if relayed < NAT_SEAL_READS:
            fail(f"{relayed} of {NAT_SEAL_READS} EC reads were relayed")
        log(f"[15c] ec.encode -volumeId={vid} ({dat_size} B .dat filled "
            f"through the front, detached from the plane first): "
            f"{dt:.3f} s, kernel launches "
            f"{launches['seal volume front']} (CUDA events "
            f"{ev.ms():.3f} ms); {NAT_SEAL_READS} seeded needles GET "
            f"through the front's port, relayed to the EC volume "
            f"({relayed} relayed): {t2 - t1:.3f} s, "
            f"{NAT_SEAL_READS / (t2 - t1):.1f} reads/s, all byte-equal")
        for mode in ("native", "python"):
            threads.pop(mode).stop()
        master.stop()
        master = None
        env.close()
        env = None

        # 15d. the S3 front: phase 10's small objects
        cluster = Cluster(os.path.join(tmp, "cluster"), n_volume_servers=1,
                          max_volumes=16, volume_size_limit=DAT_BYTES,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                          with_filer=True, filer_store="sqlite",
                          with_s3=True, s3_native=True, filer_native=True,
                          s3_config=S3_CONFIG)
        env = CommandEnv(cluster.master_url)
        s3 = _S3Client(cluster.s3_url)
        if s3("PUT", f"/{NAT_BUCKET}").status_code != 200:
            fail("CreateBucket on the native S3 front")
        _poll(lambda: cluster.s3_front.front.pool_level(NAT_BUCKET) > 0,
              30.0, "the S3 front's fid pool filled")
        objs = range(S3_BIG + 1, S3_BIG + 1 + NAT_S3_OBJECTS)
        want_md5 = {}

        def put_one(i):
            key, data = _s3_object(i)
            r0 = time.perf_counter()
            r = s3("PUT", f"/{NAT_BUCKET}/{key}", data)
            dt = time.perf_counter() - r0
            md5 = hashlib.md5(data).hexdigest()
            if r.status_code != 200 or r.headers.get("ETag") != f'"{md5}"':
                fail(f"native S3 PUT {key}: {r.status_code} "
                     f"{r.headers.get('ETag')}")
            want_md5[key] = md5
            return dt, len(data)

        def get_one(i):
            key, _ = _s3_object(i)
            r0 = time.perf_counter()
            r = s3("GET", f"/{NAT_BUCKET}/{key}")
            dt = time.perf_counter() - r0
            if r.status_code != 200 or \
                    hashlib.md5(r.content).hexdigest() != want_md5[key] \
                    or r.headers.get("ETag") != f'"{want_md5[key]}"':
                fail(f"native S3 GET {key}: {r.status_code} "
                     f"{r.headers.get('ETag')}")
            return dt, len(r.content)

        f0 = _nat_counters(cluster.stores[0].port)
        s0 = cluster.s3_front.stats()
        t0 = time.perf_counter()
        put = _pool_map(put_one, objs)
        t1 = time.perf_counter()
        got = _pool_map(get_one, objs)
        t2 = time.perf_counter()
        s1 = cluster.s3_front.stats()
        f1 = _nat_counters(cluster.stores[0].port)
        n_s3 = f1["fronts"].get("s3", 0) - f0["fronts"].get("s3", 0)
        moved = {k: s1[k] - s0[k] for k in s1}
        if n_s3 < 2 * len(objs) or moved["fast_put"] < len(objs) or \
                moved["fast_get"] < len(objs) or moved["chan_fail"]:
            fail(f"native_fronts_requests_total{{front=\"s3\"}} +{n_s3}, "
                 f"front stats {moved} for {len(objs)} PUTs and GETs")
        nbytes = sum(n for _, n in put)
        for label, wall, lat in (("PUT", t1 - t0, [d for d, _ in put]),
                                 ("GET", t2 - t1, [d for d, _ in got])):
            log(f"[15d] native S3 front, {len(objs)} signed {label}s of "
                f"{S3_SMALL_LO}-{S3_SMALL_HI} B ({S3_THREADS} client "
                f"threads): {wall:.3f} s, {len(objs) / wall:.1f} objects/s, "
                f"{nbytes / wall / 1e6:.2f} MB/s, {_lat(lat)}")
            SAME_RUN[f"15d {label}"] = (len(objs) / wall, lat)
        for label, (rate, lat) in SAME_RUN.items():
            if label.startswith("10"):
                log(f"[15d] beside phase 10's Python S3 front in this "
                    f"run, {label}: {rate:.1f} objects/s, {_lat(lat)}")
        log(f"[15d] every md5 and ETag equal; "
            f"native_fronts_requests_total{{front=\"s3\"}} +{n_s3}; "
            f"front stats {moved}")
        bvids = _bucket_vids(env, NAT_BUCKET)
        sizes = {v: cluster.stores[0].find_volume(v).dat.size()
                 for v in bvids}
        want = sum(_encode_launches(n) for n in sizes.values())
        repl.run_command(env, "lock")
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        with _KernelEvents() as ev:
            for v in bvids:
                repl.run_command(env, f"ec.encode -volumeId={v}")
        launches["seal S3 front"] = codec_cuda.coded_matmul.launches
        dt = time.perf_counter() - t0
        repl.run_command(env, "unlock")
        if launches["seal S3 front"] != want:
            fail(f"the bucket's seals made {launches['seal S3 front']} "
                 f"launches, want {want}")
        rng = np.random.default_rng([SEED, 15, 4])
        sample = [int(i) for i in rng.choice(
            list(objs), min(NAT_S3_READS, len(objs)), replace=False)]
        t1 = time.perf_counter()
        _pool_map(get_one, sample)
        t2 = time.perf_counter()
        log(f"[15d] ec.encode of the bucket's {len(bvids)} volumes "
            f"({sizes} B .dat): {dt:.3f} s, kernel launches "
            f"{launches['seal S3 front']} (CUDA events {ev.ms():.3f} ms); "
            f"{len(sample)} seeded objects GET through the S3 front after "
            f"the seal: {t2 - t1:.3f} s, "
            f"{len(sample) / (t2 - t1):.1f} objects/s, md5 and ETag equal")

        # 15e. the filer front against the Python filer, same paths
        rng = np.random.default_rng([SEED, 15, 5])
        files = [(f"/nat15/f{i:04d}.bin",
                  rng.bytes(int(rng.integers(NAT_SMALL_LO,
                                             NAT_SMALL_HI + 1))))
                 for i in range(NAT_FILER_FILES)]
        front_url, py_url = cluster.filer_url, cluster.filer_thread.url

        def fput(item):
            path, body = item
            r0 = time.perf_counter()
            r = session().put(front_url + path, data=body, timeout=30)
            if r.status_code != 201:
                fail(f"filer front PUT {path}: {r.status_code} {r.text}")
            return time.perf_counter() - r0

        def fget(item):
            path, body = item
            r0 = time.perf_counter()
            n = session().get(front_url + path, timeout=30)
            dt = time.perf_counter() - r0
            p = session().get(py_url + path, timeout=30)
            if (n.status_code, n.content) != (p.status_code, p.content) \
                    or n.content != body:
                fail(f"filer GET {path}: front {n.status_code}, Python "
                     f"{p.status_code}, bodies differ")
            return dt

        ff0 = cluster.filer_front.stats()
        t0 = time.perf_counter()
        put_lat = _pool_map(fput, files)
        t1 = time.perf_counter()
        get_lat = _pool_map(fget, files)
        t2 = time.perf_counter()
        ff1 = cluster.filer_front.stats()
        fmoved = {k: ff1[k] - ff0[k] for k in ff1}
        if fmoved["fast_put"] < len(files) or \
                fmoved["fast_get"] < len(files) or fmoved["chan_fail"]:
            fail(f"filer front stats {fmoved} for {len(files)} files")
        missing = session().get(front_url + "/nat15/absent.bin", timeout=30)
        missing_py = session().get(py_url + "/nat15/absent.bin", timeout=30)
        if (missing.status_code, missing.content) != \
                (missing_py.status_code, missing_py.content):
            fail("a missing path answers differently on the two filers")
        fbytes = sum(len(b) for _, b in files)
        log(f"[15e] native filer front, {len(files)} PUTs of "
            f"{NAT_SMALL_LO}-{NAT_SMALL_HI} B ({S3_THREADS} client "
            f"threads): {t1 - t0:.3f} s, {len(files) / (t1 - t0):.1f}/s, "
            f"{fbytes / (t1 - t0) / 1e6:.2f} MB/s, {_lat(put_lat)}; GETs "
            f"(each beside the Python filer's GET of the same path, equal "
            f"status and body): {_lat(get_lat)}; front stats {fmoved}")
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 15 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[15] phase 15 took {time.perf_counter() - t_phase:.3f} s; "
            f"kernel launches {launches}; {card}")
        return launches
    finally:
        if env is not None:
            env.close()
        for t in threads.values():
            t.stop()
        for c in (master, cluster):
            if c is not None:
                c.stop()
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
    tier_launches = phase_tier(card)
    chaos_launches = phase_chaos(card)
    secure_launches = phase_secure(card)
    native_launches = phase_native(card)
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
        "tier_launches": sum(tier_launches.values()),
        "tier_launches_by_step": tier_launches,
        "chaos_launches": sum(chaos_launches.values()),
        "chaos_launches_by_step": chaos_launches,
        "secure_launches": sum(secure_launches.values()),
        "secure_launches_by_step": secure_launches,
        "native_launches": sum(native_launches.values()),
        "native_launches_by_step": native_launches,
    }]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
