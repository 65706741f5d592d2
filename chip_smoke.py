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
7. The cluster over HTTP: a master, three volume servers on "cuda" and
   the shell; one volume filled with 512 MiB of seeded needles through
   assign + upload (CLUSTER_FILL_BYTES, cut from 1 GiB for phase 19's
   room), then ec.encode, reads from every server, lost shards read
   degraded, a partial and a full ec.rebuild, ec.decode back to a .dat
   equal to the sealed one's live prefix; launches > 0 for each
   command, none for a read pass.

8. The mesh and the batched feeds, on every card torch sees (one card:
   a (1, 1) mesh; four: (2, 2)):
   a. MeshCodec: coded_matmul byte-equal to the kernel on one card
      (RS(10,4) and RS(28,4) parity, the recovery rows of {1,4,11,13};
      n = 32 Mi + 777 and 1); write_ec_files(backend="mesh") on phase
      3's seeded 1 GiB .dat, shards sha256-equal to phase 3's;
      rebuild_ec_files(backend="mesh") of {1,4,11,13}, sha256-equal;
      kernel launches > 0 on every card of the mesh.
   b. pipelined_encode_stream, BASELINE config #3 cut from 64 to 32 x
      1 GiB volumes (PR 14, for phase 16's room), RS(10,4), depth 2, 104
      blocks of (8, 10, <= 4 Mi)
      from a pool of 4 seeded blocks, each result equal to the native
      codec's parity of its pool block; with mesh=None and with the
      mesh; then the same bytes through the kernel's route
      (CudaCodec.coded_matmul_stream per volume) and its transfer-only
      ceiling (and, with more than one card, the mesh codec's route and
      ceiling). MB/s and stage seconds of each.
   c. pipelined_scrub over the same blocks (BASELINE config #5, cut
      from 1000 volumes to 32), without and with the mesh: 0 mismatches
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
   a. A 256 MiB volume of phase 7's seeded needles (its writer, its
      seed; HTTP_FILL_BYTES) through ec.encode; the 14 shards hashed; the server with the fewest
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
   a. SigV4-signed PUTs of 84 objects of 10 MiB (warp's default size,
      two 8 MiB filer chunks each), one 160 MiB object by multipart
      (10 x 16 MiB parts) and 1,024 objects of 1-64 KiB (every 8th
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
   b. A 256 MiB volume filled over HTTP with every /vol/grow and
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
   a. Phase 9's seeded needles fill one collection's volume with
      256 MiB (under its 1 GiB limit).
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
   a. No faults: phase 9's seeded needles fill a 256 MiB volume; 512
      seeded reads and 200 S3 PUT/GET cycles (the reference chaos
      test's objects) are the baseline; a copy of the .dat is encoded
      with the native codec.
   b. Faults on, in this process (the master has them from its flags).
   c. The tiering controller's seal (POST /debug/tiering): one
      attempt, exactly ec.encode's launches (1 at 256 MiB), no repair
      during it, 14 shards sha256-equal to the fault-free encode.
   d. The server with the fewest shards stopped: it leaves the
      master's topology dump as its heartbeat stream closes (the
      master's breaker for it reported); the watchdog's partial rebuild
      in one attempt with one launch per 4 MiB chunk of a shard (7 at
      256 MiB), 14 live shards, rebuilt ones sha256-equal; 512 degraded
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
      with X-Sw-Durability: batch; then a 256 MiB volume filled through
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
   e. The tiering controller's seal of the 256 MiB volume (POST
      /debug/tiering): exactly ec.encode's launches in one attempt, 0
      repairs, 14 shards sha256-equal to the plain version's encode of
      the same .dat on the card.
   f. The victim SIGKILLed at a seeded point while 8 writers are
      mid-write to a second volume on it (its /debug/commit just before:
      fewer fsyncs than writes); the watchdog rebuilds the victim's
      shards of the sealed volume elsewhere through the kernel (one
      launch per 4 MiB chunk of a shard), the 14 live shards sha256-equal to step e's; the
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
      it, the Python front its first 32 MiB and 1,024 small needles
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
      one volume server: phase 10's 1,024 signed objects of 1-64 KiB (the sqlite filer's per-entry commit holds
      the PUTs near phase 10's rate) PUT and GET through the native S3
      front on phase 10's 8 client threads
      (objects/s, p50 / p99 beside phase 10's Python-front numbers of
      this run); md5 and ETag equal; native_fronts_requests_total
      {front="s3"} counts them; the bucket's volumes sealed (launches as
      their sizes give) and 256 seeded objects read back through S3.
   e. 512 files of 1-64 KiB PUT and GET through the native filer
      front, each GET beside the Python filer's GET of the same path:
      equal statuses and bodies.

16. The volume server's data verbs and the client tools. An in-process
   master (volume limit 1 GiB, pulse 0.5 s) and four processes of the
   CLI's `volume -dataplane native -ec.backend cuda` (the reference's
   default front; four, not three: RS(10,4)'s 14 shards spread 5/5/4
   over three servers, and the one holding the most data shards would
   hold 5, past m = 4). Launches in a volume process are read from its
   /metrics (`cuda_kernel_launches`); the CLI's subcommands run here
   through `cli.main`. Each step is fatal on failure:
   a. `upload -maxMB 64` of one seeded 512 MiB file into a collection
      pinned to one grown volume: 8 chunk needles and a ?cm=true
      manifest; `download` of the manifest fid sha256-equal; a 3-range
      GET across chunk boundaries relayed by the front answers 206
      multipart/byteranges, each part equal; one 64 MiB chunk through
      the paged read path (a GET with a query string, which the front
      relays; `volume_server_paged_reads_total` +1); a 5 MiB
      multipart/form-data POST stored with its file name and type.
      MB/s of the upload, the download and the paged GET.
   b. `benchmark -client native -n 8192 -size 4096 -c 8` and `-client
      python -n 1024`: writes/s and reads/s with p50 / p99.
   c. V, the volume holding the most of the file (at least half):
      `backup` (a full copy), 128 x 1 MiB needles added to V by fid,
      `backup` again (only the new records: the bytes pulled within 1%
      of those appended); V read-only: the copy's .dat and .idx
      sha256-equal to V's; `fix` of a copy of the .dat rebuilds V's
      .idx; `export` of the copy: every tar member equal to its needle
      read by fid. `ec.encode` of V in the cluster and
      `write_ec_files(backend="cuda")` of the copy: the 14 shards
      sha256-equal, each seal's launches exactly ec.encode's for the
      size; walls and CUDA-event (or kernel-stage) times.
   d. The server holding the most data shards of V (at most 4 shards,
      none of the file's other volumes) SIGKILLed: `download` through
      degraded reads sha256-equal; `ec.rebuild` (partial) back to 14
      shards with exactly one launch per 4 MiB of a shard; `download`
      sha256-equal again.
   e. 4,096 seeded JSON needles (a fifth sent as application/json, so
      stored gzipped) on one volume: /admin/query with SELECT a, b
      WHERE c > 50 byte-equal to a plain filter; /admin/volume_tail
      from the half-way stamp gives exactly the later needles;
      /ui/index.html of every live server lists its volumes.

17. A cloud bucket mounted under the filer (SeaweedFS's documented
   `remote.configure -type=s3` + `remote.mount`). The cloud: a second
   port cluster's S3 gateway holding bucket cloud17, seeded: 4 objects
   of 64 MiB and 48 of 16 MiB (1 GiB) and 256 of 1-64 KiB
   (log-uniform) under 8 prefixes. The main cluster: four in-process
   volume servers with ec_backend="cuda", a 1 GiB volume limit and a
   sqlite filer; `filer.remote.sync -dir /mnt/cloud17` and
   `filer.remote.gateway -createBucketAt cloud` run as CLI processes.
   Each step is fatal on failure:
   a. remote.configure, remote.mount, remote.meta.sync: fs.ls / fs.du
      show the 308 objects as files, bytes summing to the cloud's;
      entries/s.
   b. Read-through of uncached entries: the 4 large and 256 small
      objects GET sha256-equal, one ranged GET per large one equal;
      MB/s, p50 / p99 of the small ones.
   c. remote.cache of the mount: every entry gains chunks; the whole
      tree read back cached sha256-equal; MB/s of both.
   d. ec.encode of every volume holding the cached chunks: launches
      exactly as the .dat sizes give; kernel-stage (CUDA event) time.
   e. The volume server holding the most shards of the largest sealed
      volume stopped: the 4 large and 128 small entries read degraded,
      sha256-equal; ec.rebuild (launches > 0); read again, equal.
   f. remote.uncache of the 48 16-MiB entries: their chunks go, they
      read through again sha256-equal.
   g. 64 writes of 1 KiB-4 MiB through the filer reach the cloud
      sha256-equal (lag from the filer's 201, p50 / p99) with exactly
      one cloud PUT each (the loop guard); 16 deletes and 8 renames
      are mirrored (one PUT per rename).
   h. s3.bucket.create b17: the gateway maps /buckets/b17 to cloud/b17;
      16 objects written there appear in the cloud equal;
      s3.bucket.delete -includeObjects=true removes both (waited for).

18. Two data centres kept in sync (SeaweedFS's documented `filer.sync`
   between two filers, with `filer.backup`, `filer.meta.backup`,
   `filer.replicate` into S3 and a notification queue). dc1: three
   in-process volume servers, a sqlite filer; dc2: four (a lost one
   leaves 10 shards), a sqlite filer and the S3 gateway; both on
   ec_backend="cuda", volume limit 256 MiB. `filer.sync -a dc1 -b dc2
   -path /dc` and `filer.backup -path /dc -dir D` run as CLI
   processes; FilerMetaBackup (sqlite), a Replicator of /dc/small into
   s3://repl18 on dc2 and a log-queue notifier on dc1's filer in this
   one. Each step is fatal on failure:
   a. 8 x 16 MiB and 512 files of 1-64 KiB (log-uniform, 8
      directories), 136 MiB, written to dc1 on 8 threads: MB/s from the
      first PUT to the last file's create on dc2; every file
      sha256-equal on dc2 and in D, every small one md5-equal in
      repl18, every path in the meta backup, whose listings equal
      dc1's.
   b. 64 writes of 1 KiB-4 MiB 100 ms apart on dc1, then 64 on dc2: the
      lag from the 201 to the create on the other filer, p50 / p99, each
      way; after 5 s of quiet each of the 128 paths has exactly one
      event, a create, in each filer's log, the mirrored one signed by
      its origin (no bounce).
   c. 16 deletes and 8 renames on dc1 reflected on dc2, in D and in the
      meta backup.
   d. The notifier's JSONL holds exactly one line per event under /dc,
      in order; with `notification.conf` a log queue in dc1's KV,
      `fs.meta.notify /dc/small` answers the walk's count and writes
      one create line per entry. (Kafka, SQS and Pub/Sub are held on
      the CPU only: their doubles need packages the card's machine
      lacks.)
   e. ec.encode of dc2's volumes holding the mirror: launches exactly as
      the `.dat` sizes give (the volume servers' /metrics agree), no
      repair queued; the tree read back sha256-equal; the server
      holding the most shards of the largest volume stopped: the 8 big
      files read degraded, sha256-equal (MB/s); ec.rebuild (launches >
      0); read again, equal.
   f. filer.sync and filer.backup stopped, 16 files written to dc1,
      filer.sync started again: exactly those 16 reach dc2, no earlier
      path is created twice there, its offset (`sync/<dc2's
      signature>/offset` in dc1's KV) advanced.

19. An encrypted, sharded, cached filer behind S3 (SeaweedFS's
   `filer -store leveldb -encryptVolumeData` with the port's
   `-filer.store.shards 4 -filer.cache.entries 4096`). An in-process
   master and four volume servers on "cuda", volume limit 64 MiB; the
   filer and the S3 gateway as CLI processes. Each step is fatal on
   failure:
   a. AES-256-GCM on the host's libcrypto against the GCM
      specification's test case 15; the filer's /status says "cipher".
   b. 8 buckets, 1,024 objects of 1-64 KiB (log-uniform) through S3 on
      8 threads, 8 x 16 MiB through the filer under /big: every chunk
      read raw from its volume server is 28 B longer than its piece,
      not the plaintext, and decrypts under its entry's key to it;
      /debug/filer shows 4 shards whose entries sum to the entries the
      listings walk, the buckets on more than one shard.
   c. Every bucket listed 100 keys a page, twice: the second pass raises
      filer_store_cache_hits_total; 32 overwrites, 16 deletes and 8
      renames through the filer, each read back through S3 at once,
      then every listing and every object: no stale read.
   d. The filer process stopped and started on the same store
      directory: every listing page as before; weedkv's
      filer_store_compaction_seconds count.
   e. ec.encode of every volume holding the ciphertext: launches exactly
      as the .dat sizes give (the volume servers' /metrics agree), the
      kernel stage in CUDA events; every object (S3) and file (filer)
      read sealed, sha256-equal; the server holding the most shards of
      the largest volume stopped: the big files read degraded;
      ec.rebuild (launches > 0, /metrics agree); everything read again.
20. S3 buckets a browser and the public use (SeaweedFS's documented
   `weed filer` + `weed s3`): an in-process master and four volume
   servers on "cuda", volume limit 64 MiB; `filer -store leveldb` and
   `s3 -config` as CLI processes, probed by a TCP connect. Each step is
   fatal on failure:
   b. s20-pub set public-read by x-amz-acl and by an AccessControlPolicy
      body (GET ?acl: the owner's FULL_CONTROL and AllUsers READ); 256
      objects of 1-64 KiB (log-uniform) by signed PUTs; an unsigned GET
      and HEAD of each answers 200 with its bytes; an unsigned PUT,
      ?acl, listing and DELETE, and an unsigned GET in a private bucket,
      403 AccessDenied.
   c. s20-tag: 256 objects, half PUT with x-amz-tagging (which the
      reference's gateway does not store: GET ?tagging is empty), every
      one tagged by PUT ?tagging, 32 cleared by DELETE ?tagging; every
      GET ?tagging equal to what was set.
   d. s20-form: 256 objects of 1-64 KiB and 4 of 16 MiB by browser form
      uploads signed with a POST policy (bucket, starts-with, content-
      length-range), each read back equal; an expired policy, a key
      outside starts-with and a file past content-length-range answer
      the reference's 403 AccessDenied / 403 / 400 EntityTooLarge.
   e. PUT ?lifecycle (Days 7 on tmp/) writes the TTL rule into
      filer.conf, GET mirrors it, DELETE takes it out; ownership
      controls PUT / GET / DELETE; bucket policy and CORS, object ACL,
      retention, legal hold and object lock answer 501 NotImplemented;
      the filer's text/html listing of /buckets/s20-pub links exactly
      its 256 keys.
   f. ec.encode of every volume of the three buckets: one launch a
      volume (the volume servers' /metrics agree), the kernel stage in
      CUDA events; the server holding the most shards of s20-pub's
      largest volume stopped: the unsigned GET + HEAD pass again,
      degraded; ec.rebuild (launches > 0, /metrics agree); the pass
      again, and every object of the three buckets equal.
21. The filer's protocol gateways: an in-process master and four volume
   servers on "cuda", volume limit 64 MiB; `filer -store leveldb`,
   `s3 -config`, `webdav`, `ftp -user`, `iam` and `mq.broker -master`
   as CLI processes, probed by a TCP connect. Each step is fatal on
   failure:
   b. WebDAV: 8 collections (MKCOL; a second MKCOL 405); 512 PUTs of
      1-64 KiB (log-uniform) on 8 threads, a GET of each sha256-equal;
      64 MOVEs (the source then 404) and 64 COPYs (412 onto a file with
      Overwrite F); PROPFIND Depth 1 of each collection lists exactly
      its files and sizes; a LOCK: a foreign token's PUT, LOCK and
      DELETE 423, the holder's PUT 201, UNLOCK 204; 4 x 16 MiB PUT and
      GET.
   c. FTP (`ftplib`): 4 sessions STOR 256 files of 1-64 KiB and RETR
      each; 2 x 16 MiB STOR, RETR whole and with REST from mid-file;
      RNFR / RNTO, DELE, MKD and a recursive RMD; LIST of each
      directory equal to the filer's listing.
   d. IAM: CreateUser, CreateAccessKey, PutUserPolicy (Read and Write
      on one bucket); the seconds until the CLI S3 gateway takes a
      signed PUT with the new key; 403 in another bucket; refused after
      DeleteAccessKey; the KV document as the reference writes it.
   e. mq: `mq.topic.create` of 4 partitions from the shell; 16,384
      records of 64 B-4 KiB (keys from 1,024; every 16th value not
      UTF-8) in batches of 256 from 4 threads; 256 single publishes (ack
      p50 / p99); a subscription of each partition from 0 returns every
      acked (partition, offset) once with its value; SIGINT: exit 0;
      the broker started again keeps the offsets, new publishes
      continue them, the replay is equal.
   f. ec.encode of every volume holding the phase's data: one launch a
      volume (the volume servers' /metrics agree), the kernel stage in
      CUDA events; the server holding the most shards of the largest
      volume stopped: a WebDAV GET of every file, an FTP RETR of the
      big ones and the mq replay of one partition, degraded, all equal;
      ec.rebuild (launches > 0, /metrics agree); the same pass rebuilt,
      and every partition replayed.
22. The FUSE mount: an in-process master and four volume servers on
   "cuda", volume limit 64 MiB; `filer -store leveldb` as a CLI process
   run with the global `-metrics.address` (a pushgateway in this
   script, `-metrics.intervalSec 1`), `-cpuprofile` and `-memprofile`.
   Before any mount, a probe: /dev/fuse opens read-write, libfuse.so.2
   loads, fusermount is on PATH; `[22] fuse: kernel` when all three
   hold, and every step runs through a `mount` process of the CLI and
   ordinary OS file I/O at its mountpoint; `[22] fuse: library (<the
   check that failed>)` otherwise, and every step runs through a WeedFS
   in this process. Each step is fatal on failure:
   a. `mount -cacheDir <empty> -writeMemoryLimitMB 8`: seconds from its
      spawn to os.path.ismount.
   b. 8 directories, 256 files of 1-64 KiB (log-uniform) by
      create+write+close on 8 threads (files/s, p50 / p99); a read of
      each sha256-equal; each directory's listing equal to the filer's;
      a file PUT through the filer's HTTP in the mount's listing (the
      seconds the metadata subscription takes).
   c. 4 x 16 MiB written in 1 MiB blocks and read back (MB/s); 8 MiB
      of 48 seeded 128 KiB random writes over a preallocated file,
      fsync'd, read back equal (the reference's fio gate); rename,
      symlink and readlink, hardlink, truncate, chmod and a user.*
      xattr, each held against the filer's entry; statvfs.
   d. fusermount -u: the mount process exits 0 within 10 s; every file
      reads sha256-equal through the filer's HTTP.
   e. ec.encode of every volume holding the phase's files: one launch a
      volume (the volume servers' /metrics agree), the kernel stage in
      CUDA events.
   f. The server holding the most shards of the largest volume stopped;
      a new mount process with a fresh, empty -cacheDir reads every
      file degraded, sha256-equal (files/s, p99, MB/s of the large
      ones), and unmounts with exit 0.
   g. ec.rebuild (launches > 0, /metrics agree); the same pass through
      yet another fresh mount.
   h. SIGINT stops the filer with exit 0; the pushgateway got PUT
      /metrics/job/filer carrying filer_request_seconds; the cProfile
      dump loads with pstats; the tracemalloc report is not empty.
23. The last modules, the analyzer and the image renditions:
   a. `python -m seaweedfs_tpu_torch.analysis --json` from the
      repository root exits 0 with no finding over 175 files or more,
      and `--list-rules` names the 12 rules; its wall beside the
      reference's 10 s lint gate.
   b. An image store (Haystack's photo workload): an in-process master
      and four volume servers on "cuda", volume limit 64 MiB; 256
      images of 32 KiB-2 MiB (log-uniform), PNG, GIF and BMP in turn,
      written by hand with zlib and struct, POSTed from 8 threads.
   c. A GET of every image with ?width=&height=&mode=fit, one in four
      cropped first (crop_x1..crop_y2). Without PIL (`[23] renditions:
      stored bytes`) every answer is the stored bytes, as the
      reference's; with PIL (`[23] renditions: PIL`) the size in each
      answer's header (PNG IHDR, GIF screen, BMP header) is the one
      asked for. Images/s, p50 / p99, MB/s.
   d. ec.encode of the image volumes through the kernel (launches > 0,
      the volume servers' /metrics agree); the server holding the most
      shards of the largest volume stopped; pass c again degraded,
      every answer equal to c's; the spans of the 5 slowest GETs from
      /debug/traces beside the p99.
   e. ec.rebuild (launches > 0, /metrics agree); pass c again, equal;
      every live volume server's volume_server_in_flight_*_bytes reads
      0.

24. The heartbeat stream at SeaweedFS's default pulse: a `master`
   process with no -pulseSeconds (5 s), -repair.enabled, -repair.grace
   3 (clear of ec.encode's partial mounts), and four `volume -dataplane
   python -ec.backend cuda` processes, each holding one /ws/heartbeat
   stream (the native front's two blocking relay workers stall
   concurrent degraded reads across processes: ROADMAP Queue 3 item
   13). Each step is fatal on failure:
   a. The processes, spawned together, listening (a TCP connect) and
      registered.
   b. A 256 MiB volume filled over HTTP (1 KiB-1 MiB needles, 8
      threads) and sealed by ec.encode: launches from the processes'
      /metrics equal to what the .dat's size gives; each shard's
      sha256; no repair during the seal.
   c. A writer assigning and uploading into a volume on every server;
      the server holding the fewest shards SIGKILLed. Detection: from
      the kill until /dir/lookup drops it (under 1 s) and until
      UnderParity lists the volume, beside when the killed process was
      reaped; the assigns naming the dead server before the detection,
      and 0 after it; the watchdog's rebuild.
   d. Its launches (> 0, the survivors' /metrics); 14 shards listed,
      sha256-equal to the sealed ones; every live needle of the volume
      and every needle the writer had acked on a live server read back
      byte-equal.

The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import gc
import glob
import gzip
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.parse
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
# the HTTP fills of phases 9, 11, 12, 13 and 14: cut from 1 GiB to make
# room for phase 16 in the 1200 s limit (phase 7 has its own, below); every
# launch count these phases check is derived from the filled .dat's size
HTTP_FILL_BYTES = 256 << 20
# phase 7's fill: cut from DAT_BYTES (1 GiB) to make room for phase 19;
# its launch counts follow the filled .dat's size
CLUSTER_FILL_BYTES = 512 << 20


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
    at 512 MiB. -> kernel launches of each shell command."""
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
        w = _fill_volume_http(cluster, env, "smoke7", SEED + 7,
                              CLUSTER_FILL_BYTES)
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
# BASELINE config #3 is 64 x 1 GiB: cut to 32 to make room for phase 16
# (each pass still moves 32 GiB through the feed)
VOLUMES = 32
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
    """(pool entry, width) of each of 8b's blocks: VOLUMES // GROUP
    groups of GROUP volumes, each group's 107,374,183-column rows cut
    into 4 Mi-column blocks."""
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
    # 1000 volumes to VOLUMES)
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
        w = _fill_volume_http(cluster, env, "smoke9", SEED + 7,
                              HTTP_FILL_BYTES)
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
            f"UnderParity lists it; stream closed, pulse {HEAL_PULSE} s), "
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
# 84, not 80: with 1,024 small objects (4,096 before phase 17 needed
# the room) the bucket still holds at least 1 GiB
S3_BIG = 84                       # warp's default object: 10 MiB
S3_BIG_BYTES = 10 << 20
S3_PARTS = 10                     # one multipart object, 10 x 16 MiB
S3_PART_BYTES = 16 << 20
S3_SMALL = 1024                   # 1-64 KiB, uniform
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
            f"-> UnderParity lists it; stream closed), repair "
            f"{t_done - t_seen:.3f} s "
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


def _spawn(args: list[str], log_path: str,
           card: bool = False) -> subprocess.Popen:
    """A process of the port's CLI, from the repository root; without a
    card unless `card` (the masters and the follower run no codec)."""
    out = open(log_path, "ab")
    env = dict(os.environ)
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    try:
        return subprocess.Popen(
            [sys.executable, "-m", "seaweedfs_tpu_torch", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=env, stdout=out, stderr=subprocess.STDOUT)
    finally:
        out.close()


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            return f.read()[-n:].decode("utf-8", "replace")
    except OSError:
        return ""


def _serve_cli(procs: dict, logs: dict, tmp: str, name: str,
               args: list[str], port: int, deadline: float) -> float:
    """Spawn a CLI process into procs[name] (its log in logs[name]) and
    wait until its port listens: a TCP connect, since HTTP polls of a
    port not yet listening would open the client's breaker for the peer
    (ROADMAP Queue 3 item 8). -> seconds taken."""
    import socket

    t1 = time.perf_counter()
    logs[name] = os.path.join(tmp, f"{name}.log")
    procs[name] = _spawn(args, logs[name])

    def up():
        if procs[name].poll() is not None:
            fail(f"the {name} process exited: {_tail(logs[name])}")
        try:
            socket.create_connection(("127.0.0.1", port), 1).close()
            return True
        except OSError:
            return False
    _poll(up, deadline, f"the {name} process listening")
    return time.perf_counter() - t1


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
    volume servers and a sqlite filer in this process; a 256 MiB volume
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
                              HTTP_FILL_BYTES)
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
            f"shards {lost}): detection {t_seen - t_stop:.3f} s (stream "
            f"closed), repair {t_done - t_seen:.3f} s by the new leader's "
            f"watchdog (mode "
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
    """Phase 12: the tiered-storage lifecycle at 256 MiB, driven by the
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

        # 12a. fill one collection's volume with HTTP_FILL_BYTES
        w = _fill_volume_http(cluster, env, col, SEED + 7,
                              HTTP_FILL_BYTES)
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
            f"{t_seen - t_kill:.3f} s (stream closed), repair "
            f"{t_done - t_seen:.3f} s "
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
    """Phase 13: the robustness and observability layer at 256 MiB. The
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
        w = _fill_volume_http(cluster, env, col, SEED + 13,
                              HTTP_FILL_BYTES)
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
            # the dead peer leaves the master's topology dump as its
            # heartbeat stream closes, before the federation scrape
            # (every CHAOS_SCRAPE s) can trip the master's breaker for
            # it; that breaker's state then is reported
            seen = {}

            def unregistered():
                st = _get_json(f"{master}/dir/status") or {}
                nodes = [n for dc in st.get("Topology", {}).get(
                    "datacenters", []) for rk in dc["racks"]
                    for n in rk["nodes"] if n["url"] == victim]
                if not st or nodes:
                    return False
                seen["topology"] = time.monotonic() - t_kill
                brs = (_get_json(f"{master}/debug/breakers") or {}).get(
                    "breakers", [])
                seen["debug"] = next((b["state"] for b in brs
                                      if b["peer"] == victim), "none")
                return True
            _poll(unregistered, HEAL_DEADLINE,
                  f"{victim} out of the master's topology dump", step=0.02)

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
        log(f"[13d] stopped {victim} (shards {lost}): out of the "
            f"master's topology dump {seen['topology']:.3f} s after the "
            f"stop (stream closed), the master's breaker for it then "
            f"{seen['debug']!r} at /debug/breakers; this process's "
            f"breaker {here.get(victim, {}).get('state')!r} (trips "
            f"{here.get(victim, {}).get('trips')}); detection "
            f"{t_seen - t_kill:.3f} s (stream closed), repair "
            f"{t_done - t_seen:.3f} s; "
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
    """Phase 14: the secured, durable write path at 256 MiB. The master
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
                    if filled["bytes"] >= HTTP_FILL_BYTES:
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
            f"{t_seen - t_kill:.3f} s (stream closed), repair "
            f"{t_done - t_seen:.3f} s, the "
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
NAT_PY_FILL_BYTES = 32 << 20     # cut from 128 MiB for phase 16
NAT_PY_SMALL = 1024
NAT_SEAL_READS = 512             # seeded GETs after the volume's seal
NAT_S3_READS = 256               # seeded GETs after the bucket's seal
# phase 10's small objects: PUTs wait on the sqlite filer's per-entry
# commit (4,096 took 34.1 s on an H100 host)
NAT_S3_OBJECTS = S3_SMALL
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


TOOLS_SERVERS = 4                # volume processes (see phase_tools)
TOOLS_FILE_BYTES = DAT_BYTES // 2  # the chunked file: 512 MiB
TOOLS_CHUNK_MB = 64              # upload -maxMB
TOOLS_VOLUME_LIMIT = DAT_BYTES   # the master's volume size limit
TOOLS_APPEND = 128               # 1 MiB needles added to V by fid (16c)
TOOLS_FORM_BYTES = 5 << 20       # the multipart/form-data upload
TOOLS_BENCH_NATIVE = 8192        # benchmark -client native -n
TOOLS_BENCH_PYTHON = 1024        # benchmark -client python -n
TOOLS_JSON_DOCS = 4096           # 16e's JSON needles
TOOLS_THREADS = 8


def _tools_cli(cli, argv: list[str]) -> str:
    """cli.main(argv) in this process (so the kernel's launches count
    here); its standard output, failing on a nonzero exit."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        fail(f"`{' '.join(argv[:2])} ...` exited {rc}: {buf.getvalue()}")
    return buf.getvalue()


def _tools_metrics(url: str) -> dict:
    """A volume process's kernel launches and kernel-stage seconds (the
    feed's CUDA events) from its /metrics, and its paged reads."""
    import re

    from seaweedfs_tpu_torch.rpc.httpclient import session

    text = session().get(f"http://{url}/metrics", timeout=30).text
    out = {"launches": 0, "kernel_s": 0.0, "paged": 0}
    m = re.search(r'^cuda_kernel_launches\{kernel="coded_matmul"\} (\S+)$',
                  text, re.M)
    if m:
        out["launches"] = int(float(m.group(1)))
    for m in re.finditer(r'^ec_codec_stage_seconds_sum\{([^}]*)\} (\S+)$',
                         text, re.M):
        if 'stage="kernel"' in m.group(1):
            out["kernel_s"] += float(m.group(2))
    m = re.search(r'^volume_server_paged_reads_total (\S+)$', text, re.M)
    if m:
        out["paged"] = int(float(m.group(1)))
    return out


def _tools_records(buf: bytes) -> list:
    """The needle records of a raw .dat span (a tail's body)."""
    import struct

    from seaweedfs_tpu_torch.storage import needle as ndl

    out, off = [], 0
    while off < len(buf):
        size = struct.unpack_from(">I", buf, off + 12)[0]
        if size >= 1 << 31:
            size = 0  # a tombstone
        disk = ndl.disk_size(size)
        out.append(ndl.Needle.from_bytes(buf[off:off + disk]))
        off += disk
    if off != len(buf):
        fail(f"the tail ended mid-record at {off} of {len(buf)} B")
    return out


def phase_tools(card: str) -> dict:
    """Phase 16: the volume server's data verbs and the client tools on
    four `volume -dataplane native` processes: a chunked file, the
    benchmark command, an incremental backup sealed offline beside the
    cluster's seal, a lost server under the chunked file, query and
    tail. -> kernel launches by step."""
    from seaweedfs_tpu_torch import cli
    from seaweedfs_tpu_torch.ec.encoder import write_ec_files
    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.storage import types as t

    t_phase = time.perf_counter()
    on_card = card != "cpu"
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke16-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    master = env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    try:
        # set-up: an in-process master; four volume processes of the
        # CLI's `volume` with the reference's default -dataplane native
        master = Cluster(os.path.join(tmp, "master"), n_volume_servers=0,
                         volume_size_limit=TOOLS_VOLUME_LIMIT,
                         pulse_seconds=HEAL_PULSE, ec_backend="native")
        env = CommandEnv(master.master_url)
        murl = master.master_url
        mhost = murl.split("//", 1)[1]
        dirs: dict[str, str] = {}
        t0 = time.perf_counter()
        for port in free_ports(TOOLS_SERVERS):
            url = f"127.0.0.1:{port}"
            dirs[url] = os.path.join(tmp, f"v{port}")
            os.makedirs(dirs[url])
            logs[url] = os.path.join(tmp, f"v{port}.log")
            procs[url] = _spawn(
                ["volume", "-ip", "127.0.0.1", "-port", str(port),
                 "-dir", dirs[url], "-max", "8", "-mserver", mhost,
                 "-dataplane", "native",
                 "-ec.backend", "cuda" if on_card else "native"],
                logs[url], card=on_card)
        _poll(lambda: len(env.data_nodes()) == TOOLS_SERVERS, 120.0,
              f"{TOOLS_SERVERS} volume processes registered")
        for url in procs:
            st = _get_json(f"http://{url}/status", timeout=30)
            if not st or "native_dataplane" not in st:
                fail(f"{url} serves no native front: {st}")
        walls["start"] = time.perf_counter() - t0
        log(f"[16] {card}; master {murl} (volume limit "
            f"{TOOLS_VOLUME_LIMIT} B, pulse {HEAL_PULSE} s) in this "
            f"process; {TOOLS_SERVERS} processes of `volume -dataplane "
            f"native -ec.backend {'cuda' if on_card else 'native'}` at "
            f"{sorted(procs)}, registered with native fronts in "
            f"{walls['start']:.3f} s")

        # 16a. a 512 MiB file through `upload -maxMB 64`
        path = os.path.join(tmp, "smoke16.bin")
        rng = np.random.default_rng([SEED, 16])
        piece = TOOLS_CHUNK_MB << 20
        h = hashlib.sha256()
        with open(path, "wb") as f:
            left = TOOLS_FILE_BYTES
            while left:
                b = rng.bytes(min(piece, left))
                h.update(b)
                f.write(b)
                left -= len(b)
        want = h.hexdigest()
        first = sorted(procs)[0]
        g = env.master_get("/vol/grow", collection="smoke16", count=1,
                           dataNode=first)
        if g.get("count") != 1:
            fail(f"/vol/grow of smoke16 on {first}: {g}")
        t0 = time.perf_counter()
        out = json.loads(_tools_cli(cli, [
            "upload", "-master", murl, "-maxMB", str(TOOLS_CHUNK_MB),
            "-collection", "smoke16", path]))
        walls["upload"] = time.perf_counter() - t0
        mfid = out["fid"]
        if not out.get("chunked") or out["size"] != TOOLS_FILE_BYTES:
            fail(f"upload -maxMB answered {out}")
        mvid = int(mfid.split(",")[0])
        mhome = env.volume_locations(mvid)[0]
        man = session().get(f"http://{mhome}/{mfid}",
                            params={"cm": "false"}, timeout=60).json()
        chunks = man["chunks"]
        if len(chunks) != -(-TOOLS_FILE_BYTES // piece):
            fail(f"the manifest lists {len(chunks)} chunks")
        by_vid: dict[int, int] = {}
        for c in chunks:
            vid_c = int(c["fid"].split(",")[0])
            by_vid[vid_c] = by_vid.get(vid_c, 0) + c["size"]
        dl = os.path.join(tmp, "download.bin")
        t0 = time.perf_counter()
        msg = _tools_cli(cli, ["download", "-master", murl, "-o", dl, mfid])
        walls["download"] = time.perf_counter() - t0
        if sha256(dl) != want:
            fail(f"download of {mfid} differs from the file ({msg})")
        os.remove(dl)
        log(f"[16a] upload -maxMB {TOOLS_CHUNK_MB} of {TOOLS_FILE_BYTES} B: "
            f"{walls['upload']:.3f} s, "
            f"{TOOLS_FILE_BYTES / walls['upload'] / 1e6:.1f} MB/s, manifest "
            f"{mfid} on {mhome}, {len(chunks)} chunks over volumes "
            f"{by_vid}; download {walls['download']:.3f} s, "
            f"{TOOLS_FILE_BYTES / walls['download'] / 1e6:.1f} MB/s, "
            f"sha256-equal")
        # three ranges across chunk boundaries, through the front
        spans = [(piece - 100, 200), (5 * piece - 1, (1 << 20) + 2),
                 (TOOLS_FILE_BYTES - 1000, 1000)]
        spec = "bytes=" + ",".join(f"{s}-{s + n - 1}" for s, n in spans)
        st0 = _get_json(f"http://{mhome}/status")["native_dataplane"]
        r = session().get(f"http://{mhome}/{mfid}", headers={"Range": spec},
                          timeout=120)
        ctype = r.headers.get("Content-Type", "")
        if r.status_code != 206 or \
                not ctype.startswith("multipart/byteranges; boundary="):
            fail(f"the 3-range GET answered {r.status_code} {ctype}")
        delim = b"--" + ctype.split("boundary=")[1].encode()
        parts = r.content.split(delim)[1:-1]
        with open(path, "rb") as f:
            for (s, n), raw in zip(spans, parts):
                head, _, body = raw[2:].partition(b"\r\n\r\n")
                f.seek(s)
                if body[:-2] != f.read(n) or \
                        f"bytes {s}-{s + n - 1}/{TOOLS_FILE_BYTES}".encode() \
                        not in head:
                    fail(f"the range {s}+{n} differs")
        if len(parts) != 3:
            fail(f"the 3-range GET gave {len(parts)} parts")
        st1 = _get_json(f"http://{mhome}/status")["native_dataplane"]
        if st1["proxied"] <= st0["proxied"]:
            fail(f"the front did not relay the manifest GET: {st0} {st1}")
        # one chunk through the paged path: a GET with a query string,
        # which the front relays to the Python app
        c0 = chunks[1]
        home = env.volume_locations(int(c0["fid"].split(",")[0]))[0]
        p0 = _tools_metrics(home)["paged"]
        t0 = time.perf_counter()
        r = session().get(f"http://{home}/{c0['fid']}",
                          params={"read": "paged"}, timeout=120)
        walls["paged"] = time.perf_counter() - t0
        with open(path, "rb") as f:
            f.seek(c0["offset"])
            if r.status_code != 200 or r.content != f.read(c0["size"]):
                fail(f"the paged GET of {c0['fid']}: {r.status_code}")
        if _tools_metrics(home)["paged"] != p0 + 1:
            fail("the chunk's GET did not take the paged read path")
        # a multipart/form-data upload through the front
        form = rng.bytes(TOOLS_FORM_BYTES)
        bnd = "smoke16" + rng.bytes(8).hex()
        body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\";"
                f" filename=\"form16.bin\"\r\nContent-Type: "
                f"application/x-smoke16\r\n\r\n").encode() + form + \
            f"\r\n--{bnd}--\r\n".encode()
        a = verbs.assign(murl, collection="smoke16f")
        r = session().post(f"http://{a.url}/{a.fid}", data=body, headers={
            "Content-Type": f"multipart/form-data; boundary={bnd}"},
            timeout=60)
        if r.status_code != 201 or r.json().get("name") != "form16.bin" or \
                r.json().get("size") != TOOLS_FORM_BYTES:
            fail(f"the form upload answered {r.status_code} {r.text[:200]}")
        g = session().get(f"http://{a.url}/{a.fid}", timeout=60)
        if g.content != form or \
                g.headers.get("Content-Type") != "application/x-smoke16":
            fail(f"the form upload read back {len(g.content)} B "
                 f"{g.headers.get('Content-Type')}")
        log(f"[16a] 3 ranges across chunk boundaries: 206 "
            f"multipart/byteranges relayed by the front, each part equal; "
            f"chunk {c0['fid']} ({c0['size']} B) through the paged path "
            f"in {walls['paged']:.3f} s, "
            f"{c0['size'] / walls['paged'] / 1e6:.1f} MB/s; a "
            f"{TOOLS_FORM_BYTES} B multipart/form-data POST stored as "
            f"form16.bin, application/x-smoke16, read back equal")

        # 16b. the benchmark command, both clients
        bench = {}
        for client, n in (("native", TOOLS_BENCH_NATIVE),
                          ("python", TOOLS_BENCH_PYTHON)):
            t0 = time.perf_counter()
            bench[client] = json.loads(_tools_cli(cli, [
                "benchmark", "-client", client, "-master", murl, "-n",
                str(n), "-size", "4096", "-c", str(TOOLS_THREADS)]))
            walls[f"bench {client}"] = time.perf_counter() - t0
            b = bench[client]
            if b["errors"]:
                fail(f"benchmark -client {client}: {b}")
            log(f"[16b] benchmark -client {client} -n {n} -size 4096 -c "
                f"{TOOLS_THREADS}: writes {b['write_rps']}/s p50 "
                f"{b['write_p50_ms']} ms p99 {b['write_p99_ms']} ms, reads "
                f"{b['read_rps']}/s p50 {b['read_p50_ms']} ms p99 "
                f"{b['read_p99_ms']} ms; {walls[f'bench {client}']:.3f} s")

        # 16c. incremental backup of V, then two seals that must agree
        vid = max(by_vid, key=by_vid.get)
        if by_vid[vid] < TOOLS_FILE_BYTES // 2:
            fail(f"volume {vid} holds {by_vid[vid]} B of the file")
        home = env.volume_locations(vid)[0]
        src = os.path.join(dirs[home], f"smoke16_{vid}")
        bdir = os.path.join(tmp, "backup")
        t0 = time.perf_counter()
        b1 = json.loads(_tools_cli(cli, [
            "backup", "-master", murl, "-volumeId", str(vid), "-dir", bdir,
            "-collection", "smoke16"]))
        walls["backup full"] = time.perf_counter() - t0
        if b1["mode"] != "full (new)":
            fail(f"the first backup: {b1}")
        s0 = _get_json(f"http://{home}/admin/volume_sync_status",
                       volume=vid)["tail_offset"]
        extra = {}
        for i in range(TOOLS_APPEND):
            key, cookie = (1 << 40) + i, int(rng.integers(1 << 32))
            extra[f"{vid},{key:x}{cookie:08x}"] = rng.bytes(1 << 20)

        def post(item):
            fid, data = item
            r = session().post(f"http://{home}/{fid}", data=data,
                               timeout=60)
            if r.status_code != 201:
                fail(f"POST {fid}: {r.status_code} {r.text[:200]}")

        _pool_map(post, list(extra.items()), threads=TOOLS_THREADS)
        s1 = _get_json(f"http://{home}/admin/volume_sync_status",
                       volume=vid)["tail_offset"]
        t0 = time.perf_counter()
        b2 = json.loads(_tools_cli(cli, [
            "backup", "-master", murl, "-volumeId", str(vid), "-dir", bdir,
            "-collection", "smoke16"]))
        walls["backup incremental"] = time.perf_counter() - t0
        pulled = b2["tail_offset"] - b1["tail_offset"]
        if b2["mode"] != "incremental" or \
                b2["records_applied"] != TOOLS_APPEND or \
                abs(pulled - (s1 - s0)) > 0.01 * (s1 - s0):
            fail(f"the incremental backup: {b2}, pulled {pulled} B of "
                 f"{s1 - s0} B appended")
        repl.run_command(env, "lock")
        repl.run_command(env, f"volume.mark -volumeId={vid} -readonly")
        _get_json(f"http://{home}/admin/volume_sync_status", volume=vid)
        dst = os.path.join(bdir, f"smoke16_{vid}")
        for ext in (".dat", ".idx"):
            if sha256(src + ext) != sha256(dst + ext):
                fail(f"the backup's {ext} differs from the source's")
        fixdir = os.path.join(tmp, "fix")
        os.makedirs(fixdir)
        shutil.copy(dst + ".dat", fixdir)
        _tools_cli(cli, ["fix", "-dir", fixdir, "-volumeId", str(vid),
                         "-collection", "smoke16"])
        if sha256(os.path.join(fixdir, f"smoke16_{vid}.idx")) != \
                sha256(src + ".idx"):
            fail("fix rebuilt another .idx than the source's")
        shutil.rmtree(fixdir)
        tar = os.path.join(tmp, "export.tar")
        t0 = time.perf_counter()
        ex = json.loads(_tools_cli(cli, [
            "export", "-dir", bdir, "-volumeId", str(vid), "-collection",
            "smoke16", "-o", tar]))
        walls["export"] = time.perf_counter() - t0
        names = {f"{os.path.basename(path)}-{i + 1}": c["fid"]
                 for i, c in enumerate(chunks)
                 if c["fid"].startswith(f"{vid},")}
        names.update({f"{t.parse_file_id(f)[1]:x}": f for f in extra})
        if mvid == vid:
            names[os.path.basename(path)] = mfid  # the manifest itself
        n_members = 0
        with tarfile.open(tar) as tf:
            for m in tf:
                name = m.name.split("/", 1)[1]
                got = tf.extractfile(m).read()
                if name.endswith(".gz") and name[:-3] in names:
                    # export names a gzipped needle .gz, bytes as stored
                    name, got = name[:-3], gzip.decompress(got)
                fid = names.get(name)
                r = session().get(f"http://{home}/{fid}", timeout=120,
                                  params={"cm": "false"} if fid == mfid
                                  else None) if fid else None
                if r is None or r.status_code != 200 or r.content != got:
                    fail(f"export member {m.name} is not needle {fid}")
                n_members += 1
        os.remove(tar)
        if n_members != len(names) or ex["files"] != len(names):
            fail(f"export wrote {n_members} members, {ex}; want "
                 f"{len(names)}")
        log(f"[16c] volume {vid} on {home}: {by_vid[vid]} B of the file; "
            f"backup full {walls['backup full']:.3f} s "
            f"({b1['tail_offset']} B), {TOOLS_APPEND} x 1 MiB added by "
            f"fid ({s1 - s0} B appended), backup incremental "
            f"{walls['backup incremental']:.3f} s pulling {pulled} B "
            f"({b2['records_applied']} records); read-only: .dat and .idx "
            f"sha256-equal to the source's; fix rebuilt the source's "
            f".idx; export {walls['export']:.3f} s, {n_members} members "
            f"each equal to its needle by fid")
        m0 = {u: _tools_metrics(u) for u in procs}
        t0 = time.perf_counter()
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        walls["ec.encode"] = time.perf_counter() - t0
        m1 = {u: _tools_metrics(u) for u in procs}
        launches["encode"] = sum(m1[u]["launches"] - m0[u]["launches"]
                                 for u in procs)
        enc_kernel_s = sum(m1[u]["kernel_s"] - m0[u]["kernel_s"]
                           for u in procs)
        want_enc = _encode_launches(os.path.getsize(dst + ".dat"))
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        with _KernelEvents() as ev:
            write_ec_files(dst, backend="cuda")
        walls["offline seal"] = time.perf_counter() - t0
        launches["offline seal"] = codec_cuda.coded_matmul.launches
        shard_home = {}
        for sid in range(14):
            hits = [u for u in procs if os.path.exists(
                os.path.join(dirs[u], f"smoke16_{vid}.ec{sid:02d}"))]
            if len(hits) != 1:
                fail(f"shard {sid} of volume {vid} on {hits}")
            shard_home[sid] = hits[0]
            if sha256(os.path.join(dirs[hits[0]], f"smoke16_{vid}.ec"
                                   f"{sid:02d}")) != \
                    sha256(f"{dst}.ec{sid:02d}"):
                fail(f"shard {sid}: the cluster's and the backup's differ")
        if launches["offline seal"] != want_enc or \
                (on_card and launches["encode"] != want_enc):
            fail(f"the seals made {launches['encode']} (ec.encode) and "
                 f"{launches['offline seal']} (offline) launches, not "
                 f"{want_enc} each")
        log(f"[16c] ec.encode of volume {vid}: {walls['ec.encode']:.3f} s, "
            f"{launches['encode']} launches, kernel stage "
            f"{enc_kernel_s * 1e3:.3f} ms (the volume process's CUDA "
            f"events); write_ec_files(backend='cuda') of the backup: "
            f"{walls['offline seal']:.3f} s, {launches['offline seal']} "
            f"launches, {ev.ms():.3f} ms CUDA events; all 14 shards "
            f"sha256-equal")

        # 16d. a lost server under the chunked file
        shards = env.master_get("/cluster/ec_shards", volumeId=vid)["shards"]
        held: dict[str, list[int]] = {u: [] for u in procs}
        for sid, urls in shards.items():
            for u in urls:
                held[u].append(int(sid))
        other_vids = ({int(c["fid"].split(",")[0]) for c in chunks} |
                      {mvid}) - {vid}
        others = {u for v in other_vids for u in env.volume_locations(v)}
        cands = [u for u in procs if u not in others and 0 < len(held[u])
                 <= 4]
        if not cands:
            fail(f"no server can be lost: shards {held}, other volumes of "
                 f"the file on {others}")
        victim = max(cands, key=lambda u: (sum(s < 10 for s in held[u]),
                                           -len(held[u]), u))
        lost = sorted(held[victim])
        procs[victim].kill()
        procs[victim].wait(timeout=30)
        _poll(lambda: len(env.data_nodes()) == TOOLS_SERVERS - 1, 30.0,
              f"the master dropped {victim}")
        live = [u for u in procs if u != victim]
        t0 = time.perf_counter()
        _tools_cli(cli, ["download", "-master", murl, "-o", dl, mfid])
        walls["degraded download"] = time.perf_counter() - t0
        if sha256(dl) != want:
            fail("the degraded download differs from the file")
        os.remove(dl)
        r0 = {u: _tools_metrics(u) for u in live}
        t0 = time.perf_counter()
        reb = repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        walls["ec.rebuild"] = time.perf_counter() - t0
        r1 = {u: _tools_metrics(u) for u in live}
        launches["rebuild"] = sum(r1[u]["launches"] - r0[u]["launches"]
                                  for u in live)
        shard_size = os.path.getsize(f"{dst}.ec00")
        want_reb = -(-shard_size // REBUILD_CHUNK)
        if reb.get("mode") != "partial" or sorted(reb["rebuilt"]) != lost \
                or (on_card and launches["rebuild"] != want_reb):
            fail(f"ec.rebuild: {reb}, {launches['rebuild']} launches; want "
                 f"partial, {lost}, {want_reb}")
        repl.run_command(env, "unlock")
        t0 = time.perf_counter()
        _tools_cli(cli, ["download", "-master", murl, "-o", dl, mfid])
        walls["download rebuilt"] = time.perf_counter() - t0
        if sha256(dl) != want:
            fail("the download after the rebuild differs from the file")
        os.remove(dl)
        log(f"[16d] killed {victim} (shards {lost} of volume {vid}, "
            f"{sum(s < 10 for s in lost)} data); degraded download "
            f"{walls['degraded download']:.3f} s, "
            f"{TOOLS_FILE_BYTES / walls['degraded download'] / 1e6:.1f} "
            f"MB/s, sha256-equal; ec.rebuild {walls['ec.rebuild']:.3f} s "
            f"({reb['mode']}, {reb['rebuilt']} on {reb['rebuilder']}), "
            f"{launches['rebuild']} launches (one per {REBUILD_CHUNK} B "
            f"of a {shard_size} B shard: {want_reb}); download "
            f"{walls['download rebuilt']:.3f} s, sha256-equal")

        # 16e. query and tail on one volume of JSON needles
        qhome = live[0]
        g = env.master_get("/vol/grow", collection="smoke16q", count=1,
                           dataNode=qhome)
        if g.get("count") != 1:
            fail(f"/vol/grow of smoke16q: {g}")
        qvid = next(int(v) for n in env.data_nodes() if n["url"] == qhome
                    for v, col in n.get("collections", {}).items()
                    if col == "smoke16q")
        docs = []
        for i in range(TOOLS_JSON_DOCS):
            d = {"a": int(rng.integers(-1000, 1000)),
                 "b": ["red", "green", "blue"][int(rng.integers(3))],
                 "c": round(float(rng.uniform(0, 100)), 3)}
            gz = rng.random() < 0.2
            if gz:
                d["note"] = "compressible " * 40  # gzip saves its 10%
            fid = f"{qvid},{i + 1:x}{int(rng.integers(1 << 32)):08x}"
            docs.append((fid, json.dumps(d).encode(), gz, d))

        def put_doc(item):
            fid, body, gz, _ = item
            r = session().post(f"http://{qhome}/{fid}", data=body, headers={
                "Content-Type": "application/json" if gz
                else "application/octet-stream"}, timeout=60)
            if r.status_code != 201:
                fail(f"POST {fid}: {r.status_code}")

        half = TOOLS_JSON_DOCS // 2
        t0 = time.perf_counter()
        _pool_map(put_doc, docs[:half], threads=TOOLS_THREADS)
        since = _get_json(f"http://{qhome}/admin/volume_sync_status",
                          volume=qvid)["last_append_at_ns"]
        _pool_map(put_doc, docs[half:], threads=TOOLS_THREADS)
        walls["json fill"] = time.perf_counter() - t0
        x = 50
        t0 = time.perf_counter()
        r = session().post(f"http://{qhome}/admin/query", json={
            "fids": [d[0] for d in docs], "selections": ["a", "b"],
            "filter": {"field": "c", "operand": ">", "value": str(x)}},
            timeout=120)
        walls["query"] = time.perf_counter() - t0
        plain = "".join(json.dumps({"a": d["a"], "b": d["b"]},
                                   separators=(",", ":")) + "\n"
                        for *_, d in docs if d["c"] > x).encode()
        if r.status_code != 200 or r.content != plain:
            fail(f"/admin/query: {r.status_code}, {len(r.content)} B; the "
                 f"plain filter gives {len(plain)} B")
        gz_fid = next(fid for fid, _, gz, _ in docs if gz)
        r = session().get(f"http://{qhome}/{gz_fid}",
                          headers={"Accept-Encoding": "gzip"}, timeout=30)
        if r.headers.get("Content-Encoding") != "gzip":
            fail(f"{gz_fid} (application/json) was not stored gzipped")
        t0 = time.perf_counter()
        r = session().get(f"http://{qhome}/admin/volume_tail", params={
            "volume": qvid, "since_ns": since, "idle_timeout": 0.5},
            timeout=60)
        walls["tail"] = time.perf_counter() - t0
        tail_keys = sorted(n.id for n in _tools_records(r.content))
        if r.status_code != 200 or tail_keys != list(
                range(half + 1, TOOLS_JSON_DOCS + 1)):
            fail(f"/admin/volume_tail since {since} gave {len(tail_keys)} "
                 f"records, not the {TOOLS_JSON_DOCS - half} written after")
        for u in live:
            page = session().get(f"http://{u}/ui/index.html", timeout=30)
            st = _get_json(f"http://{u}/status")
            ids = [v["id"] for v in st["volumes"]] + \
                [e["id"] for e in st["ec_shards"]]
            if page.status_code != 200 or not ids or any(
                    f"<tr><td>{i}</td>" not in page.text for i in ids):
                fail(f"{u}/ui/index.html does not list {ids}")
        n_gz = sum(1 for *_, gz, _ in docs if gz)
        n_rows = plain.count(b"\n")
        log(f"[16e] {TOOLS_JSON_DOCS} JSON needles ({n_gz} sent as "
            f"application/json, stored gzipped by the relayed path) on "
            f"volume {qvid} in {walls['json fill']:.3f} s; /admin/query "
            f"SELECT a, b WHERE c > {x}: {walls['query']:.3f} s, "
            f"{n_rows} rows byte-equal to a plain filter; "
            f"/admin/volume_tail since the half-way stamp: "
            f"{len(tail_keys)} records, exactly those written after, "
            f"{walls['tail']:.3f} s (0.5 s idle end); /ui/index.html of "
            f"each live server lists its volumes")

        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 16 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[16] phase 16 took {time.perf_counter() - t_phase:.3f} s; "
            f"walls {({k: round(v, 3) for k, v in walls.items()})}; "
            f"kernel launches {launches}; {card}")
        return launches
    except BaseException:
        for url, lp in logs.items():
            print(f"--- {url} log tail ---\n{_tail(lp)}", file=sys.stderr)
        raise
    finally:
        if env is not None:
            env.close()
        for p_ in procs.values():
            if p_.poll() is None:
                p_.terminate()
        for p_ in procs.values():
            try:
                p_.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p_.kill()
                p_.wait(timeout=15)
        if master is not None:
            master.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 17: a cloud bucket mounted under the filer, read through,
# cached, sealed through the kernel, rebuilt, uncached, written back
# ----------------------------------------------------------------------
REMOTE_BUCKET = "cloud17"
REMOTE_MOUNT = "/mnt/cloud17"
REMOTE_LARGE = ((4, 64 << 20), (48, 16 << 20))  # (count, bytes): 1 GiB
REMOTE_SMALL = 256                # 1-64 KiB, log-uniform
REMOTE_PREFIXES = 8               # the small objects' prefixes
REMOTE_SMALL_LO, REMOTE_SMALL_HI = 1 << 10, 64 << 10
REMOTE_THROUGH_SMALL = 256        # 17b's small read-throughs
REMOTE_DEGRADED_SMALL = 128       # 17e's small degraded reads
REMOTE_WRITES = 64                # 17g: 1 KiB-4 MiB, log-uniform
REMOTE_WRITE_LO, REMOTE_WRITE_HI = 1 << 10, 4 << 20
REMOTE_DELETES, REMOTE_RENAMES = 16, 8
REMOTE_GATEWAY_OBJECTS = 16       # 17h
REMOTE_THREADS = 8
REMOTE_DEADLINE = 60.0            # longest wait for a worker's mirror


def _remote_objects() -> list[tuple[str, int]]:
    """(key, size) of the cloud bucket's objects, in a fixed order."""
    out = []
    for kind, (n, size) in zip(("big", "mid"), REMOTE_LARGE):
        out += [(f"{kind}/obj-{i:02d}.bin", size) for i in range(n)]
    rng = np.random.default_rng([SEED, 17, 0])
    sizes = np.exp(rng.uniform(np.log(REMOTE_SMALL_LO),
                               np.log(REMOTE_SMALL_HI), REMOTE_SMALL))
    out += [(f"p{j % REMOTE_PREFIXES}/s-{j:04d}.bin", int(sz))
            for j, sz in enumerate(sizes)]
    return out


def _remote_bytes(key: str, size: int) -> bytes:
    """An object's bytes, regenerated from the seed on demand."""
    digest = hashlib.sha256(key.encode()).digest()
    return np.random.default_rng(
        [SEED, 17, int.from_bytes(digest[:4], "big")]).bytes(size)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _filer_get(filer: str, path: str, headers: dict | None = None):
    from seaweedfs_tpu_torch.rpc.httpclient import session

    return session().get(f"{filer}{path}", headers=headers or {},
                         timeout=(5.0, 600.0))


def _remote_read(filer: str, items: list[tuple[str, int]], want: dict,
               label: str, threads: int = REMOTE_THREADS) -> dict:
    """GET every (key, size) under the mount through the filer and hold
    each body's sha256 against the cloud's. -> MB/s and latencies."""
    def one(item):
        key, size = item
        t0 = time.perf_counter()
        r = _filer_get(filer, f"{REMOTE_MOUNT}/{key}")
        dt = time.perf_counter() - t0
        if r.status_code != 200 or len(r.content) != size or \
                _sha(r.content) != want[key]:
            fail(f"{label}: GET {key} answered {r.status_code}, "
                 f"{len(r.content)} B, sha256 off the cloud's")
        return dt, size

    t0 = time.perf_counter()
    got = _pool_map(one, items, threads=threads)
    wall = time.perf_counter() - t0
    nbytes = sum(n for _, n in got)
    return {"wall": wall, "bytes": nbytes, "mbps": nbytes / wall / 1e6,
            "lat": [dt for dt, _ in got]}


def _entries(env) -> dict[str, dict]:
    """Every file entry under the mount, by key (the shell's walk)."""
    from seaweedfs_tpu_torch.shell.commands_fs import _is_dir, _walk

    return {e["full_path"][len(REMOTE_MOUNT) + 1:]: e
            for e in _walk(env, REMOTE_MOUNT) if not _is_dir(e)}


def _s3_puts() -> float:
    """The cloud gateway's answered PUTs so far (this process's only S3
    gateway in phase 17)."""
    from seaweedfs_tpu_torch.utils import metrics

    return metrics.counter_value("s3_requests_total",
                                 {"method": "PUT", "code": "200"})


def phase_remote(card: str) -> dict:
    """Phase 17: a 1 GiB S3 bucket mounted under the filer, read
    through, cached, sealed through the kernel, read degraded and
    rebuilt, uncached, written back by filer.remote.sync and mirrored
    by filer.remote.gateway. -> kernel launches by step."""
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.remote_storage.mount import load_conf
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.s3.client import S3Client
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke17-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    cloud = cluster = env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    try:
        # set-up: the cloud, a port cluster of its own behind its S3
        # gateway, and the main cluster
        t0 = time.perf_counter()
        cloud = Cluster(os.path.join(tmp, "cloud"), n_volume_servers=1,
                        max_volumes=16, volume_size_limit=DAT_BYTES,
                        pulse_seconds=HEAL_PULSE, ec_backend="native",
                        with_filer=True, filer_store="sqlite",
                        with_s3=True, s3_config=S3_CONFIG)
        cluster = Cluster(os.path.join(tmp, "main"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=DAT_BYTES,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                          with_filer=True, filer_store="sqlite")
        filer = cluster.filer_url
        env = CommandEnv(cluster.master_url, filer_url=filer)
        conf = {"endpoint": cloud.s3_url, "bucket": REMOTE_BUCKET,
                "access_key": S3_KEY, "secret_key": S3_SECRET}
        bucket = S3Client(**conf)
        s3 = _S3Client(cloud.s3_url)
        r = s3("PUT", f"/{REMOTE_BUCKET}")
        if r.status_code != 200:
            fail(f"CreateBucket {REMOTE_BUCKET}: {r.status_code} {r.text}")
        objects = _remote_objects()
        sizes = dict(objects)
        want: dict[str, str] = {}

        def put(item):
            key, size = item
            data = _remote_bytes(key, size)
            want[key] = _sha(data)
            bucket.put_object(key, data)
            return size

        cloud_bytes = sum(_pool_map(put, objects, threads=4))
        walls["setup"] = time.perf_counter() - t0
        n_large = sum(n for n, _ in REMOTE_LARGE)
        log(f"[17] {card}; cloud: port cluster, s3 {cloud.s3_url}, bucket "
            f"{REMOTE_BUCKET!r}: {len(objects)} objects ({n_large} large: "
            f"{REMOTE_LARGE}, {REMOTE_SMALL} of {REMOTE_SMALL_LO}-"
            f"{REMOTE_SMALL_HI} B under {REMOTE_PREFIXES} prefixes), "
            f"{cloud_bytes} B; main: master {cluster.master_url}, 4 volume "
            f"servers ec_backend='cuda', volume limit {DAT_BYTES} B, sqlite "
            f"filer {filer}; set-up {walls['setup']:.3f} s")

        # 17a. configure, mount, meta.sync
        t0 = time.perf_counter()
        repl.run_command(env, "lock")
        out = repl.run_command(
            env, f"remote.configure -name=cloud -type=s3 "
                 f"-endpoint={cloud.s3_url} -bucket={REMOTE_BUCKET} "
                 f"-access_key={S3_KEY} -secret_key={S3_SECRET}")
        if out != {"cloud": "s3"}:
            fail(f"remote.configure answered {out}")
        out = repl.run_command(env, f"remote.mount -dir={REMOTE_MOUNT} "
                                    f"-remote=cloud")
        t_mount = time.perf_counter() - t0
        if out.get("created") != len(objects):
            fail(f"remote.mount created {out}, wanted {len(objects)}")
        t1 = time.perf_counter()
        again = repl.run_command(env,
                                 f"remote.meta.sync -dir={REMOTE_MOUNT}")
        t_sync = time.perf_counter() - t1
        if again != {"created": 0, "updated": 0, "removed": 0}:
            fail(f"a second remote.meta.sync changed {again}")
        du = repl.run_command(env, f"fs.du {REMOTE_MOUNT}")
        ls = repl.run_command(env, f"fs.ls {REMOTE_MOUNT}")
        prefixes = sorted({k.split("/")[0] + "/" for k, _ in objects})
        if du["files"] != len(objects) or du["bytes"] != 0 or \
                sorted(ls) != prefixes:
            fail(f"fs.du {du} / fs.ls {ls}: wanted {len(objects)} files "
                 f"(placeholders: 0 B local) under {prefixes}")
        entries = _entries(env)
        remote_sizes = {k: json.loads(e["extended"]["remote"])["size"]
                        for k, e in entries.items()}
        if remote_sizes != sizes or any(e.get("chunks")
                                        for e in entries.values()):
            fail("the mount's entries are not the cloud's placeholders")
        walls["a"] = time.perf_counter() - t0
        log(f"[17a] remote.configure + remote.mount (its meta.sync "
            f"included) {t_mount:.3f} s: {len(objects)} entries, "
            f"{len(objects) / t_mount:.1f} entries/s; a second "
            f"remote.meta.sync {t_sync:.3f} s changed nothing; fs.du "
            f"{du}; fs.ls {ls}; the placeholders' remote sizes sum to "
            f"the cloud's {cloud_bytes} B")

        # the workers, as processes of the CLI
        for name, args in (
                ("sync", ["filer.remote.sync", "-filer", filer, "-dir",
                          REMOTE_MOUNT]),
                ("gateway", ["filer.remote.gateway", "-filer", filer,
                             "-createBucketAt", "cloud"])):
            logs[name] = os.path.join(tmp, f"{name}.log")
            procs[name] = _spawn(args, logs[name])

        # 17b. read-through of uncached entries
        rng = np.random.default_rng([SEED, 17, 1])
        small = [o for o in objects if o[0].startswith("p")]
        large = [o for o in objects if o[0].startswith("big/")]
        sample = [small[int(i)] for i in rng.choice(
            len(small), REMOTE_THROUGH_SMALL, replace=False)]
        big = _remote_read(filer, large, want, "17b", threads=4)
        tiny = _remote_read(filer, sample, want, "17b")
        for key, size in large:
            a = int(rng.integers(0, size - 1))
            b = min(size - 1, a + int(rng.integers(1, 24 << 20)))
            r = _filer_get(filer, f"{REMOTE_MOUNT}/{key}",
                           {"Range": f"bytes={a}-{b}"})
            if r.status_code != 206 or r.content != \
                    _remote_bytes(key, size)[a:b + 1]:
                fail(f"17b: Range bytes={a}-{b} of {key}: "
                     f"{r.status_code}")
        walls["b"] = big["wall"] + tiny["wall"]
        log(f"[17b] read-through (uncached): the {len(large)} large "
            f"entries {big['wall']:.3f} s, {big['mbps']:.1f} MB/s; "
            f"{len(sample)} small ones {tiny['wall']:.3f} s, "
            f"{tiny['mbps']:.2f} MB/s, {_lat(tiny['lat'])}; one ranged "
            f"GET per large entry equal; every sha256 equal")

        # 17c. remote.cache
        t0 = time.perf_counter()
        out = repl.run_command(env, f"remote.cache -dir={REMOTE_MOUNT}")
        t_cache = time.perf_counter() - t0
        if out != {"cached": len(objects)}:
            fail(f"remote.cache answered {out}")
        entries = _entries(env)
        du = repl.run_command(env, f"fs.du {REMOTE_MOUNT}")
        if any(not e.get("chunks") for e in entries.values()) or \
                du["bytes"] != cloud_bytes:
            fail(f"after remote.cache: fs.du {du}, or an entry without "
                 "chunks")
        cached = _remote_read(filer, objects, want, "17c")
        walls["c"] = t_cache + cached["wall"]
        log(f"[17c] remote.cache of {len(objects)} entries "
            f"{t_cache:.3f} s, {cloud_bytes / t_cache / 1e6:.1f} MB/s; "
            f"the whole tree read back cached ({REMOTE_THREADS} threads) "
            f"{cached['wall']:.3f} s, {cached['mbps']:.1f} MB/s; every "
            f"entry has chunks (fs.du {du['bytes']} B), every sha256 "
            f"equal")

        # 17d. seal every volume holding the cached chunks
        vids = sorted({int(c["fid"].split(",")[0])
                       for e in entries.values() for c in e["chunks"]})
        listed = {v["volume"] for v in repl.run_command(env, "volume.list")
                  if v.get("server")}
        if not set(vids) <= listed:
            fail(f"volume.list {sorted(listed)} lacks {vids}")
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        dat = {}
        for vid in vids:
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat[vid] = v.content_size()
        before = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        walls["d"] = time.perf_counter() - t0
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before["kernel"]
        own = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if scraped != launches["encode"]:
            fail(f"the volume servers' cuda_kernel_launches {scraped}, "
                 f"the wrapper's count {launches['encode']}")
        log(f"[17d] ec.encode of {len(vids)} volumes ({dat} .dat bytes) "
            f"{walls['d']:.3f} s, {launches['encode']} launches (their "
            f"sizes give {own}; /metrics cuda_kernel_launches {scraped}); {stages_since(before, walls['d'])}; "
            f"kernel {kernel_s * 1e3:.3f} ms, "
            f"{kernel_s * 1e3 / max(1, launches['encode']):.3f} ms per "
            f"launch")
        if launches["encode"] <= 0 or launches["encode"] != own:
            fail(f"{launches['encode']} launches during ec.encode, the "
                 f"sizes give {own}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))

        # 17e. lose the server holding the most shards of the largest
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"{victim} holds more than m=4 shards of a volume: {lost}")
        t0 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t0
        dsample = large + [small[int(i)] for i in rng.choice(
            len(small), REMOTE_DEGRADED_SMALL, replace=False)]
        degraded = _remote_read(filer, dsample, want, "17e degraded")
        codec_cuda.coded_matmul.launches = 0
        t0 = time.perf_counter()
        rebuilt = {}
        for vid in vids:
            if lost[vid]:
                rebuilt[vid] = repl.run_command(
                    env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t0
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped != launches["rebuild"]:
            fail(f"ec.rebuild: {launches['rebuild']} launches, the volume "
                 f"servers' cuda_kernel_launches {scraped}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        healed = _remote_read(filer, dsample, want, "17e rebuilt")
        walls["e"] = t_gone + degraded["wall"] + t_rebuild + healed["wall"]
        log(f"[17e] stopped {victim} (shards {lost}); the master dropped "
            f"them in {t_gone:.3f} s; {len(dsample)} entries read "
            f"degraded {degraded['wall']:.3f} s, {degraded['mbps']:.1f} "
            f"MB/s, {_lat(degraded['lat'])}; ec.rebuild {t_rebuild:.3f} "
            f"s, {launches['rebuild']} launches; read again after the "
            f"rebuild {healed['wall']:.3f} s, {healed['mbps']:.1f} MB/s; "
            f"every sha256 equal")

        # 17f. uncache the 16 MiB entries
        mids = [o for o in objects if o[0].startswith("mid/")]
        t0 = time.perf_counter()
        out = repl.run_command(env, f"remote.uncache -dir={REMOTE_MOUNT}"
                                    f"/mid")
        t_uncache = time.perf_counter() - t0
        if out != {"uncached": len(mids)}:
            fail(f"remote.uncache answered {out}")
        entries = _entries(env)
        if any(entries[k].get("chunks") for k, _ in mids) or any(
                not entries[k].get("chunks") for k, _ in large):
            fail("remote.uncache left chunks or took others'")
        through = _remote_read(filer, mids, want, "17f")
        walls["f"] = t_uncache + through["wall"]
        log(f"[17f] remote.uncache of the {len(mids)} entries of "
            f"{REMOTE_LARGE[1][1]} B "
            f"{t_uncache:.3f} s; read through again {through['wall']:.3f}"
            f" s, {through['mbps']:.1f} MB/s, every sha256 equal")

        # 17g. writes under the mount pushed back by filer.remote.sync;
        # first the worker catches up with the history it replays from
        # the filer's start (17a's placeholders, 17c's and 17f's
        # updates: no PUT for any), so the lag below is the steady one
        offset_key = f"remote.sync/{REMOTE_MOUNT.strip('/')}/offset"
        history = cluster.filer.filer.meta_log.replay(0, REMOTE_MOUNT)

        def caught_up():
            r = session().get(f"{filer}/kv/{offset_key}", timeout=30)
            return r.status_code == 200 and \
                int(r.content) >= history[-1]["ts_ns"]

        t0 = time.perf_counter()
        _poll(caught_up, 4 * REMOTE_DEADLINE,
              "filer.remote.sync through the mount's history")
        t_catch = time.perf_counter() - t0
        log(f"[17g] filer.remote.sync (started after 17a) through the "
            f"mount's {len(history)} events of history {t_catch:.3f} s "
            f"after 17f")
        rng = np.random.default_rng([SEED, 17, 2])
        wsizes = np.exp(rng.uniform(np.log(REMOTE_WRITE_LO),
                                    np.log(REMOTE_WRITE_HI), REMOTE_WRITES))
        writes = {f"new17/w-{i:02d}.bin": rng.bytes(int(n))
                  for i, n in enumerate(wsizes)}
        acked: dict[str, float] = {}
        landed: dict[str, float] = {}
        in_bucket = f"/buckets/{REMOTE_BUCKET}/"

        def on_cloud_event(ev):  # the cloud filer's create, as it lands
            ent = ev["new_entry"]
            if ent and ent["full_path"].startswith(in_bucket):
                landed.setdefault(ent["full_path"][len(in_bucket):],
                                  time.perf_counter())

        cloud.filer.filer.meta_log.sync_listeners.append(on_cloud_event)
        puts0 = _s3_puts()
        t0 = time.perf_counter()
        for key, data in writes.items():
            r = session().post(f"{filer}{REMOTE_MOUNT}/{key}", data=data,
                               timeout=60)
            if r.status_code != 201:
                fail(f"17g: write {key} answered {r.status_code}")
            acked[key] = time.perf_counter()
        _poll(lambda: all(k in landed for k in writes), REMOTE_DEADLINE,
              "every write in the cloud")
        cloud.filer.filer.meta_log.sync_listeners.remove(on_cloud_event)
        for key, data in writes.items():
            if _sha(bucket.get_object(key)) != _sha(data):
                fail(f"17g: the cloud's {key} differs from the write")

        def refreshed(key):
            e = session().get(f"{filer}{REMOTE_MOUNT}/{key}",
                              params={"meta": "1"}, timeout=30).json()
            meta = json.loads(e.get("extended", {}).get("remote", "{}"))
            return meta.get("etag") and meta["etag"] == e.get("md5")

        _poll(lambda: all(refreshed(k) for k in writes), REMOTE_DEADLINE,
              "the worker's metadata refresh of every write")
        time.sleep(1.0)                 # a looping worker would PUT again
        puts = _s3_puts() - puts0
        t_writes = time.perf_counter() - t0
        lag = [landed[k] - acked[k] for k in writes]
        log(f"[17g] {len(writes)} writes of {REMOTE_WRITE_LO}-"
            f"{REMOTE_WRITE_HI} B ({sum(map(len, writes.values()))} B) "
            f"through the filer, each in the cloud sha256-equal: lag from "
            f"the 201 {_lat(lag)}; cloud PUTs {puts:.0f} (one per write)")
        if puts != len(writes):
            fail(f"{puts} cloud PUTs for {len(writes)} writes: the loop "
                 "guard failed")
        keys = list(writes)
        gone = keys[:REMOTE_DELETES]
        moved = keys[REMOTE_DELETES:REMOTE_DELETES + REMOTE_RENAMES]
        puts0 = _s3_puts()
        t1 = time.perf_counter()
        for key in gone:
            r = session().delete(f"{filer}{REMOTE_MOUNT}/{key}", timeout=60)
            if r.status_code >= 300:
                fail(f"17g: delete {key} answered {r.status_code}")
        for key in moved:
            r = session().put(f"{filer}{REMOTE_MOUNT}/{key}.moved",
                              params={"mv.from": f"{REMOTE_MOUNT}/{key}"},
                              timeout=60)
            if r.status_code >= 300:
                fail(f"17g: rename {key} answered {r.status_code}")
        _poll(lambda: all(bucket.head_object(k) is None
                          for k in gone + moved) and all(
            bucket.head_object(k + ".moved") is not None for k in moved),
            REMOTE_DEADLINE, "the deletes and renames in the cloud")
        for key in moved:
            if _sha(bucket.get_object(key + ".moved")) != _sha(writes[key]):
                fail(f"17g: the renamed {key} differs in the cloud")
        time.sleep(1.0)
        rputs = _s3_puts() - puts0
        walls["g"] = t_catch + t_writes + time.perf_counter() - t1
        log(f"[17g] {len(gone)} deletes and {len(moved)} renames mirrored "
            f"in {time.perf_counter() - t1:.3f} s; cloud PUTs meanwhile "
            f"{rputs:.0f} (one per rename)")
        if rputs != len(moved):
            fail(f"{rputs} cloud PUTs for {len(moved)} renames")

        # 17h. filer.remote.gateway: a bucket's life mirrored
        t0 = time.perf_counter()
        repl.run_command(env, "s3.bucket.create -name=b17")
        _poll(lambda: "/buckets/b17" in load_conf(filer).mounts,
              REMOTE_DEADLINE, "the gateway's mount of /buckets/b17")
        m = load_conf(filer).mounts["/buckets/b17"]
        if (m.storage, m.remote_path) != ("cloud", "b17"):
            fail(f"/buckets/b17 mounted on {m}")
        t_create = time.perf_counter() - t0
        rng = np.random.default_rng([SEED, 17, 3])
        gobjs = {f"g-{i:02d}.bin": rng.bytes(int(rng.integers(1, 256 << 10)))
                 for i in range(REMOTE_GATEWAY_OBJECTS)}
        for name, data in gobjs.items():
            r = session().post(f"{filer}/buckets/b17/{name}", data=data,
                               timeout=60)
            if r.status_code != 201:
                fail(f"17h: write {name} answered {r.status_code}")
        _poll(lambda: all(bucket.head_object(f"b17/{n}") is not None
                          for n in gobjs), REMOTE_DEADLINE,
              "the bucket's objects in the cloud")
        for name, data in gobjs.items():
            if bucket.get_object(f"b17/{name}") != data:
                fail(f"17h: the cloud's b17/{name} differs")
        t_objects = time.perf_counter() - t0 - t_create
        t1 = time.perf_counter()
        repl.run_command(env,
                         "s3.bucket.delete -name=b17 -includeObjects=true")
        _poll(lambda: "/buckets/b17" not in load_conf(filer).mounts and
              not list(bucket.list_objects("b17/")), REMOTE_DEADLINE,
              "the bucket's mapping and objects gone")
        t_delete = time.perf_counter() - t1
        walls["h"] = time.perf_counter() - t0
        repl.run_command(env, "unlock")
        log(f"[17h] s3.bucket.create b17 -> mounted on cloud/b17 in "
            f"{t_create:.3f} s; {len(gobjs)} objects mirrored equal in "
            f"{t_objects:.3f} s; s3.bucket.delete -includeObjects=true -> "
            f"mapping and objects gone in {t_delete:.3f} s")
        for name, proc in procs.items():
            if proc.poll() is not None:
                fail(f"the {name} worker exited: {_tail(logs[name])}")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 17 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[17] phase 17 took {wall:.3f} s ({ {k: round(v, 3) for k, v in walls.items()} }); "
            f"kernel launches {launches}; the seal's kernel time "
            f"{kernel_s:.3f} s is {busy:.2%} of the phase wall (idle "
            f"share {1 - busy:.2%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 4)
        return launches
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if env is not None:
            env.close()
        for c in (cluster, cloud):
            if c is not None:
                c.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 18: two clusters kept in sync by filer.sync, backed up by
# filer.backup and filer.meta.backup, mirrored into S3, notified; the
# second cluster's mirror sealed and rebuilt through the kernel
# ----------------------------------------------------------------------
SYNC_ROOT = "/dc"
SYNC_BUCKET = "repl18"
# 8, not 14: cut to make room for phase 19 in the 1200 s limit
SYNC_BIG = (8, 16 << 20)          # (count, bytes) under /dc/big
SYNC_SMALL = 512                  # 1-64 KiB, log-uniform
SYNC_PREFIXES = 8                 # the small files' directories
SYNC_SMALL_LO, SYNC_SMALL_HI = 1 << 10, 64 << 10
SYNC_LAG_WRITES = 64              # 18b, each way: 1 KiB-4 MiB
SYNC_LAG_LO, SYNC_LAG_HI = 1 << 10, 4 << 20
SYNC_SPACING = 0.1                # seconds between 18b's writes
SYNC_QUIET = 5.0                  # 18b's quiet before the event count
SYNC_DELETES, SYNC_RENAMES = 16, 8
SYNC_RESUME = 16                  # 18f's writes while the workers are down
SYNC_VOLUME_LIMIT = 256 << 20     # the clusters' volume size limit
SYNC_THREADS = 8
SYNC_DEADLINE = 120.0             # longest wait for a worker's mirror


def _sync_files() -> list[tuple[str, int]]:
    """(path, size) of 18a's tree, in a fixed order."""
    n, size = SYNC_BIG
    out = [(f"{SYNC_ROOT}/big/f-{i:02d}.bin", size) for i in range(n)]
    rng = np.random.default_rng([SEED, 18])
    sizes = np.exp(rng.uniform(np.log(SYNC_SMALL_LO), np.log(SYNC_SMALL_HI),
                               SYNC_SMALL))
    out += [(f"{SYNC_ROOT}/small/p{j % SYNC_PREFIXES}/s-{j:04d}.bin",
             int(sz)) for j, sz in enumerate(sizes)]
    return out


def _sync_bytes(path: str, size: int) -> bytes:
    """A file's bytes, regenerated from the seed on demand."""
    digest = hashlib.sha256(path.encode()).digest()
    return np.random.default_rng(
        [SEED, 18, int.from_bytes(digest[:4], "big")]).bytes(size)


def _sync_writes(tag: str, n: int, stream: int) -> dict[str, bytes]:
    rng = np.random.default_rng([SEED, 18, stream])
    sizes = np.exp(rng.uniform(np.log(SYNC_LAG_LO), np.log(SYNC_LAG_HI), n))
    return {f"{SYNC_ROOT}/{tag}-{i:02d}.bin": rng.bytes(int(s))
            for i, s in enumerate(sizes)}


class _Landed:
    """A filer's create events as they land (its log's sync listener):
    path -> perf_counter() of the first create."""

    def __init__(self, filer):
        self.log = filer.meta_log
        self.at: dict[str, float] = {}
        self.log.sync_listeners.append(self)

    def __call__(self, ev: dict) -> None:
        ent = ev["new_entry"]
        if ent is not None and ev["old_entry"] is None:
            self.at.setdefault(ent["full_path"], time.perf_counter())

    def close(self) -> None:
        if self in self.log.sync_listeners:
            self.log.sync_listeners.remove(self)


def _events_by_path(filer, prefix: str) -> dict[str, list[dict]]:
    out: dict[str, list[dict]] = {}
    for ev in filer.meta_log.replay(0, prefix):
        ent = ev["new_entry"] or ev["old_entry"]
        out.setdefault(ent["full_path"], []).append(ev)
    return out


def _check_files(filer: str, files: dict[str, str], label: str,
                 threads: int = SYNC_THREADS) -> dict:
    """GET every path from a filer, each sha256 against `files`.
    -> wall, bytes, MB/s."""
    def one(path):
        r = _filer_get(filer, path)
        if r.status_code != 200 or _sha(r.content) != files[path]:
            fail(f"{label}: GET {filer}{path} answered {r.status_code}, "
                 f"{len(r.content)} B, sha256 off the source's")
        return len(r.content)

    t0 = time.perf_counter()
    nbytes = sum(_pool_map(one, sorted(files), threads=threads))
    wall = time.perf_counter() - t0
    return {"wall": wall, "bytes": nbytes, "mbps": nbytes / wall / 1e6}


def _spaced_writes(filer: str, writes: dict[str, bytes], label: str
                   ) -> dict[str, float]:
    """POST each write SYNC_SPACING apart. -> path -> time of its 201."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    acked = {}
    for path, data in writes.items():
        t0 = time.perf_counter()
        r = session().post(f"{filer}{path}", data=data, timeout=60)
        if r.status_code != 201:
            fail(f"{label}: write {path} answered {r.status_code}")
        acked[path] = time.perf_counter()
        time.sleep(max(0.0, t0 + SYNC_SPACING - acked[path]))
    return acked


def phase_sync(card: str) -> dict:
    """Phase 18: cluster A (dc1) kept in sync with cluster B (dc2) by
    filer.sync, backed up by filer.backup (a directory) and
    FilerMetaBackup (sqlite), its small files mirrored into B's S3
    gateway, its events published to a log queue; B's mirror sealed,
    read degraded and rebuilt through the kernel; filer.sync resumed
    from its offset. -> kernel launches by step, the lags."""
    from seaweedfs_tpu_torch.filer.entry import entry_size
    from seaweedfs_tpu_torch.notification import LogFileQueue, attach_notifier
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.replication import Replicator, make_sink
    from seaweedfs_tpu_torch.replication.meta_backup import FilerMetaBackup
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.commands_fs import _is_dir, _list, _walk
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke18-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    a = b = env_a = env_b = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    workers: list = []
    landed: list[_Landed] = []
    queue = pump = None
    try:
        # set-up: two clusters, the workers, the notifier
        t0 = time.perf_counter()
        a = Cluster(os.path.join(tmp, "dc1"), n_volume_servers=3,
                    max_volumes=8, volume_size_limit=SYNC_VOLUME_LIMIT,
                    pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                    topology=[("dc1", f"r{i}") for i in range(3)],
                    with_filer=True, filer_store="sqlite")
        b = Cluster(os.path.join(tmp, "dc2"), n_volume_servers=4,
                    max_volumes=8, volume_size_limit=SYNC_VOLUME_LIMIT,
                    pulse_seconds=HEAL_PULSE, ec_backend="cuda",
                    topology=[("dc2", f"r{i}") for i in range(4)],
                    with_filer=True, filer_store="sqlite", with_s3=True)
        fa, fb = a.filer_url, b.filer_url
        env_a = CommandEnv(a.master_url, filer_url=fa)
        env_b = CommandEnv(b.master_url, filer_url=fb)
        sig = {name: session().get(f"{f}/status", timeout=30).json()[
            "signature"] for name, f in (("a", fa), ("b", fb))}
        r = session().put(f"{b.s3_url}/{SYNC_BUCKET}", timeout=30)
        if r.status_code != 200:
            fail(f"CreateBucket {SYNC_BUCKET}: {r.status_code} {r.text}")
        backup_dir = os.path.join(tmp, "backup")
        events_path = os.path.join(tmp, "events.jsonl")
        queue = LogFileQueue(events_path)
        pump = attach_notifier(a.filer.filer, queue, SYNC_ROOT)
        meta = FilerMetaBackup(fa, os.path.join(tmp, "meta.db"), SYNC_ROOT)
        mirror = Replicator(fa, make_sink("s3", endpoint=b.s3_url,
                                          bucket=SYNC_BUCKET),
                            path_prefix=f"{SYNC_ROOT}/small")
        for w in (meta, mirror):
            w.start()
            workers.append(w)
        sync_args = ["filer.sync", "-a", fa, "-b", fb, "-path", SYNC_ROOT]
        for name, args in (("sync", sync_args),
                           ("backup", ["filer.backup", "-filer", fa,
                                       "-path", SYNC_ROOT, "-dir",
                                       backup_dir])):
            logs[name] = os.path.join(tmp, f"{name}.log")
            procs[name] = _spawn(args, logs[name])
        # every stream open: A's for the sync, the backup, the meta
        # backup and the S3 mirror; B's for the sync back
        end = time.monotonic() + SYNC_DEADLINE
        while len(a.filer._subscribers) < 4 or \
                len(b.filer._subscribers) < 1:
            if time.monotonic() > end or any(
                    p.poll() is not None for p in procs.values()):
                fail(f"the workers' streams: dc1 has "
                     f"{len(a.filer._subscribers)} of 4, dc2 "
                     f"{len(b.filer._subscribers)} of 1; " + "; ".join(
                         f"{n} (exit {p.poll()}): {_tail(logs[n], 800)!r}"
                         for n, p in procs.items()))
            time.sleep(0.05)
        walls["setup"] = time.perf_counter() - t0
        files = _sync_files()
        n_big = SYNC_BIG[0]
        log(f"[18] {card}; dc1: master {a.master_url}, 3 volume servers, "
            f"sqlite filer {fa} (signature {sig['a']}); dc2: master "
            f"{b.master_url}, 4 volume servers, sqlite filer {fb} "
            f"(signature {sig['b']}), s3 {b.s3_url}; both ec_backend="
            f"'cuda', volume limit {SYNC_VOLUME_LIMIT} B; `filer.sync -a "
            f"dc1 -b dc2 -path {SYNC_ROOT}` and `filer.backup -path "
            f"{SYNC_ROOT}` as CLI processes; FilerMetaBackup, a Replicator "
            f"into s3://{SYNC_BUCKET} and a log-queue notifier in process "
            f"(streams open: dc1 {len(a.filer._subscribers)}, dc2 "
            f"{len(b.filer._subscribers)}); set-up {walls['setup']:.3f} s")

        # 18a. the mirror of a tree written on A
        landed_b, landed_a = _Landed(b.filer.filer), _Landed(a.filer.filer)
        landed += [landed_b, landed_a]
        want: dict[str, str] = {}
        md5: dict[str, str] = {}

        def put(item):
            path, size = item
            data = _sync_bytes(path, size)
            want[path] = _sha(data)
            md5[path] = hashlib.md5(data).hexdigest()
            r = session().post(f"{fa}{path}", data=data, timeout=120)
            if r.status_code != 201:
                fail(f"18a: write {path} answered {r.status_code}")
            return size

        t0 = time.perf_counter()
        tree_bytes = sum(_pool_map(put, files, threads=SYNC_THREADS))
        t_write = time.perf_counter() - t0
        _poll(lambda: all(p in landed_b.at for p, _ in files),
              SYNC_DEADLINE, "the tree on dc2")
        t_mirror = max(landed_b.at[p] for p, _ in files) - t0
        on_b = _check_files(fb, want, "18a dc2")
        pending = set(want)

        def backed_up():
            for path in list(pending):
                local = os.path.join(backup_dir, path[len(SYNC_ROOT) + 1:])
                if os.path.exists(local):
                    with open(local, "rb") as f:
                        if _sha(f.read()) != want[path]:
                            fail(f"18a: the backup's {path} differs")
                    pending.discard(path)
            return not pending

        _poll(backed_up, SYNC_DEADLINE, "the tree in filer.backup's directory")
        small = {p: h for p, h in want.items()
                 if p.startswith(f"{SYNC_ROOT}/small/")}
        to_s3 = set(small)

        def in_s3():
            for path in list(to_s3):
                key = path[len(SYNC_ROOT) + len("/small/"):]
                r = session().head(f"{b.s3_url}/{SYNC_BUCKET}/{key}",
                                   timeout=30)
                if r.status_code == 200:
                    if r.headers.get("ETag", "").strip('"') != md5[path]:
                        fail(f"18a: s3://{SYNC_BUCKET}/{key} ETag "
                             f"{r.headers.get('ETag')} is not the md5")
                    to_s3.discard(path)
            return not to_s3

        _poll(in_s3, SYNC_DEADLINE, f"the small files in s3://{SYNC_BUCKET}")
        _poll(lambda: all(meta.find_entry(p) is not None for p in want),
              SYNC_DEADLINE, "every path in the meta backup")
        dirs = sorted({p[:i] for p in want for i in range(len(p))
                       if p[i] == "/" and i >= len(SYNC_ROOT)})
        for d in dirs:
            src = [(e["full_path"], _is_dir(e),
                    0 if _is_dir(e) else entry_size(e))
                   for e in _list(env_a, d)]
            got = [(e.full_path, e.is_directory,
                    0 if e.is_directory else e.file_size)
                   for e in meta.list_entries(d)]
            if sorted(src) != sorted(got):
                fail(f"18a: the meta backup's listing of {d} differs from "
                     f"dc1's: {sorted(set(src) ^ set(got))[:4]}")
        walls["a"] = time.perf_counter() - t0
        log(f"[18a] {len(files)} files ({n_big} x {SYNC_BIG[1]} B, "
            f"{SYNC_SMALL} of {SYNC_SMALL_LO}-{SYNC_SMALL_HI} B under "
            f"{SYNC_PREFIXES} directories), {tree_bytes} B written to dc1 "
            f"({SYNC_THREADS} threads) in {t_write:.3f} s; the last on dc2 "
            f"{t_mirror:.3f} s after the first PUT: "
            f"{tree_bytes / t_mirror / 1e6:.1f} MB/s mirrored; dc2 read "
            f"back {on_b['mbps']:.1f} MB/s; every file sha256-equal on dc2 "
            f"and in filer.backup's directory, every small file md5-equal "
            f"in s3://{SYNC_BUCKET}; the meta backup lists "
            f"{len(dirs)} directories as dc1 does")

        # 18b. the steady lag both ways, and the loop guard
        a_writes = _sync_writes("lag/a", SYNC_LAG_WRITES, 1)
        b_writes = _sync_writes("lag/b", SYNC_LAG_WRITES, 2)
        t0 = time.perf_counter()
        acked = _spaced_writes(fa, a_writes, "18b dc1")
        _poll(lambda: all(p in landed_b.at for p in a_writes),
              SYNC_DEADLINE, "18b's dc1 writes on dc2")
        acked_b = _spaced_writes(fb, b_writes, "18b dc2")
        _poll(lambda: all(p in landed_a.at for p in b_writes),
              SYNC_DEADLINE, "18b's dc2 writes on dc1")
        lag_ab = [landed_b.at[p] - acked[p] for p in a_writes]
        lag_ba = [landed_a.at[p] - acked_b[p] for p in b_writes]
        time.sleep(SYNC_QUIET)
        for name, c, other in (("dc1", a, "b"), ("dc2", b, "a")):
            evs = _events_by_path(c.filer.filer, f"{SYNC_ROOT}/lag")
            for path in list(a_writes) + list(b_writes):
                kinds = [(e["old_entry"] is None, e["new_entry"] is None)
                         for e in evs.get(path, [])]
                if kinds != [(True, False)]:
                    fail(f"18b: {name}'s log holds {len(kinds)} events for "
                         f"{path} ({kinds}): wanted one create")
            origin = b_writes if name == "dc1" else a_writes
            for path in origin:
                if sig[other] not in evs[path][0]["signatures"]:
                    fail(f"18b: {name}'s event for {path} lacks the "
                         f"signature of its origin: "
                         f"{evs[path][0]['signatures']}")
        both = {p: _sha(d) for p, d in {**a_writes, **b_writes}.items()}
        for f in (fa, fb):
            _check_files(f, both, "18b")
        walls["b"] = time.perf_counter() - t0
        log(f"[18b] {SYNC_LAG_WRITES} writes of {SYNC_LAG_LO}-{SYNC_LAG_HI} B"
            f" {SYNC_SPACING * 1e3:.0f} ms apart on dc1: lag from dc1's 201 "
            f"to the create on dc2 {_lat(lag_ab)}; as many on dc2: lag to "
            f"dc1 {_lat(lag_ba)}; after {SYNC_QUIET:.0f} s of quiet each "
            f"of the {len(both)} paths has exactly one event, a create, in "
            f"each filer's log, each mirrored event signed by its origin; "
            f"every file sha256-equal on both")

        # 18c. deletes and renames on A
        t0 = time.perf_counter()
        keys = sorted(small)
        gone = keys[:SYNC_DELETES]
        moved = keys[SYNC_DELETES:SYNC_DELETES + SYNC_RENAMES]
        for path in gone:
            r = session().delete(f"{fa}{path}", timeout=60)
            if r.status_code >= 300:
                fail(f"18c: delete {path} answered {r.status_code}")
        for path in moved:
            r = session().put(f"{fa}{path}.moved",
                              params={"mv.from": path}, timeout=60)
            if r.status_code >= 300:
                fail(f"18c: rename {path} answered {r.status_code}")

        def local(path):
            return os.path.join(backup_dir, path[len(SYNC_ROOT) + 1:])

        def reflected():
            if any(_filer_get(fb, p).status_code != 404 for p in gone + moved):
                return False
            if any(os.path.exists(local(p)) for p in gone + moved) or not \
                    all(os.path.exists(local(p + ".moved")) for p in moved):
                return False
            return all(meta.find_entry(p) is None for p in gone + moved) \
                and all(meta.find_entry(p + ".moved") is not None
                        for p in moved)

        _poll(reflected, SYNC_DEADLINE, "18c's deletes and renames mirrored",
              step=0.2)
        renamed = {p + ".moved": small[p] for p in moved}
        _check_files(fb, renamed, "18c dc2")
        for path, h in renamed.items():
            with open(local(path), "rb") as f:
                if _sha(f.read()) != h:
                    fail(f"18c: the backup's {path} differs")
        walls["c"] = time.perf_counter() - t0
        log(f"[18c] {len(gone)} deletes and {len(moved)} renames on dc1 "
            f"reflected on dc2, in filer.backup's directory and in the "
            f"meta backup in {walls['c']:.3f} s; the renamed files "
            f"sha256-equal")

        # 18d. the notifier's lines, and fs.meta.notify
        t0 = time.perf_counter()
        root = SYNC_ROOT + "/"

        def under_root():
            return [e for e in a.filer.filer.meta_log.replay(0)
                    if (e["directory"] + "/").startswith(root)]

        def lines():
            with open(events_path, "rb") as f:
                return [json.loads(x) for x in f.read().splitlines()]

        _poll(lambda: len(lines()) >= len(under_root()), SYNC_DEADLINE,
              "the notifier's lines")
        time.sleep(0.5)                 # a duplicate would land by now
        evs, got = under_root(), lines()
        if [(x["key"], x["message"]["ts_ns"]) for x in got] != [
                ((e["new_entry"] or e["old_entry"])["full_path"], e["ts_ns"])
                for e in evs]:
            fail(f"18d: {len(got)} notifier lines for {len(evs)} events "
                 f"under {SYNC_ROOT}, or not in their order")
        notify_path = os.path.join(tmp, "notify.jsonl")
        r = session().put(f"{fa}/kv/notification.conf", data=json.dumps(
            {"kind": "log", "path": notify_path}).encode(), timeout=30)
        if r.status_code >= 300:
            fail(f"18d: PUT notification.conf answered {r.status_code}")
        walked = [e["full_path"] for e in _walk(env_a, f"{SYNC_ROOT}/small")]
        out = repl.run_command(env_a, f"fs.meta.notify {SYNC_ROOT}/small")
        with open(notify_path, "rb") as f:
            sent = [json.loads(x) for x in f.read().splitlines()]
        if out != {"notified": len(walked)} or \
                [x["key"] for x in sent] != walked or \
                any(x["message"]["event"] != "create" for x in sent):
            fail(f"18d: fs.meta.notify answered {out}, its queue holds "
                 f"{len(sent)} lines; the walk finds {len(walked)} entries")
        walls["d"] = time.perf_counter() - t0
        log(f"[18d] the notifier wrote exactly one line per event under "
            f"{SYNC_ROOT} ({len(got)}), in order; fs.meta.notify "
            f"{SYNC_ROOT}/small -> {out}, one create line per walked entry")

        # 18e. seal B's volumes holding the mirror
        t0 = time.perf_counter()
        tree = {**{p: h for p, h in want.items() if p not in gone + moved},
                **renamed, **both}
        entries = [e for e in _walk(env_b, SYNC_ROOT) if not _is_dir(e)]
        if sorted(e["full_path"] for e in entries) != sorted(tree):
            fail("18e: dc2's tree is not dc1's")
        vids = sorted({int(c["fid"].split(",")[0])
                       for e in entries for c in e.get("chunks", [])})
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        dat = {}
        for vid in vids:
            for st in b.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat[vid] = v.content_size()
        repl.run_command(env_b, "lock")
        before = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env_b, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before["kernel"]
        own = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i for i, st in enumerate(b.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        repairs = env_b.master_get("/debug/repair")
        if launches["encode"] <= 0 or launches["encode"] != own or \
                scraped != launches["encode"]:
            fail(f"18e: {launches['encode']} launches during ec.encode, "
                 f"the sizes give {own}, /metrics says {scraped}")
        if repairs.get("recent") or repairs.get("in_flight"):
            fail(f"18e: a repair ran during the encode: {repairs}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env_b.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"18e: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        sealed = _check_files(fb, tree, "18e sealed")
        log(f"[18e] ec.encode of dc2's {len(vids)} volumes holding the "
            f"mirror ({dat} .dat bytes) {t_encode:.3f} s, "
            f"{launches['encode']} launches (the sizes give {own}; "
            f"/metrics cuda_kernel_launches {scraped}); "
            f"{stages_since(before, t_encode)}; kernel "
            f"{kernel_s * 1e3:.3f} ms, "
            f"{kernel_s * 1e3 / launches['encode']:.3f} ms per launch; no "
            f"repair queued; the tree ({len(tree)} files) read back "
            f"sha256-equal, {sealed['mbps']:.1f} MB/s")
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"18e: {victim} holds more than m=4 shards of a volume: "
                 f"{lost}")
        t1 = time.perf_counter()
        b.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env_b.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"dc2's master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        big = {p: h for p, h in want.items()
               if p.startswith(f"{SYNC_ROOT}/big/")}
        degraded = _check_files(fb, big, "18e degraded", threads=4)
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env_b, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped != launches["rebuild"]:
            fail(f"18e: ec.rebuild: {launches['rebuild']} launches, "
                 f"/metrics cuda_kernel_launches {scraped}")
        for vid in vids:
            if sorted(env_b.ec_shard_locations(vid)) != list(range(14)):
                fail(f"18e: volume {vid} after ec.rebuild: "
                     f"{env_b.ec_shard_locations(vid)}")
        healed = _check_files(fb, big, "18e rebuilt", threads=4)
        repl.run_command(env_b, "unlock")
        walls["e"] = time.perf_counter() - t0
        log(f"[18e] stopped {victim} (shards {lost}); the master dropped "
            f"them in {t_gone:.3f} s; the {len(big)} big files read "
            f"degraded {degraded['wall']:.3f} s, {degraded['mbps']:.1f} "
            f"MB/s; ec.rebuild {t_rebuild:.3f} s, {launches['rebuild']} "
            f"launches; read again {healed['mbps']:.1f} MB/s; every "
            f"sha256 equal")

        # 18f. the workers stopped, writes, filer.sync resumed
        t0 = time.perf_counter()
        for name in ("sync", "backup"):
            procs[name].terminate()
            procs[name].wait(timeout=30)
        offset_key = f"sync/{sig['b']}/offset"
        saved = session().get(f"{fa}/kv/{offset_key}", timeout=30)
        if saved.status_code != 200 or int(saved.content) <= 0:
            fail(f"18f: dc1's KV {offset_key}: {saved.status_code}")
        resume = _sync_writes("resume/r", SYNC_RESUME, 3)
        t_down = time.time_ns()
        for path, data in resume.items():
            r = session().post(f"{fa}{path}", data=data, timeout=60)
            if r.status_code != 201:
                fail(f"18f: write {path} answered {r.status_code}")
        logs["sync2"] = os.path.join(tmp, "sync2.log")
        procs["sync2"] = _spawn(sync_args, logs["sync2"])
        t1 = time.perf_counter()
        _poll(lambda: all(p in landed_b.at for p in resume), SYNC_DEADLINE,
              "18f's writes on dc2")
        t_resume = time.perf_counter() - t1
        time.sleep(1.0)                 # a replay would land by now
        _check_files(fb, {p: _sha(d) for p, d in resume.items()}, "18f")
        fresh = sorted(p for p, evs in _events_by_path(
            b.filer.filer, SYNC_ROOT).items() for e in evs
            if e["ts_ns"] > t_down and e["old_entry"] is None and
            not _is_dir(e["new_entry"] or {}))
        if fresh != sorted(resume):
            fail(f"18f: dc2 took {len(fresh)} creates after the restart, "
                 f"not exactly the {len(resume)} new files")
        creates = {p: sum(1 for e in evs if e["old_entry"] is None)
                   for p, evs in _events_by_path(b.filer.filer,
                                                 SYNC_ROOT).items()
                   if not _is_dir(evs[0]["new_entry"] or
                                  evs[0]["old_entry"])}
        if len(creates) < len(tree) or any(n != 1 for n in creates.values()):
            fail(f"18f: dc2 holds a second create of "
                 f"{[p for p, n in creates.items() if n != 1][:4]}")
        now = int(session().get(f"{fa}/kv/{offset_key}", timeout=30).content)
        if now <= int(saved.content):
            fail(f"18f: {offset_key} did not advance past {saved.content}")
        walls["f"] = time.perf_counter() - t0
        log(f"[18f] filer.sync and filer.backup stopped at offset "
            f"{int(saved.content)} ({offset_key} in dc1's KV); "
            f"{len(resume)} writes on dc1; filer.sync restarted: exactly "
            f"those {len(resume)} reached dc2 {t_resume:.3f} s after its "
            f"start, sha256-equal, no earlier path created twice")
        if procs["sync2"].poll() is not None:
            fail(f"the restarted filer.sync exited: {_tail(logs['sync2'])}")
        if mirror.failed:
            fail(f"the S3 mirror failed {mirror.failed} events")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 18 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[18] phase 18 took {wall:.3f} s ({ {k: round(v, 3) for k, v in walls.items()} }); "
            f"kernel launches {launches}; workers: S3 mirror applied "
            f"{mirror.applied} / skipped {mirror.skipped} / failed "
            f"{mirror.failed}, meta backup applied {meta.applied}; the "
            f"seal's kernel time {kernel_s * 1e3:.3f} ms is {busy:.5%} of "
            f"the phase wall (idle share {1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        launches["lag_ms"] = {
            "a_to_b": [round(float(x), 3) for x in
                       np.percentile(lag_ab, [50, 99]) * 1e3],
            "b_to_a": [round(float(x), 3) for x in
                       np.percentile(lag_ba, [50, 99]) * 1e3]}
        return launches
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        for w in workers:
            w.stop()
        for lnd in landed:
            lnd.close()
        if pump is not None:
            pump.stop_event.set()
            pump.join(timeout=5)
        if queue is not None:
            queue.close()
        for env in (env_a, env_b):
            if env is not None:
                env.close()
        for c in (b, a):
            if c is not None:
                c.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 19: an encrypted, sharded, cached filer behind S3; its volumes
# (AES-GCM ciphertext) sealed and rebuilt through the kernel
# ----------------------------------------------------------------------
STORES_SHARDS = 4                 # -filer.store.shards
STORES_CACHE = 4096               # -filer.cache.entries
STORES_BUCKETS = 8
STORES_OBJECTS = 1024             # 1-64 KiB, log-uniform, over the buckets
STORES_OBJ_LO, STORES_OBJ_HI = 1 << 10, 64 << 10
STORES_BIG = (8, 16 << 20)        # (count, bytes) through the filer, /big
STORES_PAGE = 100                 # max-keys of 19c's listings
STORES_OVERWRITES, STORES_DELETES, STORES_RENAMES = 32, 16, 8
STORES_VOLUME_LIMIT = 64 << 20    # the master's volume size limit
STORES_THREADS = 8
STORES_DEADLINE = 60.0            # longest wait for a process to serve


def _stores_objects() -> dict[str, bytes]:
    """The buckets' objects: "/bucket/key" -> bytes, from the seed."""
    rng = np.random.default_rng([SEED, 19])
    sizes = np.exp(rng.uniform(np.log(STORES_OBJ_LO), np.log(STORES_OBJ_HI),
                               STORES_OBJECTS))
    return {f"/s19-b{i % STORES_BUCKETS}/p{(i // STORES_BUCKETS) % 4}/"
            f"o-{i:04d}.bin": rng.bytes(int(n)) for i, n in enumerate(sizes)}


def _stores_big(i: int) -> bytes:
    return np.random.default_rng([SEED, 19, 1, i]).bytes(STORES_BIG[1])


def _list_bucket(s3, bucket: str, page: int = STORES_PAGE) -> list[str]:
    """ListObjectsV2 of a bucket, `page` keys a request."""
    keys, token = [], ""
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    while True:
        q = f"?list-type=2&max-keys={page}" + (
            f"&continuation-token={token}" if token else "")
        resp = s3("GET", f"/{bucket}{q}")
        if resp.status_code != 200:
            fail(f"ListObjectsV2 {bucket}: {resp.status_code} {resp.text}")
        root = ET.fromstring(resp.content)
        keys += [c.find(ns + "Key").text for c in root.findall(ns + "Contents")]
        nxt = root.find(ns + "NextContinuationToken")
        if nxt is None:
            return keys
        token = nxt.text


def _filer_pages(filer: str, d: str, limit: int = STORES_PAGE) -> list:
    """Every listing page of a filer directory, entries whole."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    pages, last = [], ""
    while True:
        r = session().get(f"{filer}{d}/", params={"limit": str(limit),
                                                   "lastFileName": last},
                          timeout=30)
        if r.status_code != 200:
            fail(f"listing {d}: {r.status_code} {r.text}")
        body = r.json()
        pages.append(body["entries"])
        if not body["shouldDisplayLoadMore"]:
            return pages
        last = body["lastFileName"]


def _metric(text: str, name: str) -> float:
    """The sum of a metric's samples in a /metrics exposition."""
    import re

    return sum(float(m.group(1)) for m in re.finditer(
        rf"^{re.escape(name)}(?:{{[^}}]*}})? (\S+)$", text, re.M))


def phase_stores(card: str) -> dict:
    """Phase 19: the port's CLI filer over a 4-shard leveldb store behind
    the cache, with -encryptVolumeData, and the CLI S3 gateway over it;
    the volumes of its ciphertext sealed, read degraded and rebuilt
    through the kernel. -> kernel launches by step."""
    from seaweedfs_tpu_torch.filer import sharded_store
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.utils import cipher

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke19-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    cluster = env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    try:
        # 19a. the cipher on this host's libcrypto, the cluster, the
        # filer and the gateway as processes of the CLI
        t0 = time.perf_counter()
        key = bytes.fromhex("feffe9928665731c6d6a8f9467308308"
                            "feffe9928665731c6d6a8f9467308308")
        iv = bytes.fromhex("cafebabefacedbaddecaf888")
        pt = bytes.fromhex(
            "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
            "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255")
        want_ct = bytes.fromhex(
            "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
            "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662898015ad"
            "b094dac5d93471bdec1a502270e3cc6c")
        sealed_vec = cipher._encrypt_with_nonce(pt, key, iv)
        if sealed_vec != iv + want_ct or cipher.decrypt(sealed_vec, key) != pt:
            fail("AES-256-GCM on this host's libcrypto misses the GCM "
                 "specification's test case 15")
        lib = cipher._libcrypto()
        cluster = Cluster(os.path.join(tmp, "main"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=STORES_VOLUME_LIMIT,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        fport, sport = free_ports(2)
        filer = f"http://127.0.0.1:{fport}"
        gateway = f"http://127.0.0.1:{sport}"
        store_dir = os.path.join(tmp, "filerdb")
        filer_args = ["filer", "-port", str(fport), "-master",
                      cluster.master_url, "-store", "leveldb", "-store.path",
                      store_dir, "-filer.store.shards", str(STORES_SHARDS),
                      "-filer.cache.entries", str(STORES_CACHE),
                      "-encryptVolumeData"]
        s3_conf = os.path.join(tmp, "s3.json")
        with open(s3_conf, "w") as f:
            json.dump(S3_CONFIG, f)

        def start(name: str, args: list[str], port: int) -> float:
            return _serve_cli(procs, logs, tmp, name, args, port,
                              STORES_DEADLINE)

        t_filer = start("filer", filer_args, fport)
        status = _get_json(f"{filer}/status")
        if status.get("cipher") is not True:
            fail(f"the filer's /status {status}: no cipher")
        t_s3 = start("s3", ["s3", "-port", str(sport), "-filer", filer,
                            "-config", s3_conf], sport)
        env = CommandEnv(cluster.master_url, filer_url=filer)
        s3 = _S3Client(gateway)
        walls["a"] = time.perf_counter() - t0
        log(f"[19] {card}; libcrypto {lib._name}: the GCM specification's "
            f"test case 15 (AES-256, no AAD) exact; master "
            f"{cluster.master_url}, 4 volume servers ec_backend='cuda', "
            f"volume limit {STORES_VOLUME_LIMIT} B; `{' '.join(filer_args[:1] + filer_args[5:])}` "
            f"on {filer} (listening after {t_filer:.3f} s), `s3` on "
            f"{gateway} ({t_s3:.3f} s); set-up {walls['a']:.3f} s")

        # 19b. the writes: the buckets' objects through S3, the big
        # files through the filer
        objects = _stores_objects()
        big = {f"/big/f-{i}.bin": _stores_big(i) for i in range(STORES_BIG[0])}
        buckets = sorted({p.split("/")[1] for p in objects})
        t0 = time.perf_counter()
        for b in buckets:
            r = s3("PUT", f"/{b}")
            if r.status_code != 200:
                fail(f"CreateBucket {b}: {r.status_code} {r.text}")
        lat: list[float] = []

        def put(path):
            t1 = time.perf_counter()
            r = s3("PUT", path, objects[path])
            if r.status_code != 200 or r.headers.get("ETag", "").strip(
                    '"') != hashlib.md5(objects[path]).hexdigest():
                fail(f"19b: PUT {path}: {r.status_code} "
                     f"ETag {r.headers.get('ETag')}")
            lat.append(time.perf_counter() - t1)

        _pool_map(put, sorted(objects), threads=STORES_THREADS)
        t_objects = time.perf_counter() - t0
        t1 = time.perf_counter()

        def post(path):
            r = session().post(f"{filer}{path}", data=big[path], timeout=300)
            if r.status_code != 201:
                fail(f"19b: POST {path}: {r.status_code} {r.text}")

        _pool_map(post, sorted(big), threads=4)
        t_big = time.perf_counter() - t1
        obj_bytes = sum(map(len, objects.values()))
        big_bytes = sum(map(len, big.values()))
        # every chunk on its volume server is ciphertext of its piece
        t1 = time.perf_counter()
        files = ["/big"] + [f"/buckets/{b}/p{j}" for b in buckets
                            for j in range(4)]
        entries = {e["full_path"]: e for d in files
                   for pg in _filer_pages(filer, d) for e in pg}
        if sorted(entries) != sorted([f"/buckets{p}" for p in objects]
                                     + list(big)):
            fail("19b: the filer's listings are not the written files")
        vid_url: dict[str, str] = {}

        def check_chunks(full):
            e = entries[full]
            data = big.get(full) or objects[full[len("/buckets"):]]
            if e.get("content") or not e.get("chunks"):
                fail(f"19b: {full} is inlined or has no chunks")
            for ch in e["chunks"]:
                vid = ch["fid"].split(",")[0]
                if vid not in vid_url:
                    vid_url[vid] = _get_json(
                        f"{cluster.master_url}/dir/lookup",
                        volumeId=vid)["locations"][0]["url"]
                raw = session().get(f"http://{vid_url[vid]}/{ch['fid']}",
                                    timeout=60).content
                piece = data[ch["offset"]:ch["offset"] + ch["size"]]
                if not ch.get("cipher_key") or len(raw) != len(piece) + 28 \
                        or raw[12:-16] == piece or \
                        cipher.decrypt(raw, bytes.fromhex(
                            ch["cipher_key"])) != piece:
                    fail(f"19b: chunk {ch['fid']} of {full} on its volume "
                         "server is not the AES-GCM ciphertext of its piece")
            return len(e["chunks"])

        n_chunks = sum(_pool_map(check_chunks, sorted(entries),
                                 threads=STORES_THREADS))
        t_chunks = time.perf_counter() - t1
        debug = _get_json(f"{filer}/debug/filer", timeout=30)
        snap = debug["snapshot"]
        shards = snap["inner"]["per_shard"]
        walked = sum(len(p) for d in ["", "/buckets", "/big"] + [
            f"/buckets/{b}" for b in buckets] + [
            f"/buckets/{b}/p{j}" for b in buckets for j in range(4)]
            for p in _filer_pages(filer, d))
        ring = sharded_store._HashRing(STORES_SHARDS)
        homes = {b: ring.shard_for(f"buckets/{b}") for b in buckets}
        per = [s["entries"] for s in shards]
        if debug["store"] != "cached-sharded" or snap["kind"] != "cache" or \
                len(shards) != STORES_SHARDS or sum(per) != walked or \
                len(set(homes.values())) < 2 or \
                any(per[h] == 0 for h in homes.values()):
            fail(f"19b: /debug/filer {debug['store']}: per-shard entries "
                 f"{per} (sum {sum(per)}), the listings walk {walked}; the "
                 f"buckets' shards {homes}")
        walls["b"] = time.perf_counter() - t0
        log(f"[19b] {len(objects)} objects of {STORES_OBJ_LO}-"
            f"{STORES_OBJ_HI} B ({obj_bytes} B) into {len(buckets)} buckets "
            f"through S3 on {STORES_THREADS} threads: {t_objects:.3f} s, "
            f"{len(objects) / t_objects:.1f} objects/s, "
            f"{obj_bytes / t_objects / 1e6:.2f} MB/s, PUT {_lat(lat)}; "
            f"{STORES_BIG[0]} x {STORES_BIG[1]} B through the filer "
            f"{t_big:.3f} s, {big_bytes / t_big / 1e6:.1f} MB/s; all "
            f"{n_chunks} chunks read raw from their volume servers "
            f"({t_chunks:.3f} s): each the AES-GCM ciphertext of its "
            f"piece, 28 B longer, decrypted under its entry's key; "
            f"/debug/filer: {debug['store']}, per-shard entries {per} "
            f"summing to the {walked} entries the listings walk, the "
            f"buckets on shards {sorted(set(homes.values()))}")

        # 19c. the cache: listings twice, then mutations with no stale read
        t0 = time.perf_counter()
        hits0 = _metric(session().get(f"{filer}/metrics", timeout=30).text,
                        "filer_store_cache_hits_total")
        live = dict(objects)

        def list_all(label: str) -> float:
            t1 = time.perf_counter()
            for b in buckets:
                got = _list_bucket(s3, b)
                exp = sorted(p.split("/", 2)[2] for p in live
                             if p.split("/")[1] == b)
                if got != exp:
                    fail(f"{label}: ListObjectsV2 {b} ({STORES_PAGE} a "
                         f"page) gave {len(got)} keys, "
                         f"{len(set(got) ^ set(exp))} off")
            return time.perf_counter() - t1

        t_list1 = list_all("19c first")
        hits1 = _metric(session().get(f"{filer}/metrics", timeout=30).text,
                        "filer_store_cache_hits_total")
        t_list2 = list_all("19c second")
        hits2 = _metric(session().get(f"{filer}/metrics", timeout=30).text,
                        "filer_store_cache_hits_total")
        if hits2 <= hits1:
            fail(f"19c: the second listing pass raised "
                 f"filer_store_cache_hits_total {hits0} -> {hits1} -> {hits2}")
        rng = np.random.default_rng([SEED, 19, 2])
        order = [sorted(objects)[int(i)] for i in rng.permutation(len(objects))]
        over = order[:STORES_OVERWRITES]
        gone = order[STORES_OVERWRITES:STORES_OVERWRITES + STORES_DELETES]
        moved = order[STORES_OVERWRITES + STORES_DELETES:
                      STORES_OVERWRITES + STORES_DELETES + STORES_RENAMES]
        for path in over:
            # read first, so the cache holds the old entry
            if _sha(s3("GET", path).content) != _sha(live[path]):
                fail(f"19c: GET {path} before its overwrite")
            data = rng.bytes(int(rng.integers(STORES_OBJ_LO, STORES_OBJ_HI)))
            r = session().post(f"{filer}/buckets{path}", data=data,
                               timeout=60)
            if r.status_code != 201:
                fail(f"19c: overwrite {path}: {r.status_code}")
            live[path] = data
            if _sha(s3("GET", path).content) != _sha(data):
                fail(f"19c: a stale read of {path} after its overwrite")
        for path in gone:
            s3("HEAD", path)
            r = session().delete(f"{filer}/buckets{path}", timeout=60)
            if r.status_code >= 300:
                fail(f"19c: delete {path}: {r.status_code}")
            del live[path]
            if s3("GET", path).status_code != 404:
                fail(f"19c: {path} still read after its delete")
        for path in moved:
            dst = path.replace("/o-", "/moved-")
            r = session().put(f"{filer}/buckets{dst}",
                              params={"mv.from": f"/buckets{path}"},
                              timeout=60)
            if r.status_code >= 300:
                fail(f"19c: rename {path}: {r.status_code} {r.text}")
            live[dst] = live.pop(path)
            if s3("GET", path).status_code != 404 or \
                    _sha(s3("GET", dst).content) != _sha(live[dst]):
                fail(f"19c: a stale read after renaming {path} to {dst}")
        t_list3 = list_all("19c after the mutations")
        lat = []

        def get(path):
            t1 = time.perf_counter()
            r = s3("GET", path)
            if r.status_code != 200 or _sha(r.content) != _sha(live[path]):
                fail(f"19c: GET {path}: {r.status_code}, a stale read")
            lat.append(time.perf_counter() - t1)
            return len(r.content)

        t1 = time.perf_counter()
        nbytes = sum(_pool_map(get, sorted(live), threads=STORES_THREADS))
        t_get = time.perf_counter() - t1
        stats = _get_json(f"{filer}/debug/filer", timeout=30)["snapshot"][
            "cache"]
        walls["c"] = time.perf_counter() - t0
        log(f"[19c] every bucket listed {STORES_PAGE} keys a page: "
            f"{t_list1:.3f} s, then {t_list2:.3f} s from the cache "
            f"(filer_store_cache_hits_total {hits0:.0f} -> {hits1:.0f} -> "
            f"{hits2:.0f}); {len(over)} overwrites, {len(gone)} deletes "
            f"and {len(moved)} renames through the filer, each read back "
            f"through S3 at once with no stale read; listings after "
            f"{t_list3:.3f} s; all {len(live)} objects GET "
            f"{t_get:.3f} s, {len(live) / t_get:.1f} objects/s, "
            f"{nbytes / t_get / 1e6:.2f} MB/s, {_lat(lat)}; cache {stats}")

        # 19d. the store on disk: the filer process stopped and started
        # again on the same directory
        t0 = time.perf_counter()
        dirs = ["", "/buckets", "/big"] + [f"/buckets/{b}" for b in buckets] \
            + [f"/buckets/{b}/p{j}" for b in buckets for j in range(4)]
        before = {d: _filer_pages(filer, d) for d in dirs}
        metrics_text = session().get(f"{filer}/metrics", timeout=30).text
        compactions = _metric(metrics_text,
                              "filer_store_compaction_seconds_count")
        procs["filer"].terminate()
        procs["filer"].wait(timeout=30)
        t_down = time.perf_counter() - t0
        t_restart = start("filer", filer_args, fport)
        after = {d: _filer_pages(filer, d) for d in dirs}
        if after != before:
            bad = [d for d in dirs if after[d] != before[d]]
            fail(f"19d: after the filer's restart the listings of {bad} "
                 "differ")
        _poll(lambda: s3("GET", f"/{buckets[0]}?list-type=2&max-keys=1"
                         ).status_code == 200, STORES_DEADLINE,
              "the gateway through the restarted filer")
        t_back = time.perf_counter() - t0 - t_down - t_restart
        walls["d"] = time.perf_counter() - t0
        log(f"[19d] the filer stopped (SIGTERM, {t_down:.3f} s) and "
            f"started again on {store_dir} in {t_restart:.3f} s: every "
            f"listing page of {len(dirs)} directories "
            f"({sum(len(p) for v in before.values() for p in v)} entries, "
            f"{STORES_PAGE} a page) as before; the gateway served again "
            f"{t_back:.3f} s later; weedkv's filer_store_compaction_seconds "
            f"count before the stop {compactions:.0f}")

        # 19e. seal the volumes of the ciphertext; read sealed, degraded
        # and rebuilt
        t0 = time.perf_counter()
        chunks = [ch for p, pages in after.items() for pg in pages
                  for e in pg for ch in e.get("chunks", [])]
        vids = sorted({int(ch["fid"].split(",")[0]) for ch in chunks})
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        dat = {}
        for vid in vids:
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat[vid] = v.content_size()
        repl.run_command(env, "lock")
        before_stages = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before_stages["kernel"]
        own = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if launches["encode"] <= 0 or launches["encode"] != own or \
                scraped != launches["encode"]:
            fail(f"19e: {launches['encode']} launches during ec.encode, "
                 f"the .dat sizes give {own}, /metrics says {scraped}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"19e: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))

        def read_all(label: str) -> tuple[dict, dict]:
            lat_o: list[float] = []

            def one(path):
                t1 = time.perf_counter()
                r = s3("GET", path)
                if r.status_code != 200 or _sha(r.content) != \
                        _sha(live[path]):
                    fail(f"{label}: GET {path}: {r.status_code}, sha256 off")
                lat_o.append(time.perf_counter() - t1)
                return len(r.content)

            t1 = time.perf_counter()
            nb = sum(_pool_map(one, sorted(live), threads=STORES_THREADS))
            wo = time.perf_counter() - t1
            files = _check_files(filer, {p: _sha(d) for p, d in big.items()},
                                 label, threads=4)
            return ({"wall": wo, "bytes": nb, "mbps": nb / wo / 1e6,
                     "rate": len(live) / wo, "lat": lat_o}, files)

        sealed_o, sealed_f = read_all("19e sealed")
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"19e: {victim} holds more than m=4 shards of a volume: "
                 f"{lost}")
        t1 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        degraded = _check_files(filer, {p: _sha(d) for p, d in big.items()},
                                "19e degraded", threads=STORES_THREADS)
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped_r = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped_r != launches["rebuild"]:
            fail(f"19e: ec.rebuild: {launches['rebuild']} launches, the "
                 f"volume servers' cuda_kernel_launches {scraped_r}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"19e: volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        healed_o, healed_f = read_all("19e rebuilt")
        repl.run_command(env, "unlock")
        walls["e"] = time.perf_counter() - t0
        log(f"[19e] ec.encode of the {len(vids)} volumes holding the "
            f"ciphertext ({dat} .dat bytes) {t_encode:.3f} s, "
            f"{launches['encode']} launches (the sizes give {own}; "
            f"/metrics cuda_kernel_launches {scraped}); kernel "
            f"{kernel_s * 1e3:.3f} ms (CUDA events), "
            f"{kernel_s * 1e3 / launches['encode']:.3f} ms per launch; "
            f"read sealed: {len(live)} objects through S3 "
            f"{sealed_o['wall']:.3f} s, {sealed_o['rate']:.1f} objects/s, "
            f"{sealed_o['mbps']:.2f} MB/s, {_lat(sealed_o['lat'])}; the "
            f"{len(big)} files through the filer {sealed_f['mbps']:.1f} "
            f"MB/s; stopped {victim} (shards {lost}), dropped in "
            f"{t_gone:.3f} s; the files read degraded "
            f"{degraded['mbps']:.1f} MB/s; ec.rebuild {t_rebuild:.3f} s, "
            f"{launches['rebuild']} launches (/metrics {scraped_r}); read "
            f"again: objects "
            f"{healed_o['mbps']:.2f} MB/s, {_lat(healed_o['lat'])}, files "
            f"{healed_f['mbps']:.1f} MB/s; every sha256 equal")
        for name, proc in procs.items():
            if proc.poll() is not None:
                fail(f"the {name} process exited: {_tail(logs[name])}")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 19 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[19] phase 19 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); kernel "
            f"launches {launches}; the seal's kernel time "
            f"{kernel_s * 1e3:.3f} ms is {busy:.5%} of the phase wall "
            f"(idle share {1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        return launches
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 20: S3 buckets a browser and the public use; their volumes
# sealed and rebuilt through the kernel
# ----------------------------------------------------------------------
FORM_OBJECTS = 256                # objects of each bucket, 1-64 KiB
FORM_OBJ_LO, FORM_OBJ_HI = 1 << 10, 64 << 10
FORM_BIG = (4, 16 << 20)          # (count, bytes) of 20d's large uploads
FORM_UNTAGGED = 32                # 20c's DELETE ?tagging
FORM_VOLUME_LIMIT = 64 << 20      # the master's volume size limit
FORM_CHUNK = 8 << 20              # the CLI filer's -maxMB chunk size
FORM_THREADS = 8
FORM_DEADLINE = 60.0              # longest wait for a process to serve
_ALL_USERS = "http://acs.amazonaws.com/groups/global/AllUsers"


def _form_objects(n: int) -> list[bytes]:
    """20b-d's small objects, from the seed: 1-64 KiB, log-uniform."""
    rng = np.random.default_rng([SEED, 20, n])
    sizes = np.exp(rng.uniform(np.log(FORM_OBJ_LO), np.log(FORM_OBJ_HI),
                               FORM_OBJECTS))
    return [rng.bytes(int(k)) for k in sizes]


def _form_post(url: str, fields: dict, name: str, data: bytes):
    """A browser's multipart/form-data POST: the fields, then the file."""
    from seaweedfs_tpu_torch.rpc.httpclient import session

    boundary = "----smoke20" + hashlib.md5(
        name.encode() + data[:64]).hexdigest()
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; '
             f'name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; '
                 f'name="file"; filename="{name}"\r\nContent-Type: '
                 f'application/octet-stream\r\n\r\n'.encode() + data +
                 f'\r\n--{boundary}--\r\n'.encode())
    return session().post(
        url, data=b"".join(parts), timeout=(5.0, 300.0),
        headers={"Content-Type":
                 f"multipart/form-data; boundary={boundary}"})


def _form_policy(bucket: str, prefix: str, hi: int,
                 expire_in: float = 600.0) -> dict:
    """The signed fields of a POST policy for keys under `prefix`."""
    import base64

    from seaweedfs_tpu_torch.s3.sigv4_client import sign_policy

    doc = {"expiration": time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() + expire_in)),
        "conditions": [{"bucket": bucket}, ["starts-with", "$key", prefix],
                       ["content-length-range", 1, hi]]}
    return sign_policy(base64.b64encode(json.dumps(doc).encode()).decode(),
                       S3_KEY, S3_SECRET)


def _s3_code(resp) -> str:
    try:
        return ET.fromstring(resp.content).findtext("Code") or ""
    except ET.ParseError:
        return ""


def _tag_set(resp) -> dict:
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    root = ET.fromstring(resp.content)
    return {t.findtext(ns + "Key"): t.findtext(ns + "Value") or ""
            for t in root.iter(ns + "Tag")}


def phase_form(card: str) -> dict:
    """Phase 20: the CLI filer on leveldb and the CLI S3 gateway over an
    in-process master and four volume servers on "cuda"; a public-read
    bucket read without a signature, tagged objects, browser form
    uploads, lifecycle and ownership; the buckets' volumes sealed, read
    degraded and rebuilt through the kernel. -> kernel launches by
    step."""
    import html.parser

    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke20-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    cluster = env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    pub, tag, form = "s20-pub", "s20-tag", "s20-form"
    try:
        # 20a. the cluster, then the filer and the gateway as processes
        # of the CLI, probed by a TCP connect
        t0 = time.perf_counter()
        cluster = Cluster(os.path.join(tmp, "main"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=FORM_VOLUME_LIMIT,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        fport, sport = free_ports(2)
        filer = f"http://127.0.0.1:{fport}"
        gateway = f"http://127.0.0.1:{sport}"
        s3_conf = os.path.join(tmp, "s3.json")
        with open(s3_conf, "w") as f:
            json.dump(S3_CONFIG, f)

        def start(name: str, args: list[str], port: int) -> float:
            return _serve_cli(procs, logs, tmp, name, args, port,
                              FORM_DEADLINE)

        t_filer = start("filer", [
            "filer", "-port", str(fport), "-master", cluster.master_url,
            "-store", "leveldb", "-store.path",
            os.path.join(tmp, "filerdb")], fport)
        t_s3 = start("s3", ["s3", "-port", str(sport), "-filer", filer,
                            "-config", s3_conf], sport)
        env = CommandEnv(cluster.master_url, filer_url=filer)
        s3 = _S3Client(gateway)

        def anon(method: str, path: str, data: bytes | None = None):
            return session().request(method, gateway + path, data=data,
                                     timeout=(5.0, 300.0))
        walls["a"] = time.perf_counter() - t0
        log(f"[20] {card}; master {cluster.master_url}, 4 volume servers "
            f"ec_backend='cuda', volume limit {FORM_VOLUME_LIMIT} B; "
            f"`filer -store leveldb` on {filer} (listening after "
            f"{t_filer:.3f} s), `s3` on {gateway} ({t_s3:.3f} s); set-up "
            f"{walls['a']:.3f} s")

        # 20b. a public-read bucket: signed PUTs, unsigned GETs and HEADs
        t0 = time.perf_counter()
        for b in (pub, tag, form):
            r = s3("PUT", f"/{b}")
            if r.status_code != 200:
                fail(f"CreateBucket {b}: {r.status_code} {r.text}")
        r = s3("PUT", f"/{pub}?acl", headers={"x-amz-acl": "public-read"})
        if r.status_code != 200:
            fail(f"20b: PUT ?acl x-amz-acl public-read: {r.status_code} "
                 f"{r.text}")
        acl_xml = (
            "<AccessControlPolicy><Owner><ID>seaweedfs_tpu</ID></Owner>"
            "<AccessControlList><Grant><Grantee><ID>seaweedfs_tpu</ID>"
            "</Grantee><Permission>FULL_CONTROL</Permission></Grant>"
            f"<Grant><Grantee><URI>{_ALL_USERS}</URI></Grantee>"
            "<Permission>READ</Permission></Grant></AccessControlList>"
            "</AccessControlPolicy>").encode()
        r = s3("PUT", f"/{pub}?acl", acl_xml)
        if r.status_code != 200:
            fail(f"20b: PUT ?acl AccessControlPolicy: {r.status_code} "
                 f"{r.text}")
        r = s3("GET", f"/{pub}?acl")
        grants = [(g.findtext(".//{*}ID") or g.findtext(".//{*}URI"),
                   g.findtext("{*}Permission"))
                  for g in ET.fromstring(r.content).iter(
                      "{http://s3.amazonaws.com/doc/2006-03-01/}Grant")]
        if r.status_code != 200 or grants != [
                ("seaweedfs_tpu", "FULL_CONTROL"), (_ALL_USERS, "READ")]:
            fail(f"20b: GET ?acl {r.status_code}: grants {grants}")
        objects = {f"/{pub}/o-{i:04d}.bin": d
                   for i, d in enumerate(_form_objects(0))}
        lat_put: list[float] = []

        def put(path, headers=None):
            t1 = time.perf_counter()
            r = s3("PUT", path, objects[path], headers=headers)
            if r.status_code != 200 or r.headers.get("ETag", "").strip(
                    '"') != hashlib.md5(objects[path]).hexdigest():
                fail(f"PUT {path}: {r.status_code} {r.headers.get('ETag')}")
            lat_put.append(time.perf_counter() - t1)

        t1 = time.perf_counter()
        _pool_map(put, sorted(objects), threads=FORM_THREADS)
        t_put = time.perf_counter() - t1
        pub_keys = sorted(objects)

        def anon_pass(label: str) -> dict:
            lat_o: list[float] = []

            def one(path):
                t1 = time.perf_counter()
                r = anon("GET", path)
                if r.status_code != 200 or r.content != objects[path]:
                    fail(f"{label}: unsigned GET {path}: {r.status_code}, "
                         f"{len(r.content)} B")
                lat_o.append(time.perf_counter() - t1)
                h = anon("HEAD", path)
                if h.status_code != 200 or int(h.headers.get(
                        "Content-Length", -1)) != len(objects[path]):
                    fail(f"{label}: unsigned HEAD {path}: {h.status_code} "
                         f"{h.headers.get('Content-Length')}")
                return len(r.content)

            t1 = time.perf_counter()
            nb = sum(_pool_map(one, pub_keys, threads=FORM_THREADS))
            w = time.perf_counter() - t1
            return {"wall": w, "rate": len(pub_keys) / w,
                    "mbps": nb / w / 1e6, "lat": lat_o}

        healthy = anon_pass("20b")
        tag_objects = {f"/{tag}/t-{i:04d}.bin": d
                       for i, d in enumerate(_form_objects(1))}
        objects.update(tag_objects)
        refusals = {
            "unsigned PUT": anon("PUT", f"/{pub}/new.bin", b"x"),
            "unsigned GET ?acl": anon("GET", f"/{pub}?acl"),
            "unsigned listing": anon("GET", f"/{pub}"),
            "unsigned DELETE": anon("DELETE", pub_keys[0]),
        }
        put(sorted(tag_objects)[0])
        refusals["unsigned GET, private bucket"] = anon(
            "GET", sorted(tag_objects)[0])
        for what, r in refusals.items():
            if r.status_code != 403 or _s3_code(r) != "AccessDenied":
                fail(f"20b: {what}: {r.status_code} {_s3_code(r)}")
        walls["b"] = time.perf_counter() - t0
        log(f"[20b] {pub} public-read by x-amz-acl and by an "
            f"AccessControlPolicy body; GET ?acl grants {grants}; "
            f"{len(pub_keys)} signed PUTs of {FORM_OBJ_LO}-{FORM_OBJ_HI} B "
            f"on {FORM_THREADS} threads {t_put:.3f} s, "
            f"{len(pub_keys) / t_put:.1f} objects/s, PUT {_lat(lat_put)}; "
            f"unsigned GET + HEAD of each: {healthy['rate']:.1f} objects/s, "
            f"{healthy['mbps']:.2f} MB/s, GET {_lat(healthy['lat'])}, every "
            f"object equal; refused 403 AccessDenied: {sorted(refusals)}")

        # 20c. tags: an x-amz-tagging header on half the PUTs (the
        # reference's gateway stores none from it), PUT ?tagging on all
        t0 = time.perf_counter()
        rng = np.random.default_rng([SEED, 20, 3])
        tkeys = sorted(tag_objects)
        _pool_map(lambda p: put(p, {"x-amz-tagging": "via=header"}),
                  tkeys[1:len(tkeys) // 2], threads=FORM_THREADS)
        _pool_map(put, tkeys[len(tkeys) // 2:], threads=FORM_THREADS)
        header_tags = {p: _tag_set(s3("GET", f"{p}?tagging"))
                       for p in tkeys[:len(tkeys) // 2]}
        if any(header_tags.values()):
            fail(f"20c: an x-amz-tagging header left tags: "
                 f"{next(t for t in header_tags.values() if t)}")
        want_tags = {p: {f"k{j}": f"v{int(rng.integers(1 << 20))}"
                         for j in range(1 + i % 3)}
                     for i, p in enumerate(tkeys)}

        def set_tags(p):
            body = "".join(f"<Tag><Key>{k}</Key><Value>{v}</Value></Tag>"
                           for k, v in want_tags[p].items())
            r = s3("PUT", f"{p}?tagging",
                   f"<Tagging><TagSet>{body}</TagSet></Tagging>".encode())
            if r.status_code != 200:
                fail(f"20c: PUT {p}?tagging: {r.status_code} {r.text}")

        _pool_map(set_tags, tkeys, threads=FORM_THREADS)
        untag = tkeys[::len(tkeys) // FORM_UNTAGGED][:FORM_UNTAGGED]
        for p in untag:
            r = s3("DELETE", f"{p}?tagging")
            if r.status_code != 204:
                fail(f"20c: DELETE {p}?tagging: {r.status_code}")
            want_tags[p] = {}
        got_tags = dict(zip(tkeys, _pool_map(
            lambda p: _tag_set(s3("GET", f"{p}?tagging")), tkeys,
            threads=FORM_THREADS)))
        if got_tags != want_tags:
            bad = [p for p in tkeys if got_tags[p] != want_tags[p]]
            fail(f"20c: GET ?tagging differs from what was set for "
                 f"{len(bad)} objects, e.g. {bad[0]}: {got_tags[bad[0]]}")
        walls["c"] = time.perf_counter() - t0
        log(f"[20c] {len(tkeys)} objects in {tag}: "
            f"{len(header_tags)} PUT with x-amz-tagging (GET ?tagging: an "
            f"empty TagSet, as the reference's gateway stores none from "
            f"the header), every one tagged by PUT ?tagging (1-3 tags), "
            f"{len(untag)} cleared by DELETE ?tagging (204); every GET "
            f"?tagging equal to what was set; {walls['c']:.3f} s")

        # 20d. browser form uploads signed by a POST policy
        t0 = time.perf_counter()
        form_objects = {f"/{form}/f/o-{i:04d}.bin": d
                        for i, d in enumerate(_form_objects(2))}
        big = {f"/{form}/f/big-{i}.bin":
               np.random.default_rng([SEED, 20, 4, i]).bytes(FORM_BIG[1])
               for i in range(FORM_BIG[0])}
        fields = _form_policy(form, "f/", 2 * FORM_BIG[1])
        lat_form: list[float] = []

        def form_etag(data: bytes) -> str:
            """The filer's ETag of a form upload, as the reference's
            gateway answers it: the md5 of one chunk, else ETagChunks of
            the filer's FORM_CHUNK pieces."""
            pieces = [data[i:i + FORM_CHUNK]
                      for i in range(0, len(data), FORM_CHUNK)]
            if len(pieces) == 1:
                return hashlib.md5(data).hexdigest()
            joined = b"".join(hashlib.md5(p).digest() for p in pieces)
            return f"{hashlib.md5(joined).hexdigest()}-{len(pieces)}"

        def upload(path, data):
            t1 = time.perf_counter()
            r = _form_post(f"{gateway}/{form}",
                           {**fields, "key": path.split("/", 2)[2]},
                           path.rsplit("/", 1)[1], data)
            if r.status_code != 204 or r.headers.get("ETag", "").strip(
                    '"') != form_etag(data):
                fail(f"20d: form upload {path}: {r.status_code} "
                     f"{r.headers.get('ETag')} {r.text[:200]}")
            return time.perf_counter() - t1

        t1 = time.perf_counter()
        lat_form = _pool_map(lambda p: upload(p, form_objects[p]),
                             sorted(form_objects), threads=FORM_THREADS)
        t_form = time.perf_counter() - t1
        t1 = time.perf_counter()
        _pool_map(lambda p: upload(p, big[p]), sorted(big), threads=4)
        t_big = time.perf_counter() - t1
        form_objects.update(big)
        objects.update(form_objects)

        def check(path):
            r = s3("GET", path)
            if r.status_code != 200 or _sha(r.content) != _sha(objects[path]):
                fail(f"20d: GET {path}: {r.status_code}, sha256 off")

        _pool_map(check, sorted(form_objects), threads=FORM_THREADS)
        refused = {
            "expired policy": (_form_post(
                f"{gateway}/{form}", {**_form_policy(form, "f/", 1 << 20,
                                                     expire_in=-60),
                                      "key": "f/late.bin"}, "late.bin",
                b"late"), 403, "AccessDenied"),
            "key outside starts-with": (_form_post(
                f"{gateway}/{form}", {**fields, "key": "g/out.bin"},
                "out.bin", b"out"), 403, "AccessDenied"),
            "past content-length-range": (_form_post(
                f"{gateway}/{form}", {**_form_policy(form, "f/", 1 << 10),
                                      "key": "f/big.bin"}, "big.bin",
                bytes(4 << 10)), 400, "EntityTooLarge")}
        for what, (r, status, code) in refused.items():
            if (r.status_code, _s3_code(r)) != (status, code):
                fail(f"20d: {what}: {r.status_code} {_s3_code(r)}, the "
                     f"reference answers {status} {code}")
        for k in ("f/late.bin", "g/out.bin", "f/big.bin"):
            if s3("HEAD", f"/{form}/{k}").status_code != 404:
                fail(f"20d: a refused upload stored {k}")
        walls["d"] = time.perf_counter() - t0
        big_bytes = FORM_BIG[0] * FORM_BIG[1]
        log(f"[20d] {FORM_OBJECTS} form uploads of {FORM_OBJ_LO}-"
            f"{FORM_OBJ_HI} B on {FORM_THREADS} threads {t_form:.3f} s, "
            f"{FORM_OBJECTS / t_form:.1f} objects/s, {_lat(lat_form)}; "
            f"{FORM_BIG[0]} x {FORM_BIG[1]} B on 4 threads {t_big:.3f} s, "
            f"{big_bytes / t_big / 1e6:.1f} MB/s; every object read back "
            f"equal; refused as the reference refuses: "
            f"{ {k: (v[1], v[2]) for k, v in refused.items()} }")

        # 20e. lifecycle and ownership; the 501 set; the HTML listing
        t0 = time.perf_counter()
        rule = ("<LifecycleConfiguration><Rule><ID>tmp</ID><Status>Enabled"
                "</Status><Filter><Prefix>tmp/</Prefix></Filter><Expiration>"
                "<Days>7</Days></Expiration></Rule></LifecycleConfiguration>")
        r = s3("PUT", f"/{tag}?lifecycle", rule.encode())
        if r.status_code != 200:
            fail(f"20e: PUT ?lifecycle: {r.status_code} {r.text}")
        conf = session().get(f"{filer}/kv/filer.conf", timeout=30)
        rules = [x for x in json.loads(conf.content)["rules"]
                 if x["location_prefix"].startswith(f"/buckets/{tag}/")]
        if [(x["location_prefix"], x["ttl"]) for x in rules] != [
                (f"/buckets/{tag}/tmp/", "7d")]:
            fail(f"20e: filer.conf after PUT ?lifecycle: {rules}")
        got = s3("GET", f"/{tag}?lifecycle")
        days = [d.text for d in ET.fromstring(got.content).iter()
                if d.tag.endswith("Days")]
        prefixes = [d.text for d in ET.fromstring(got.content).iter()
                    if d.tag.endswith("Prefix")]
        if got.status_code != 200 or (days, prefixes) != (["7"], ["tmp/"]):
            fail(f"20e: GET ?lifecycle {got.status_code} {got.text}")
        if s3("DELETE", f"/{tag}?lifecycle").status_code != 204:
            fail("20e: DELETE ?lifecycle")
        conf = json.loads(session().get(f"{filer}/kv/filer.conf",
                                        timeout=30).content)
        if any(x["ttl"] for x in conf["rules"]
               if x["location_prefix"].startswith(f"/buckets/{tag}/")) or \
                s3("GET", f"/{tag}?lifecycle").status_code != 404:
            fail(f"20e: filer.conf after DELETE ?lifecycle: {conf}")
        own = ("<OwnershipControls><Rule><ObjectOwnership>"
               "BucketOwnerEnforced</ObjectOwnership></Rule>"
               "</OwnershipControls>").encode()
        steps = [s3("PUT", f"/{pub}?ownershipControls", own).status_code,
                 s3("GET", f"/{pub}?ownershipControls"),
                 s3("DELETE", f"/{pub}?ownershipControls").status_code,
                 s3("GET", f"/{pub}?ownershipControls").status_code]
        if steps[0] != 200 or steps[1].status_code != 200 or \
                b"BucketOwnerEnforced" not in steps[1].content or \
                steps[2:] != [204, 404]:
            fail(f"20e: ownership controls: {steps}")
        refused_501 = {}
        for method, q in (("GET", f"/{pub}?policy"), ("GET", f"/{pub}?cors"),
                          ("GET", f"{pub_keys[0]}?acl"),
                          ("GET", f"{pub_keys[0]}?retention"),
                          ("GET", f"{pub_keys[0]}?legal-hold"),
                          ("GET", f"{pub_keys[0]}?object-lock")):
            r = s3(method, q)
            refused_501[q.rsplit("?", 1)[1]] = (r.status_code, _s3_code(r))
        if set(refused_501.values()) != {(501, "NotImplemented")}:
            fail(f"20e: the sub-resources the reference refuses: "
                 f"{refused_501}")

        class Links(html.parser.HTMLParser):
            def __init__(self):
                super().__init__()
                self.hrefs = []

            def handle_starttag(self, t, attrs):
                if t == "a":
                    self.hrefs.append(dict(attrs)["href"])

        page = session().get(f"{filer}/buckets/{pub}", timeout=30,
                             headers={"Accept": "text/html"})
        links = Links()
        links.feed(page.text)
        listed = sorted(h.rsplit("/", 1)[1] for h in links.hrefs[1:])
        if page.status_code != 200 or not page.headers.get(
                "Content-Type", "").startswith("text/html") or \
                listed != [p.rsplit("/", 1)[1] for p in pub_keys]:
            fail(f"20e: the filer's HTML listing of /buckets/{pub}: "
                 f"{page.status_code}, {len(listed)} links")
        walls["e"] = time.perf_counter() - t0
        log(f"[20e] PUT ?lifecycle (Days 7 on tmp/) put "
            f"{[(x['location_prefix'], x['ttl']) for x in rules]} into "
            f"filer.conf, GET ?lifecycle mirrored it, DELETE took it out; "
            f"ownership controls PUT/GET/DELETE {steps[0]}/"
            f"{steps[1].status_code}/{steps[2]}, then {steps[3]}; 501 "
            f"NotImplemented: {sorted(refused_501)}; the filer's text/html "
            f"listing of /buckets/{pub} links exactly its {len(listed)} "
            f"keys; {walls['e']:.3f} s")

        # 20f. seal the three buckets' volumes; anonymous reads degraded
        # and rebuilt
        t0 = time.perf_counter()
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        vids = sorted({v for b in (pub, tag, form)
                       for v in _bucket_vids(env, b)})
        dat = {}
        for vid in vids:
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat[vid] = v.content_size()
        repl.run_command(env, "lock")
        before_stages = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before_stages["kernel"]
        want = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if launches["encode"] <= 0 or launches["encode"] != want or \
                launches["encode"] != len(vids) or \
                scraped != launches["encode"]:
            fail(f"20f: {launches['encode']} launches sealing {len(vids)} "
                 f"volumes, the .dat sizes give {want}, /metrics "
                 f"cuda_kernel_launches {scraped}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"20f: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        pub_vids = set(_bucket_vids(env, pub)) or set(vids)
        largest = max(pub_vids, key=lambda v: (dat.get(v, 0), v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"20f: {victim} holds more than m=4 shards of a volume: "
                 f"{lost}")
        t1 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        degraded = anon_pass("20f degraded")
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped_r = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped_r != launches["rebuild"]:
            fail(f"20f: ec.rebuild: {launches['rebuild']} launches, the "
                 f"volume servers' cuda_kernel_launches {scraped_r}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"20f: volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        rebuilt = anon_pass("20f rebuilt")
        _pool_map(check, sorted(form_objects) + tkeys, threads=FORM_THREADS)
        repl.run_command(env, "unlock")
        walls["f"] = time.perf_counter() - t0
        log(f"[20f] ec.encode of the {len(vids)} volumes of {pub}, {tag} "
            f"and {form} ({dat} .dat bytes) {t_encode:.3f} s, "
            f"{launches['encode']} launches (one a volume; /metrics "
            f"cuda_kernel_launches {scraped}); kernel {kernel_s * 1e3:.3f} "
            f"ms (CUDA events), {kernel_s * 1e3 / launches['encode']:.3f} "
            f"ms per launch; stopped {victim} (shards {lost}), dropped in "
            f"{t_gone:.3f} s; unsigned GET + HEAD of {pub} degraded: "
            f"{degraded['rate']:.1f} objects/s, {degraded['mbps']:.2f} "
            f"MB/s, GET {_lat(degraded['lat'])}; ec.rebuild "
            f"{t_rebuild:.3f} s, {launches['rebuild']} launches (/metrics "
            f"{scraped_r}); rebuilt: "
            f"{rebuilt['rate']:.1f} objects/s, {rebuilt['mbps']:.2f} MB/s, "
            f"GET {_lat(rebuilt['lat'])}; every object of the three "
            f"buckets equal")
        for name, proc in procs.items():
            if proc.poll() is not None:
                fail(f"the {name} process exited: {_tail(logs[name])}")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 20 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[20] phase 20 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); kernel "
            f"launches {launches}; the seal's kernel time "
            f"{kernel_s * 1e3:.3f} ms is {busy:.5%} of the phase wall "
            f"(idle share {1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        return launches
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 21: the filer's protocol gateways (WebDAV, FTP, IAM, the mq
# broker) as CLI processes; their files and records sealed, read
# degraded and rebuilt through the kernel
# ----------------------------------------------------------------------
GW_COLLECTIONS = 8                # 21b's WebDAV collections (MKCOL)
GW_DAV_FILES = 512                # 21b's PUTs, 1-64 KiB, log-uniform
GW_OBJ_LO, GW_OBJ_HI = 1 << 10, 64 << 10
GW_MOVES = GW_COPIES = 64         # 21b's MOVEs and COPYs
GW_BIG = (4, 16 << 20)            # (count, bytes) of 21b's large PUTs
GW_FTP_SESSIONS = 4               # 21c's concurrent FTP sessions
GW_FTP_FILES = 256                # 21c's STORs, 1-64 KiB, log-uniform
GW_FTP_BIG = (2, 16 << 20)        # (count, bytes) of 21c's large STORs
GW_MQ_PARTITIONS = 4
GW_MQ_RECORDS = 16384             # 21e's records, 64 B-4 KiB, log-uniform
GW_MQ_LO, GW_MQ_HI = 64, 4 << 10
GW_MQ_KEYS = 1024
GW_MQ_BATCH = 256                 # records per batched publish
GW_MQ_THREADS = 4
GW_MQ_SINGLE = 256                # 21e's single publishes (ack p50 / p99)
GW_MQ_AFTER = 1024                # records published after the restart
GW_VOLUME_LIMIT = 64 << 20        # the master's volume size limit
GW_THREADS = 8
GW_DEADLINE = 60.0                # longest wait for a process to serve
GW_USER = ("smoke21", "smoke21-ftp-password")


def _gw_sizes(n: int, lo: int, hi: int, salt: int) -> list[bytes]:
    """Seeded payloads, log-uniform in [lo, hi]."""
    rng = np.random.default_rng([SEED, 21, salt])
    sizes = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    return [rng.bytes(int(k)) for k in sizes]


def _gw_records() -> list[dict]:
    """21e's records, from the seed: keys from GW_MQ_KEYS, values
    64 B-4 KiB; every 16th value is not UTF-8 and goes as value64."""
    import base64

    rng = np.random.default_rng([SEED, 21, 5])
    keys = rng.integers(GW_MQ_KEYS, size=GW_MQ_RECORDS)
    out = []
    for i, v in enumerate(_gw_sizes(GW_MQ_RECORDS, GW_MQ_LO, GW_MQ_HI, 6)):
        rec = {"key": f"user-{int(keys[i]):04d}"}
        if i % 16 == 0:
            rec["value64"] = base64.b64encode(b"\xff" + v).decode()
        else:
            rec["value"] = v.hex()[:len(v)]
        out.append(rec)
    return out


def _gw_value(rec: dict) -> str:
    """A published record's value as a subscription carries it."""
    import base64

    if "value64" in rec:
        return "v64:" + rec["value64"]
    return "v:" + rec["value"]


def phase_gateways(card: str) -> dict:
    """Phase 21: the CLI filer on leveldb, the CLI S3 gateway and the
    four protocol gateways (webdav, ftp, iam, mq.broker) as processes
    over an in-process master and four volume servers on "cuda"; WebDAV
    and FTP files, IAM keys and mq records; their volumes sealed, read
    degraded and rebuilt through the kernel. -> kernel launches by step
    and the phase's numbers."""
    import ftplib
    import io
    import re
    import signal

    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv, ShellError

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke21-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    cluster = env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    try:
        # 21a. the cluster, then the filer, the S3 gateway and the four
        # gateways as processes of the CLI, probed by a TCP connect
        t0 = time.perf_counter()
        cluster = Cluster(os.path.join(tmp, "main"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=GW_VOLUME_LIMIT,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        fport, sport, dport, ftport, iport, bport = free_ports(6)
        filer = f"http://127.0.0.1:{fport}"
        gateway = f"http://127.0.0.1:{sport}"
        dav = f"http://127.0.0.1:{dport}"
        iam = f"http://127.0.0.1:{iport}/"
        broker = f"http://127.0.0.1:{bport}"
        s3_conf = os.path.join(tmp, "s3.json")
        with open(s3_conf, "w") as f:
            json.dump(S3_CONFIG, f)

        def start(name: str, args: list[str], port: int) -> float:
            return _serve_cli(procs, logs, tmp, name, args, port,
                              GW_DEADLINE)

        broker_argv = ["mq.broker", "-port", str(bport), "-filer", filer,
                       "-master", cluster.master_url]
        took = {"filer": start("filer", [
            "filer", "-port", str(fport), "-master", cluster.master_url,
            "-store", "leveldb", "-store.path",
            os.path.join(tmp, "filerdb")], fport)}
        for name, args, port in (
                ("s3", ["s3", "-port", str(sport), "-filer", filer,
                        "-config", s3_conf], sport),
                ("webdav", ["webdav", "-port", str(dport), "-filer", filer],
                 dport),
                ("ftp", ["ftp", "-port", str(ftport), "-filer", filer,
                         "-user", ":".join(GW_USER)], ftport),
                ("iam", ["iam", "-port", str(iport), "-filer", filer], iport),
                ("mq.broker", broker_argv, bport)):
            took[name] = start(name, args, port)
        env = CommandEnv(cluster.master_url, filer_url=filer)
        s3 = _S3Client(gateway)
        walls["a"] = time.perf_counter() - t0
        log(f"[21] {card}; master {cluster.master_url}, 4 volume servers "
            f"ec_backend='cuda', volume limit {GW_VOLUME_LIMIT} B; CLI "
            f"processes listening after (s) "
            f"{ {k: round(v, 3) for k, v in took.items()} }: `filer -store "
            f"leveldb`, `s3 -config`, `webdav`, `ftp -user`, `iam`, "
            f"`mq.broker -master`; set-up {walls['a']:.3f} s")

        def req(method: str, url: str, **kw):
            return session().request(method, url, timeout=(5.0, 300.0),
                                     **kw)

        # 21b. WebDAV: collections, small files, moves, copies, a lock,
        # large files
        t0 = time.perf_counter()
        cols = [f"/dav21/c{i}" for i in range(GW_COLLECTIONS)]
        if req("MKCOL", dav + "/dav21").status_code != 201:
            fail("21b: MKCOL /dav21")
        for c in cols:
            r = req("MKCOL", dav + c)
            if r.status_code != 201:
                fail(f"21b: MKCOL {c}: {r.status_code}")
        if req("MKCOL", dav + cols[0]).status_code != 405:
            fail("21b: MKCOL of an existing collection: not 405")
        files = {f"{cols[i % GW_COLLECTIONS]}/f-{i:04d}.bin": d for i, d in
                 enumerate(_gw_sizes(GW_DAV_FILES, GW_OBJ_LO, GW_OBJ_HI, 1))}
        lat_put: list[float] = []

        def dav_put(path: str) -> None:
            t1 = time.perf_counter()
            r = req("PUT", dav + path, data=files[path])
            if r.status_code != 201:
                fail(f"21b: PUT {path}: {r.status_code}")
            lat_put.append(time.perf_counter() - t1)

        t1 = time.perf_counter()
        _pool_map(dav_put, sorted(files), threads=GW_THREADS)
        t_put = time.perf_counter() - t1

        def dav_pass(label: str, paths: list[str]) -> dict:
            lat: list[float] = []

            def one(path: str) -> int:
                t1 = time.perf_counter()
                r = req("GET", dav + path)
                if r.status_code != 200 or \
                        _sha(r.content) != _sha(files[path]):
                    fail(f"{label}: WebDAV GET {path}: {r.status_code}, "
                         f"{len(r.content)} B of {len(files[path])}")
                lat.append(time.perf_counter() - t1)
                return len(r.content)

            t1 = time.perf_counter()
            nb = sum(_pool_map(one, paths, threads=GW_THREADS))
            w = time.perf_counter() - t1
            return {"wall": w, "rate": len(paths) / w, "mbps": nb / w / 1e6,
                    "lat": lat}

        small = sorted(files)
        healthy = dav_pass("21b", small)
        # MOVE and COPY: each of a seeded choice, into the next collection
        rng = np.random.default_rng([SEED, 21, 2])
        picked = [small[int(i)] for i in rng.permutation(len(small))[
            :GW_MOVES + GW_COPIES]]
        for n, src in enumerate(picked):
            col = cols[(cols.index(src.rsplit("/", 1)[0]) + 1) %
                       GW_COLLECTIONS]
            op = "MOVE" if n < GW_MOVES else "COPY"
            dest = f"{col}/{op.lower()}-{src.rsplit('/', 1)[1]}"
            r = req(op, dav + src, headers={"Destination": dav + dest})
            if r.status_code != 201:
                fail(f"21b: {op} {src} -> {dest}: {r.status_code}")
            files[dest] = files[src]
            if op == "MOVE":
                del files[src]
        for path in picked[:GW_MOVES]:
            if req("GET", dav + path).status_code != 404:
                fail(f"21b: {path} still answers after its MOVE")
        r = req("COPY", dav + picked[-1], headers={
            "Destination": dav + picked[-2], "Overwrite": "F"})
        if r.status_code != 412:
            fail(f"21b: COPY onto an existing file, Overwrite F: "
                 f"{r.status_code}")
        # PROPFIND Depth 1 of each collection: exactly its files, sizes
        listed = {}
        for c in cols:
            r = req("PROPFIND", dav + c, headers={"Depth": "1"})
            if r.status_code != 207:
                fail(f"21b: PROPFIND {c}: {r.status_code}")
            hrefs = re.findall(rb"<D:href>([^<]*)</D:href>", r.content)
            sizes = re.findall(rb"<D:getcontentlength>(\d+)<", r.content)
            got = dict(zip((h.decode() for h in hrefs[1:]),
                           (int(s) for s in sizes[1:])))
            want = {p: len(d) for p, d in files.items()
                    if p.rsplit("/", 1)[0] == c}
            if hrefs[0].decode() != c + "/" or got != want:
                fail(f"21b: PROPFIND {c}: {len(got)} entries, "
                     f"{len(want)} expected")
            listed[c] = len(got)
        # a lock: a foreign token's PUT and LOCK get 423, the holder's
        # PUT goes through, UNLOCK frees it
        locked = sorted(files)[0]
        lock = req("LOCK", dav + locked)
        token = lock.headers.get("Lock-Token", "")
        foreign = "(<opaquelocktoken:00000000-0000-0000-0000-000000000000>)"
        refused = (req("PUT", dav + locked, data=b"x").status_code,
                   req("PUT", dav + locked, data=b"x",
                       headers={"If": foreign}).status_code,
                   req("LOCK", dav + locked,
                       headers={"If": foreign}).status_code,
                   req("DELETE", dav + locked).status_code)
        held = req("PUT", dav + locked, data=files[locked],
                   headers={"If": f"({token})"}).status_code
        unlocked = req("UNLOCK", dav + locked,
                       headers={"Lock-Token": token}).status_code
        if lock.status_code != 200 or refused != (423,) * 4 or \
                held != 201 or unlocked != 204:
            fail(f"21b: LOCK {lock.status_code}, refused {refused}, the "
                 f"holder's PUT {held}, UNLOCK {unlocked}")
        # large files
        big = {f"/dav21/big-{i}.bin":
               np.random.default_rng([SEED, 21, 3, i]).bytes(GW_BIG[1])
               for i in range(GW_BIG[0])}
        files.update(big)
        t1 = time.perf_counter()
        _pool_map(dav_put, sorted(big), threads=GW_BIG[0])
        t_big_put = time.perf_counter() - t1
        big_get = dav_pass("21b big", sorted(big))
        walls["b"] = time.perf_counter() - t0
        big_bytes = GW_BIG[0] * GW_BIG[1]
        log(f"[21b] WebDAV: {GW_COLLECTIONS} MKCOLs; {GW_DAV_FILES} PUTs "
            f"of {GW_OBJ_LO}-{GW_OBJ_HI} B on {GW_THREADS} threads "
            f"{t_put:.3f} s, {GW_DAV_FILES / t_put:.1f} files/s, PUT "
            f"{_lat(lat_put)}; GET of each {healthy['rate']:.1f} files/s, "
            f"{healthy['mbps']:.2f} MB/s, GET {_lat(healthy['lat'])}, "
            f"sha256-equal; {GW_MOVES} MOVEs, {GW_COPIES} COPYs (412 with "
            f"Overwrite F); PROPFIND Depth 1 of each collection exactly "
            f"its files and sizes {listed}; LOCK: a foreign token's PUT, "
            f"LOCK and DELETE 423, the holder's PUT 201, UNLOCK 204; "
            f"{GW_BIG[0]} x {GW_BIG[1]} B PUT {big_bytes / t_big_put / 1e6:.1f} "
            f"MB/s, GET {big_get['mbps']:.1f} MB/s; {walls['b']:.3f} s")

        # 21c. FTP: four sessions, small files, large files, a resumed
        # RETR, renames, deletes, directories, the listing
        t0 = time.perf_counter()

        def ftp_login() -> ftplib.FTP:
            f = ftplib.FTP()
            f.connect("127.0.0.1", ftport, timeout=120)
            f.login(*GW_USER)
            return f

        ftp_files = {f"/ftp21/s{i % GW_FTP_SESSIONS}/f-{i:04d}.bin": d
                     for i, d in enumerate(_gw_sizes(
                         GW_FTP_FILES, GW_OBJ_LO, GW_OBJ_HI, 4))}
        top = ftp_login()
        top.mkd("/ftp21")
        for s in range(GW_FTP_SESSIONS):
            top.mkd(f"/ftp21/s{s}")

        def session_run(s: int) -> list[float]:
            f = ftp_login()
            lat = []
            try:
                f.cwd(f"/ftp21/s{s}")
                mine = sorted(p for p in ftp_files
                              if p.startswith(f"/ftp21/s{s}/"))
                for p in mine:
                    t1 = time.perf_counter()
                    f.storbinary(f"STOR {p.rsplit('/', 1)[1]}",
                                 io.BytesIO(ftp_files[p]))
                    lat.append(time.perf_counter() - t1)
                for p in mine:
                    buf = io.BytesIO()
                    f.retrbinary(f"RETR {p.rsplit('/', 1)[1]}", buf.write)
                    if _sha(buf.getvalue()) != _sha(ftp_files[p]):
                        fail(f"21c: RETR {p}: {len(buf.getvalue())} B, "
                             f"sha256 off")
            finally:
                f.quit()
            return lat

        t1 = time.perf_counter()
        lat_stor = [x for lat in _pool_map(session_run,
                                           range(GW_FTP_SESSIONS),
                                           threads=GW_FTP_SESSIONS)
                    for x in lat]
        t_ftp = time.perf_counter() - t1
        ftp_big = {f"/ftp21/big-{i}.bin":
                   np.random.default_rng([SEED, 21, 7, i]).bytes(
                       GW_FTP_BIG[1]) for i in range(GW_FTP_BIG[0])}
        t1 = time.perf_counter()
        for p, d in ftp_big.items():
            top.storbinary(f"STOR {p}", io.BytesIO(d), blocksize=1 << 20)
        t_ftp_big = time.perf_counter() - t1
        ftp_files.update(ftp_big)

        def ftp_big_pass(label: str) -> float:
            t1 = time.perf_counter()
            f = ftp_login()
            try:
                for p, d in ftp_big.items():
                    buf = io.BytesIO()
                    f.retrbinary(f"RETR {p}", buf.write, blocksize=1 << 20)
                    if _sha(buf.getvalue()) != _sha(d):
                        fail(f"{label}: RETR {p}: sha256 off")
                mid = GW_FTP_BIG[1] // 2 + 12345
                buf = io.BytesIO()
                p = sorted(ftp_big)[0]
                f.retrbinary(f"RETR {p}", buf.write, rest=mid)
                if buf.getvalue() != ftp_big[p][mid:]:
                    fail(f"{label}: RETR {p} with REST {mid}")
            finally:
                f.quit()
            return len(ftp_big) * GW_FTP_BIG[1] / (time.perf_counter() -
                                                    t1) / 1e6

        ftp_mbps = ftp_big_pass("21c")
        # renames, a delete, a directory made and removed recursively
        small_ftp = sorted(p for p in ftp_files if p not in ftp_big)
        src = small_ftp[0]
        top.rename(src, src + ".renamed")
        ftp_files[src + ".renamed"] = ftp_files.pop(src)
        gone = small_ftp[1]
        top.delete(gone)
        del ftp_files[gone]
        top.mkd("/ftp21/tmp")
        top.storbinary("STOR /ftp21/tmp/x.bin", io.BytesIO(b"x" * 100))
        top.rmd("/ftp21/tmp")
        if "tmp" in top.nlst("/ftp21"):
            fail("21c: RMD left /ftp21/tmp")
        # LIST of each directory: the filer's own listing, name for name
        # and size for size
        for d in ["/ftp21"] + [f"/ftp21/s{s}" for s in
                               range(GW_FTP_SESSIONS)]:
            lines: list[str] = []
            top.retrlines(f"LIST {d}", lines.append)
            got = {ln.split()[-1]: int(ln.split()[4]) for ln in lines}
            entries = session().get(f"{filer}{d}", params={
                "limit": "10000"}, headers={"Accept": "application/json"},
                timeout=30).json()["entries"]
            want = {e["full_path"].rsplit("/", 1)[1]:
                    0 if e.get("mode", 0) & 0o40000 else
                    max([c["offset"] + c["size"]
                         for c in e.get("chunks") or []] or [0])
                    for e in entries}
            mine = {p.rsplit("/", 1)[1]: len(v) for p, v in ftp_files.items()
                    if p.rsplit("/", 1)[0] == d}
            if got != want or any(got.get(k) != v for k, v in mine.items()):
                fail(f"21c: LIST {d}: {len(got)} lines, the filer lists "
                     f"{len(want)}")
        top.quit()
        walls["c"] = time.perf_counter() - t0
        log(f"[21c] FTP: {GW_FTP_SESSIONS} sessions, {GW_FTP_FILES} STORs "
            f"of {GW_OBJ_LO}-{GW_OBJ_HI} B then a RETR of each "
            f"{t_ftp:.3f} s (STOR {_lat(lat_stor)}), sha256-equal; "
            f"{GW_FTP_BIG[0]} x {GW_FTP_BIG[1]} B STOR "
            f"{GW_FTP_BIG[0] * GW_FTP_BIG[1] / t_ftp_big / 1e6:.1f} MB/s, "
            f"RETR and a REST from mid-file {ftp_mbps:.1f} MB/s; RNFR/RNTO, "
            f"DELE, MKD and a recursive RMD; LIST of each directory equal "
            f"to the filer's listing; {walls['c']:.3f} s")

        # 21d. IAM: a user, a key and a policy; the S3 gateway (the CLI
        # process reloads identities every 5 s) takes the key, refuses
        # it on another bucket, and refuses it once deleted
        t0 = time.perf_counter()
        for b in ("s21-iam", "s21-other"):
            r = s3("PUT", f"/{b}")
            if r.status_code != 200:
                fail(f"21d: CreateBucket {b}: {r.status_code} {r.text}")

        def iam_call(**form):
            r = req("POST", iam, data=urllib.parse.urlencode(form),
                    headers={"Content-Type":
                             "application/x-www-form-urlencoded"})
            if r.status_code != 200:
                fail(f"21d: IAM {form.get('Action')}: {r.status_code} "
                     f"{r.text}")
            return r.text

        iam_call(Action="CreateUser", UserName="smoke21")
        body = iam_call(Action="CreateAccessKey", UserName="smoke21")
        ak = re.search(r"<AccessKeyId>([^<]+)<", body).group(1)
        sk = re.search(r"<SecretAccessKey>([^<]+)<", body).group(1)
        iam_call(Action="PutUserPolicy", UserName="smoke21",
                 PolicyName="rw", PolicyDocument=json.dumps({
                     "Statement": [{"Effect": "Allow",
                                    "Action": ["s3:GetObject",
                                               "s3:PutObject"],
                                    "Resource": "arn:aws:s3:::s21-iam/*"}]}))
        t_policy = time.perf_counter()
        minted = _S3Client(gateway, ak, sk)
        payload = b"minted by iam"
        _poll(lambda: minted("PUT", "/s21-iam/k.bin", payload).status_code
              == 200, 30.0, "21d: the S3 gateway taking the minted key",
              step=0.1)
        t_taken = time.perf_counter() - t_policy
        got = minted("GET", "/s21-iam/k.bin")
        other = minted("PUT", "/s21-other/k.bin", payload)
        if got.content != payload or other.status_code != 403:
            fail(f"21d: GET with the minted key {got.status_code}, PUT in "
                 f"another bucket {other.status_code}")
        iam_call(Action="DeleteAccessKey", UserName="smoke21",
                 AccessKeyId=ak)
        t_del = time.perf_counter()
        _poll(lambda: minted("PUT", "/s21-iam/k2.bin",
                             payload).status_code == 403, 30.0,
              "21d: the S3 gateway refusing the deleted key", step=0.1)
        t_refused = time.perf_counter() - t_del
        doc = json.loads(session().get(f"{filer}/kv/s3/identities",
                                       timeout=30).content)
        if [(i["name"], i["credentials"], i["actions"])
                for i in doc["identities"]] != [
                ("smoke21", [], ["Read:s21-iam", "Write:s21-iam"])]:
            fail(f"21d: the identities document: {doc}")
        walls["d"] = time.perf_counter() - t0
        log(f"[21d] IAM: CreateUser, CreateAccessKey, PutUserPolicy (Read "
            f"and Write on s21-iam); the CLI S3 gateway took a signed PUT "
            f"with the new key {t_taken:.3f} s after the policy, answered "
            f"403 in s21-other; after DeleteAccessKey it refused the key "
            f"in {t_refused:.3f} s; s3/identities in the filer KV as the "
            f"reference writes it; {walls['d']:.3f} s")

        # 21e. mq: a topic from the shell, batched and single publishes,
        # a subscription of each partition, a SIGINT and a restart
        t0 = time.perf_counter()

        def shell(line: str):
            """The shell's command, run again while the membership lists
            no broker (it drops one between announces, ROADMAP Queue 3
            item 10)."""
            end = time.monotonic() + 30
            while True:
                try:
                    return repl.run_command(env, line)
                except ShellError as e:
                    if "no mq broker registered" not in str(e) or \
                            time.monotonic() > end:
                        raise
                    time.sleep(0.05)

        conf = shell(f"mq.topic.create -namespace=smoke -topic=t21 "
                     f"-partitions={GW_MQ_PARTITIONS}")
        if conf != {"namespace": "smoke", "name": "t21",
                    "partitions": GW_MQ_PARTITIONS}:
            fail(f"21e: mq.topic.create: {conf}")
        records = _gw_records()
        pub = f"{broker}/topics/smoke/t21/publish"
        acked: dict[tuple[int, int], str] = {}
        acked_lock = threading.Lock()

        def publish(batch: list[dict]) -> list[dict]:
            r = req("POST", pub, json={"records": batch})
            if r.status_code != 200:
                fail(f"21e: publish: {r.status_code} {r.text[:200]}")
            acks = r.json()["acks"]
            with acked_lock:
                for rec, a in zip(batch, acks):
                    k = (a["partition"], a["offset"])
                    if k in acked:
                        fail(f"21e: offset {k} acked twice")
                    acked[k] = _gw_value(rec)
            return acks

        batches = [records[i:i + GW_MQ_BATCH]
                   for i in range(0, len(records), GW_MQ_BATCH)]
        t1 = time.perf_counter()
        _pool_map(publish, batches, threads=GW_MQ_THREADS)
        t_batch = time.perf_counter() - t1
        mq_bytes = sum(len(r.get("value", r.get("value64", "")))
                       for r in records)
        singles = _gw_records()[:GW_MQ_SINGLE]
        lat_ack: list[float] = []
        for rec in singles:
            t1 = time.perf_counter()
            publish([rec])
            lat_ack.append(time.perf_counter() - t1)

        def replay(p: int, label: str) -> dict[int, str]:
            r = req("GET", f"{broker}/topics/smoke/t21/subscribe",
                    params={"partition": str(p), "offset": "0",
                            "idle_timeout": "0.5"})
            if r.status_code != 200:
                fail(f"{label}: subscribe p{p}: {r.status_code}")
            out: dict[int, str] = {}
            for line in r.content.splitlines():
                rec = json.loads(line)
                if rec["o"] in out:
                    fail(f"{label}: p{p} offset {rec['o']} twice")
                out[rec["o"]] = ("v64:" + rec["v64"]) if "v64" in rec \
                    else "v:" + rec["v"]
            return out

        def check_replay(label: str, parts=range(GW_MQ_PARTITIONS)) -> float:
            t1 = time.perf_counter()
            got = _pool_map(lambda p: (p, replay(p, label)), list(parts),
                            threads=GW_MQ_PARTITIONS)
            w = time.perf_counter() - t1
            for p, recs in got:
                want = {o: v for (q, o), v in acked.items() if q == p}
                if recs != want:
                    miss = sorted(set(want) - set(recs))[:5]
                    odd = sorted(o for o in recs
                                 if recs[o] != want.get(o))[:5]
                    fail(f"{label}: p{p} replayed {len(recs)} of "
                         f"{len(want)} acked records; missing {miss}, "
                         f"differing {odd}")
            return w

        t_replay = check_replay("21e")
        n_acked = len(acked)
        # the key's partition: md5 of the key, modulo the partitions
        sample = records[0]
        hp = int(hashlib.md5(sample["key"].encode()).hexdigest(), 16) % \
            GW_MQ_PARTITIONS
        if not any(q == hp and v == _gw_value(sample)
                   for (q, _), v in acked.items()):
            fail("21e: a key's records are not in its md5 partition")
        before = shell("mq.topic.describe -namespace=smoke -topic=t21")
        # SIGINT: the broker flushes its tail and leaves; then again
        t1 = time.perf_counter()
        procs["mq.broker"].send_signal(signal.SIGINT)
        rc = procs["mq.broker"].wait(timeout=60)
        if rc != 0:
            fail(f"21e: the broker exited {rc} on SIGINT: "
                 f"{_tail(logs['mq.broker'])}")
        del procs["mq.broker"]
        t_restart = start("mq.broker", broker_argv, bport)
        after = shell("mq.topic.describe -namespace=smoke -topic=t21")
        t_back = time.perf_counter() - t1
        if after != before or sum(s["next_offset"] for s in
                                  after["state"]) != n_acked:
            fail(f"21e: offsets after the restart {after['state']}, "
                 f"before {before['state']}, {n_acked} acked")
        more = _gw_sizes(GW_MQ_AFTER, GW_MQ_LO, GW_MQ_HI, 8)
        acks = publish([{"key": f"user-{i % GW_MQ_KEYS:04d}",
                         "value": v.hex()[:len(v)]}
                        for i, v in enumerate(more)])
        nxt = {s["partition"]: s["next_offset"] for s in after["state"]}
        for p in range(GW_MQ_PARTITIONS):
            offs = [a["offset"] for a in acks if a["partition"] == p]
            if offs != list(range(nxt[p], nxt[p] + len(offs))):
                fail(f"21e: p{p} offsets after the restart {offs[:3]}..., "
                     f"expected from {nxt[p]}")
        t_replay2 = check_replay("21e after the restart")
        walls["e"] = time.perf_counter() - t0
        log(f"[21e] mq: `mq.topic.create` of {GW_MQ_PARTITIONS} partitions "
            f"from the shell; {GW_MQ_RECORDS} records of {GW_MQ_LO}-"
            f"{GW_MQ_HI} B (keys from {GW_MQ_KEYS}) in batches of "
            f"{GW_MQ_BATCH} from {GW_MQ_THREADS} threads {t_batch:.3f} s, "
            f"{GW_MQ_RECORDS / t_batch:.1f} records/s, "
            f"{mq_bytes / t_batch / 1e6:.2f} MB/s; {GW_MQ_SINGLE} single "
            f"publishes, ack {_lat(lat_ack)}; a subscription of each "
            f"partition from 0 returned every acked (partition, offset) "
            f"once with its value ({n_acked} records, {t_replay:.3f} s); "
            f"SIGINT: exit 0, listening again after {t_restart:.3f} s "
            f"({t_back:.3f} s to the describe), offsets "
            f"{[s['next_offset'] for s in after['state']]} kept, "
            f"{GW_MQ_AFTER} more continue them; the replay equal again "
            f"({t_replay2:.3f} s); {walls['e']:.3f} s")

        # 21f. seal every volume that holds the phase's data; read it
        # degraded and rebuilt
        t0 = time.perf_counter()
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        dat = {}
        for vid in sorted({int(v) for n in env.data_nodes()
                           for v in n.get("collections", {})}):
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    if v.content_size() > 8:    # past the super block
                        dat[vid] = v.content_size()
        vids = sorted(dat)
        repl.run_command(env, "lock")
        before_stages = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before_stages["kernel"]
        want = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if launches["encode"] <= 0 or launches["encode"] != want or \
                launches["encode"] != len(vids) or \
                scraped != launches["encode"]:
            fail(f"21f: {launches['encode']} launches sealing {len(vids)} "
                 f"volumes, the .dat sizes give {want}, /metrics "
                 f"cuda_kernel_launches {scraped}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"21f: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"21f: {victim} holds more than m=4 shards of a volume: "
                 f"{lost}")

        def sealed_pass(label: str) -> dict:
            t1 = time.perf_counter()
            dav_out = dav_pass(label, sorted(files))
            ftp_mb = ftp_big_pass(label)
            t2 = time.perf_counter()
            check_replay(label, parts=[0])
            return {"dav": dav_out, "ftp_mbps": ftp_mb,
                    "mq_s": time.perf_counter() - t2,
                    "wall": time.perf_counter() - t1}

        t1 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        degraded = sealed_pass("21f degraded")
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped_r = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped_r != launches["rebuild"]:
            fail(f"21f: ec.rebuild: {launches['rebuild']} launches, the "
                 f"volume servers' cuda_kernel_launches {scraped_r}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"21f: volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        rebuilt = sealed_pass("21f rebuilt")
        check_replay("21f rebuilt, every partition")
        repl.run_command(env, "unlock")
        walls["f"] = time.perf_counter() - t0
        log(f"[21f] ec.encode of the {len(vids)} volumes holding the "
            f"phase's data ({dat} .dat bytes) {t_encode:.3f} s, "
            f"{launches['encode']} launches (one a volume; /metrics "
            f"cuda_kernel_launches {scraped}); kernel "
            f"{kernel_s * 1e3:.3f} ms (CUDA events), "
            f"{kernel_s * 1e3 / max(1, launches['encode']):.3f} ms per "
            f"launch; stopped {victim} (shards {lost}), dropped in "
            f"{t_gone:.3f} s; degraded: WebDAV GET of all "
            f"{len(files)} files {degraded['dav']['rate']:.1f} files/s "
            f"({degraded['dav']['mbps']:.2f} MB/s, GET "
            f"{_lat(degraded['dav']['lat'])}), FTP RETR of the big ones "
            f"{degraded['ftp_mbps']:.1f} MB/s, the mq replay of p0 "
            f"{degraded['mq_s']:.3f} s, all equal; ec.rebuild "
            f"{t_rebuild:.3f} s, {launches['rebuild']} launches (/metrics "
            f"{scraped_r}); rebuilt: {rebuilt['dav']['rate']:.1f} files/s "
            f"({rebuilt['dav']['mbps']:.2f} MB/s, GET "
            f"{_lat(rebuilt['dav']['lat'])}), FTP {rebuilt['ftp_mbps']:.1f} "
            f"MB/s, p0 {rebuilt['mq_s']:.3f} s; every partition replayed "
            f"equal")
        for name, proc in procs.items():
            if proc.poll() is not None:
                fail(f"the {name} process exited: {_tail(logs[name])}")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 21 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[21] phase 21 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); kernel "
            f"launches {launches}; the seal's kernel time "
            f"{kernel_s * 1e3:.3f} ms is {busy:.5%} of the phase wall "
            f"(idle share {1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        return launches
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 22: the FUSE mount, a CLI `mount` process through the kernel
# (or WeedFS in this process, where the machine cannot mount), over a
# CLI filer run with the global profiling and pushgateway flags; the
# mounted files sealed, read degraded and rebuilt through the kernel
# ----------------------------------------------------------------------
FUSE_ROOT = "/fuse22"             # the phase's directory in the mount
FUSE_DIRS = 8                     # 22b's directories
FUSE_FILES = 256                  # 22b's files, 1-64 KiB, log-uniform
                                  # (cut from 512: PERF.md §4)
FUSE_LO, FUSE_HI = 1 << 10, 64 << 10
FUSE_BIG = (4, 16 << 20)          # (count, bytes) of 22c's sequential files
FUSE_BLOCK = 1 << 20              # their write size (fio bs=1m)
FUSE_RANDOM = 8 << 20             # 22c's random-write file, as the
FUSE_RANDOM_BLOCK = 128 << 10     # reference's fio case: 48 writes of
FUSE_RANDOM_WRITES = 48           # 128 KiB (fio bs=128k)
FUSE_READ = 128 << 10             # the kernel's FUSE read size
FUSE_WRITE_LIMIT_MB = 8           # mount -writeMemoryLimitMB
FUSE_VOLUME_LIMIT = 64 << 20      # the master's volume size limit
FUSE_THREADS = 8
FUSE_DEADLINE = 60.0              # longest wait for a process or a mount
FUSE_XATTR = ("user.smoke22", b"phase 22 \x00\xff")


def _fuse_probe() -> str:
    """'' when this machine can make a kernel FUSE mount, else the first
    check that failed: /dev/fuse opens read-write, libfuse.so.2 loads,
    fusermount is on PATH."""
    from seaweedfs_tpu_torch.mount import fuse_ctypes

    try:
        os.close(os.open("/dev/fuse", os.O_RDWR))
    except OSError as e:
        return f"/dev/fuse does not open O_RDWR: {e.strerror}"
    if not fuse_ctypes.libfuse_available():
        return "libfuse.so.2 is not available"
    if shutil.which("fusermount") is None:
        return "fusermount is not on PATH"
    return ""


class _KernelMount:
    """A mountpoint served by a `mount` process: ordinary OS file I/O."""

    def __init__(self, root: str):
        self.root = root

    def _p(self, path: str) -> str:
        return self.root + path

    def mkdir(self, path: str) -> None:
        os.mkdir(self._p(path))

    def write(self, path: str, data: bytes, block: int = 1 << 20) -> None:
        with open(self._p(path), "wb") as f:
            for off in range(0, len(data), block):
                f.write(data[off:off + block])

    def random_writes(self, path: str, size: int, writes) -> None:
        """Preallocate `size` zero bytes, then write each (offset,
        block) in place and fsync (the reference's fio randwrite)."""
        self.write(path, bytes(size))
        with open(self._p(path), "r+b") as f:
            for off, blk in writes:
                f.seek(off)
                f.write(blk)
            os.fsync(f.fileno())

    def read(self, path: str) -> bytes:
        with open(self._p(path), "rb") as f:
            return f.read()

    def size(self, path: str) -> int:
        return os.stat(self._p(path)).st_size

    def listdir(self, path: str) -> list[str]:
        return sorted(os.listdir(self._p(path)))

    def rename(self, old: str, new: str) -> None:
        os.rename(self._p(old), self._p(new))

    def symlink(self, target: str, link: str) -> None:
        os.symlink(target, self._p(link))

    def readlink(self, path: str) -> str:
        return os.readlink(self._p(path))

    def link(self, src: str, dst: str) -> None:
        os.link(self._p(src), self._p(dst))

    def truncate(self, path: str, length: int) -> None:
        os.truncate(self._p(path), length)

    def chmod(self, path: str, mode: int) -> None:
        os.chmod(self._p(path), mode)

    def setxattr(self, path: str, name: str, value: bytes) -> None:
        os.setxattr(self._p(path), name, value)

    def getxattr(self, path: str, name: str) -> bytes:
        return os.getxattr(self._p(path), name)

    def statvfs(self) -> tuple[int, int]:
        sv = os.statvfs(self.root)
        return sv.f_bsize, sv.f_blocks


class _LibraryMount:
    """The same operations on a WeedFS in this process, handle by
    handle, as the kernel would issue them."""

    def __init__(self, fs):
        self.fs = fs

    def mkdir(self, path: str) -> None:
        self.fs.mkdir(path)

    def write(self, path: str, data: bytes, block: int = 1 << 20) -> None:
        fh = self.fs.create(path)
        for off in range(0, len(data), block):
            self.fs.write(fh, off, data[off:off + block])
        self.fs.release(fh)

    def random_writes(self, path: str, size: int, writes) -> None:
        fh = self.fs.create(path)
        for off in range(0, size, 1 << 20):
            self.fs.write(fh, off, bytes(min(1 << 20, size - off)))
        for off, blk in writes:
            self.fs.write(fh, off, blk)
        self.fs.flush(fh)
        self.fs.release(fh)

    def read(self, path: str) -> bytes:
        """Sequential reads of FUSE_READ bytes, as the kernel sends a
        reader's read(2) on to the mount."""
        fh = self.fs.open(path)
        try:
            size = self.fs.getattr(path)["st_size"]
            return b"".join(self.fs.read(fh, off, min(FUSE_READ, size - off))
                            for off in range(0, size, FUSE_READ))
        finally:
            self.fs.release(fh)

    def size(self, path: str) -> int:
        return self.fs.getattr(path)["st_size"]

    def listdir(self, path: str) -> list[str]:
        return sorted(n for n in self.fs.readdir(path)
                      if n not in (".", ".."))

    def rename(self, old: str, new: str) -> None:
        self.fs.rename(old, new)

    def symlink(self, target: str, link: str) -> None:
        self.fs.symlink(target, link)

    def readlink(self, path: str) -> str:
        return self.fs.readlink(path)

    def link(self, src: str, dst: str) -> None:
        self.fs.link(src, dst)

    def truncate(self, path: str, length: int) -> None:
        self.fs.truncate(path, length)

    def chmod(self, path: str, mode: int) -> None:
        self.fs.chmod(path, mode)

    def setxattr(self, path: str, name: str, value: bytes) -> None:
        self.fs.setxattr(path, name, value)

    def getxattr(self, path: str, name: str) -> bytes:
        return self.fs.getxattr(path, name)

    def statvfs(self) -> tuple[int, int]:
        d = self.fs.statfs()
        return d["f_bsize"], d["f_blocks"]


class _Pushgateway:
    """A Prometheus pushgateway stand-in on a loopback port: it keeps
    every PUT's path and body."""

    def __init__(self):
        import http.server

        received = self.received = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_PUT(self):
                body = self.rfile.read(
                    int(self.headers.get("Content-Length", 0)))
                received.append((self.path, body))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.port = self.server.server_port
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def phase_mount(card: str) -> dict:
    """Phase 22: the CLI filer on leveldb, run with -metrics.address,
    -cpuprofile and -memprofile, over an in-process master and four
    volume servers on "cuda"; a `mount` process of the CLI (or, where
    the machine cannot mount, WeedFS in this process) takes a home
    directory's small files and the reference's fio writes; the volumes
    they land in sealed, read degraded through a fresh mount and rebuilt
    through the kernel. -> kernel launches by step and the phase's
    numbers."""
    import base64
    import pstats
    import signal

    from seaweedfs_tpu_torch.mount.weedfs import WeedFS
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster, free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke22-")
    launches: dict[str, int] = {}
    walls: dict[str, float] = {}
    cluster = env = gateway = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    mounts: list = []       # (mountpoint or WeedFS, process or None)
    try:
        # 22a. the probe, decided up front; the cluster, the CLI filer
        # and the first mount
        missing = _fuse_probe()
        kernel = not missing
        log("[22] fuse: kernel" if kernel else f"[22] fuse: library "
            f"({missing})")
        t0 = time.perf_counter()
        cluster = Cluster(os.path.join(tmp, "main"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=FUSE_VOLUME_LIMIT,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        gateway = _Pushgateway()
        (fport,) = free_ports(1)
        filer = f"http://127.0.0.1:{fport}"
        prof = os.path.join(tmp, "filer.prof")
        memprof = os.path.join(tmp, "filer.mem")
        t_filer = _serve_cli(procs, logs, tmp, "filer", [
            "-metrics.address", f"127.0.0.1:{gateway.port}",
            "-metrics.intervalSec", "1", "-cpuprofile", prof,
            "-memprofile", memprof,
            "filer", "-port", str(fport), "-master", cluster.master_url,
            "-store", "leveldb", "-store.path",
            os.path.join(tmp, "filerdb")], fport, FUSE_DEADLINE)
        env = CommandEnv(cluster.master_url, filer_url=filer)

        def mount(label: str):
            """A mount of the filer with a fresh, empty cache directory.
            -> (the file operations, seconds to serving)."""
            cache = os.path.join(tmp, f"cache-{label}")
            os.mkdir(cache)
            t1 = time.perf_counter()
            if not kernel:
                fs = WeedFS(filer, cache_dir=cache,
                            write_memory_limit=FUSE_WRITE_LIMIT_MB << 20)
                mounts.append((fs, None))
                return _LibraryMount(fs), time.perf_counter() - t1
            mnt = os.path.join(tmp, f"mnt-{label}")
            os.mkdir(mnt)
            logs[label] = os.path.join(tmp, f"{label}.log")
            proc = _spawn(["mount", "-filer", filer, "-dir", mnt,
                           "-cacheDir", cache, "-writeMemoryLimitMB",
                           str(FUSE_WRITE_LIMIT_MB)], logs[label])
            mounts.append((mnt, proc))

            def up():
                if proc.poll() is not None:
                    fail(f"the {label} mount process exited "
                         f"{proc.returncode}: {_tail(logs[label])}")
                return os.path.ismount(mnt)
            _poll(up, FUSE_DEADLINE, f"{mnt} mounted", step=0.02)
            return _KernelMount(mnt), time.perf_counter() - t1

        def unmount(label: str) -> float:
            """Unmount the newest mount; the process must exit 0 within
            10 s. -> seconds to its exit."""
            where, proc = mounts.pop()
            t1 = time.perf_counter()
            if proc is None:
                where.destroy()
                return time.perf_counter() - t1
            r = subprocess.run(["fusermount", "-u", where],
                               capture_output=True, text=True, timeout=30)
            if r.returncode != 0:
                fail(f"22: fusermount -u {where}: {r.stderr.strip()}")
            try:
                rc = proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                fail(f"22: the {label} mount process still runs 10 s after "
                     f"its unmount: {_tail(logs[label])}")
            if rc != 0:
                fail(f"22: the {label} mount process exited {rc}: "
                     f"{_tail(logs[label])}")
            return time.perf_counter() - t1

        fs, t_mount = mount("mount-a")
        walls["a"] = time.perf_counter() - t0
        log(f"[22a] {card}; master {cluster.master_url}, 4 volume servers "
            f"ec_backend='cuda', volume limit {FUSE_VOLUME_LIMIT} B; "
            f"`-metrics.address -metrics.intervalSec 1 -cpuprofile "
            f"-memprofile filer -store leveldb` listening after "
            f"{t_filer:.3f} s; `mount -cacheDir <empty> -writeMemoryLimitMB "
            f"{FUSE_WRITE_LIMIT_MB}` "
            + ("mounted (os.path.ismount) " if kernel else
               "as WeedFS in this process, serving ")
            + f"{t_mount:.3f} s after its spawn; set-up {walls['a']:.3f} s")

        # 22b. a home directory's small files on 8 threads
        t0 = time.perf_counter()
        model: dict[str, bytes] = {}
        fs.mkdir(FUSE_ROOT)
        dirs = [f"{FUSE_ROOT}/d{i}" for i in range(FUSE_DIRS)]
        for d in dirs:
            fs.mkdir(d)
        small = {f"{dirs[i % FUSE_DIRS]}/f-{i:04d}.bin": d for i, d in
                 enumerate(_gw_sizes(FUSE_FILES, FUSE_LO, FUSE_HI, 22))}
        lat_w: list[float] = []

        def create(path: str) -> None:
            t1 = time.perf_counter()
            fs.write(path, small[path])
            lat_w.append(time.perf_counter() - t1)

        t1 = time.perf_counter()
        _pool_map(create, sorted(small), threads=FUSE_THREADS)
        t_create = time.perf_counter() - t1
        model.update(small)

        def read_pass(label: str, paths: list[str], mnt) -> dict:
            lat: list[float] = []

            def one(path: str) -> int:
                t1 = time.perf_counter()
                got = mnt.read(path)
                if _sha(got) != _sha(model[path]):
                    fail(f"{label}: {path}: {len(got)} B of "
                         f"{len(model[path])}, sha256 off")
                lat.append(time.perf_counter() - t1)
                return len(got)

            t1 = time.perf_counter()
            nb = sum(_pool_map(one, paths, threads=FUSE_THREADS))
            w = time.perf_counter() - t1
            return {"wall": w, "rate": len(paths) / w, "mbps": nb / w / 1e6,
                    "lat": lat}

        healthy = read_pass("22b", sorted(small), fs)

        def filer_names(d: str) -> list[str]:
            entries = session().get(f"{filer}{d}", params={
                "limit": "10000"}, headers={"Accept": "application/json"},
                timeout=30).json()["entries"]
            return sorted(e["full_path"].rsplit("/", 1)[1] for e in entries)

        for d in dirs:
            got, want = fs.listdir(d), filer_names(d)
            if got != want or len(got) != FUSE_FILES // FUSE_DIRS:
                fail(f"22b: listing {d}: the mount {len(got)} names, the "
                     f"filer {len(want)}")
        # a file PUT through the filer's HTTP reaches the mount's listing
        # through the metadata subscription
        via_http = f"{dirs[0]}/from-http.bin"
        model[via_http] = np.random.default_rng([SEED, 22, 2]).bytes(5000)
        t1 = time.perf_counter()
        r = session().post(f"{filer}{via_http}", data=model[via_http],
                           timeout=30)
        if r.status_code >= 300:
            fail(f"22b: PUT {via_http} through the filer: {r.status_code}")
        _poll(lambda: "from-http.bin" in fs.listdir(dirs[0]), 30.0,
              "22b: the filer's PUT in the mount's listing", step=0.01)
        t_seen = time.perf_counter() - t1
        walls["b"] = time.perf_counter() - t0
        log(f"[22b] {FUSE_DIRS} directories, {FUSE_FILES} files of "
            f"{FUSE_LO}-{FUSE_HI} B (log-uniform) by create+write+close on "
            f"{FUSE_THREADS} threads {t_create:.3f} s, "
            f"{FUSE_FILES / t_create:.1f} files/s, {_lat(lat_w)}; a read of "
            f"each {healthy['rate']:.1f} files/s ({_lat(healthy['lat'])}), "
            f"sha256-equal; each directory's listing equal to the filer's; "
            f"a PUT through the filer in the mount's listing after "
            f"{t_seen:.3f} s (the metadata subscription); "
            f"{walls['b']:.3f} s")

        # 22c. the fio gate's writes: large sequential files in 1 MiB
        # blocks, a verified random-write file; then POSIX operations,
        # each held against the filer's entry
        t0 = time.perf_counter()
        big = {f"{FUSE_ROOT}/big-{i}.bin":
               np.random.default_rng([SEED, 22, 3, i]).bytes(FUSE_BIG[1])
               for i in range(FUSE_BIG[0])}
        t1 = time.perf_counter()
        for path, data in big.items():
            fs.write(path, data, FUSE_BLOCK)
        t_big_w = time.perf_counter() - t1
        model.update(big)
        t1 = time.perf_counter()
        for path in big:
            if _sha(fs.read(path)) != _sha(model[path]):
                fail(f"22c: {path} read back: sha256 off")
        t_big_r = time.perf_counter() - t1
        big_bytes = FUSE_BIG[0] * FUSE_BIG[1]
        rng = np.random.default_rng([SEED, 22, 4])
        rand_path = f"{FUSE_ROOT}/random.bin"
        shadow = bytearray(FUSE_RANDOM)
        writes = []
        for _ in range(FUSE_RANDOM_WRITES):
            off = int(rng.integers(0, (FUSE_RANDOM - FUSE_RANDOM_BLOCK)
                                   // 4096)) * 4096
            blk = rng.bytes(FUSE_RANDOM_BLOCK)
            shadow[off:off + len(blk)] = blk
            writes.append((off, blk))
        t1 = time.perf_counter()
        fs.random_writes(rand_path, FUSE_RANDOM, writes)
        t_rand = time.perf_counter() - t1
        model[rand_path] = bytes(shadow)
        if _sha(fs.read(rand_path)) != _sha(model[rand_path]):
            fail("22c: the random-write file read back: sha256 off")

        def entry(path: str) -> dict | None:
            r = session().get(f"{filer}{path}", params={"meta": "1"},
                              timeout=30)
            if r.status_code == 404:
                return None
            if r.status_code != 200:
                fail(f"22c: the filer's entry of {path}: {r.status_code}")
            return r.json()

        def extent(e: dict) -> int:
            return max([c["offset"] + c["size"] for c in
                        e.get("chunks") or []] or [0])

        checked = []
        src = sorted(small)[0]
        dst = f"{FUSE_ROOT}/d1/renamed.bin"
        fs.rename(src, dst)
        model[dst] = model.pop(src)
        if entry(src) is not None or entry(dst) is None or \
                _sha(fs.read(dst)) != _sha(model[dst]):
            fail(f"22c: rename {src} -> {dst}")
        checked.append("rename")
        fs.symlink("big-0.bin", f"{FUSE_ROOT}/sym")
        e = entry(f"{FUSE_ROOT}/sym") or {}
        if fs.readlink(f"{FUSE_ROOT}/sym") != "big-0.bin" or \
                e.get("symlink_target") != "big-0.bin":
            fail(f"22c: symlink: readlink, the entry's target "
                 f"{e.get('symlink_target')!r}")
        checked.append("symlink+readlink")
        hard_src = sorted(small)[1]
        hard = f"{FUSE_ROOT}/hard.bin"
        fs.link(hard_src, hard)
        model[hard] = model[hard_src]
        e, e_src = entry(hard) or {}, entry(hard_src) or {}
        if not e.get("hard_link_id") or \
                e.get("hard_link_id") != e_src.get("hard_link_id") or \
                _sha(fs.read(hard)) != _sha(model[hard]):
            fail(f"22c: hardlink {hard_src} -> {hard}: {e}")
        checked.append("hardlink")
        cut = f"{FUSE_ROOT}/big-{FUSE_BIG[0] - 1}.bin"
        length = FUSE_BIG[1] // 3 + 123
        fs.truncate(cut, length)
        model[cut] = model[cut][:length]
        e = entry(cut) or {}
        if extent(e) != length or fs.size(cut) != length:
            fail(f"22c: truncate {cut} to {length}: the entry's extent "
                 f"{extent(e)}, the mount's size {fs.size(cut)}")
        checked.append("truncate")
        fs.chmod(dst, 0o640)
        e = entry(dst) or {}
        if e.get("mode", 0) & 0o7777 != 0o640:
            fail(f"22c: chmod 640: the entry's mode {e.get('mode', 0):o}")
        checked.append("chmod")
        name, value = FUSE_XATTR
        fs.setxattr(dst, name, value)
        e = entry(dst) or {}
        if fs.getxattr(dst, name) != value or \
                e.get("extended", {}).get("xattr-" + name) != \
                base64.b64encode(value).decode():
            fail(f"22c: xattr {name}: the entry's extended "
                 f"{e.get('extended')}")
        checked.append("xattr")
        bsize, blocks = fs.statvfs()
        if bsize <= 0 or blocks <= 0:
            fail(f"22c: statvfs: f_bsize {bsize}, f_blocks {blocks}")
        checked.append("statvfs")
        walls["c"] = time.perf_counter() - t0
        log(f"[22c] {FUSE_BIG[0]} x {FUSE_BIG[1]} B in {FUSE_BLOCK} B blocks "
            f"written {big_bytes / t_big_w / 1e6:.1f} MB/s, read back "
            f"{big_bytes / t_big_r / 1e6:.1f} MB/s, sha256-equal; "
            f"{FUSE_RANDOM} B of {FUSE_RANDOM_WRITES} seeded "
            f"{FUSE_RANDOM_BLOCK} B random writes (preallocated, fsync) "
            f"{t_rand:.3f} s, read back equal; {', '.join(checked)} held "
            f"against the filer's entries (statvfs f_bsize {bsize}, "
            f"f_blocks {blocks}); {walls['c']:.3f} s")

        # 22d. unmount: the process exits 0, and every file reads equal
        # through the filer's HTTP, so the dirty pages were flushed
        t0 = time.perf_counter()
        t_exit = unmount("mount-a")

        def filer_read(path: str) -> int:
            r = _filer_get(filer, path)
            if r.status_code != 200 or _sha(r.content) != _sha(model[path]):
                fail(f"22d: GET {path} through the filer: {r.status_code}, "
                     f"{len(r.content)} B of {len(model[path])}")
            return len(r.content)

        nb = sum(_pool_map(filer_read, sorted(model), threads=FUSE_THREADS))
        walls["d"] = time.perf_counter() - t0
        log(f"[22d] " + ("fusermount -u: the mount process exited 0 "
                         if kernel else "WeedFS.destroy() returned ")
            + f"after {t_exit:.3f} s; all {len(model)} files ({nb} B) read "
            f"sha256-equal through the filer's HTTP; {walls['d']:.3f} s")

        # 22e. seal every volume that holds the phase's data
        t0 = time.perf_counter()
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        dat = {}
        for vid in sorted({int(v) for n in env.data_nodes()
                           for v in n.get("collections", {})}):
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    if v.content_size() > 8:    # past the super block
                        dat[vid] = v.content_size()
        vids = sorted(dat)
        repl.run_command(env, "lock")
        before_stages = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before_stages["kernel"]
        want = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if launches["encode"] <= 0 or launches["encode"] != want or \
                launches["encode"] != len(vids) or \
                scraped != launches["encode"]:
            fail(f"22e: {launches['encode']} launches sealing {len(vids)} "
                 f"volumes, the .dat sizes give {want}, /metrics "
                 f"cuda_kernel_launches {scraped}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"22e: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        walls["e"] = time.perf_counter() - t0
        log(f"[22e] ec.encode of the {len(vids)} volumes holding the "
            f"phase's files ({dat} .dat bytes) {t_encode:.3f} s, "
            f"{launches['encode']} launches (one a volume; /metrics "
            f"cuda_kernel_launches {scraped}); kernel "
            f"{kernel_s * 1e3:.3f} ms (CUDA events), "
            f"{kernel_s * 1e3 / max(1, launches['encode']):.3f} ms per "
            f"launch; {walls['e']:.3f} s")

        # 22f. a server lost; every file read through a fresh mount
        t0 = time.perf_counter()
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        if any(len(s) > 4 for s in lost.values()):
            fail(f"22f: {victim} holds more than m=4 shards of a volume: "
                 f"{lost}")
        t1 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        paths_small = sorted(p for p in model if p not in big and
                             p != rand_path)
        paths_big = sorted(big) + [rand_path]
        big_total = sum(len(model[p]) for p in paths_big)

        def sealed_pass(label: str) -> dict:
            mnt, t_up = mount(label)
            out = {"mount": t_up}
            out["small"] = read_pass(label, paths_small, mnt)
            t1 = time.perf_counter()
            for path in paths_big:
                if _sha(mnt.read(path)) != _sha(model[path]):
                    fail(f"{label}: {path}: sha256 off")
            out["big_mbps"] = big_total / (time.perf_counter() - t1) / 1e6
            out["exit"] = unmount(label)
            return out

        degraded = sealed_pass("mount-f")
        walls["f"] = time.perf_counter() - t0
        log(f"[22f] stopped {victim} (shards {lost}), dropped in "
            f"{t_gone:.3f} s; a fresh mount (empty -cacheDir, "
            + ("a new process" if kernel else "a new WeedFS")
            + f") up in {degraded['mount']:.3f} s read all "
            f"{len(paths_small)} small files degraded "
            f"{degraded['small']['rate']:.1f} files/s "
            f"({degraded['small']['mbps']:.2f} MB/s, "
            f"{_lat(degraded['small']['lat'])}) and the {len(paths_big)} "
            f"large ones {degraded['big_mbps']:.1f} MB/s, all sha256-equal; "
            + ("unmounted, exit 0" if kernel else "destroyed")
            + f" after {degraded['exit']:.3f} s; {walls['f']:.3f} s")

        # 22g. rebuild through the kernel; the pass again, rebuilt
        t0 = time.perf_counter()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped_r = _tools_metrics(next(u for u in by_url if u != victim))[
            "launches"]
        if launches["rebuild"] <= 0 or scraped_r != launches["rebuild"]:
            fail(f"22g: ec.rebuild: {launches['rebuild']} launches, the "
                 f"volume servers' cuda_kernel_launches {scraped_r}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"22g: volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        repl.run_command(env, "unlock")
        rebuilt = sealed_pass("mount-g")
        walls["g"] = time.perf_counter() - t0
        log(f"[22g] ec.rebuild {t_rebuild:.3f} s, {launches['rebuild']} "
            f"launches (/metrics {scraped_r}); another fresh mount read "
            f"every file rebuilt: small {rebuilt['small']['rate']:.1f} "
            f"files/s ({_lat(rebuilt['small']['lat'])}), large "
            f"{rebuilt['big_mbps']:.1f} MB/s, all sha256-equal; "
            f"{walls['g']:.3f} s")

        # 22h. the filer stopped by SIGINT: its push, its profiles
        t0 = time.perf_counter()
        procs["filer"].send_signal(signal.SIGINT)
        try:
            rc = procs["filer"].wait(timeout=FUSE_DEADLINE)
        except subprocess.TimeoutExpired:
            fail(f"22h: the filer still runs {FUSE_DEADLINE:.0f} s after "
                 f"SIGINT")
        t_stop = time.perf_counter() - t0
        if rc != 0:
            fail(f"22h: the filer exited {rc} on SIGINT: "
                 f"{_tail(logs['filer'])}")
        del procs["filer"]
        pushes = [b for p, b in list(gateway.received)
                  if p == "/metrics/job/filer"]
        if not pushes or b"filer_request_seconds" not in pushes[-1]:
            fail(f"22h: the pushgateway got {len(gateway.received)} PUTs, "
                 f"{len(pushes)} to /metrics/job/filer, the last without "
                 f"filer_request_seconds")
        stats = pstats.Stats(prof)
        mem_lines = open(memprof).read().splitlines()
        if stats.total_calls <= 0 or not mem_lines:
            fail(f"22h: the cProfile dump has {stats.total_calls} calls, "
                 f"the tracemalloc report {len(mem_lines)} lines")
        walls["h"] = time.perf_counter() - t0
        log(f"[22h] SIGINT: the filer exited 0 after {t_stop:.3f} s; the "
            f"pushgateway took {len(pushes)} PUTs /metrics/job/filer "
            f"(the last {len(pushes[-1])} B, with filer_request_seconds); "
            f"the cProfile dump loads with pstats ({stats.total_calls} "
            f"calls); the tracemalloc report has {len(mem_lines)} lines; "
            f"{walls['h']:.3f} s")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 22 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[22] phase 22 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); fuse "
            f"{'kernel' if kernel else 'library'}; kernel launches "
            f"{launches}; the seal's kernel time {kernel_s * 1e3:.3f} ms "
            f"is {busy:.5%} of the phase wall (idle share "
            f"{1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        launches["fuse"] = "kernel" if kernel else "library"
        return launches
    finally:
        for where, proc in mounts:
            if proc is None:
                where.destroy()
                continue
            subprocess.run(["fusermount", "-u", "-z", where],
                           capture_output=True)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        if gateway is not None:
            gateway.close()
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


IMG_COUNT = 256                   # the store's images
IMG_LO, IMG_HI = 32 << 10, 2 << 20  # their sizes, log-uniform
IMG_CROP_EVERY = 4                # one GET in four is cropped first
IMG_VOLUME_LIMIT = 64 << 20       # the master's volume size limit
IMG_THREADS = 8
IMG_COLLECTION = "photos"
IMG_SLOWEST = 5                   # 23d's slowest GETs whose spans print
LINT_GATE_S = 10.0                # the reference's lint-time gate
LINT_MIN_FILES = 175
LINT_RULES = ("async-hygiene", "cli-flag-help", "context-propagation",
              "device-sync", "dp-faults", "label-cardinality",
              "lock-discipline", "metric-names", "raw-requests",
              "resource-safety", "session-timeout", "torch-hygiene")


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data)))


def _png(w: int, h: int, rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, rows unfiltered, in stored deflate blocks
    (level 0: noise does not compress)."""
    import struct
    import zlib

    raw = np.zeros((h, 1 + 3 * w), dtype=np.uint8)
    raw[:, 1:] = rgb.reshape(h, 3 * w)
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                              0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 0))
            + _png_chunk(b"IEND", b""))


def _bmp(w: int, h: int, rgb: np.ndarray) -> bytes:
    """A 24-bit bottom-up BMP (BITMAPINFOHEADER)."""
    import struct

    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), dtype=np.uint8)
    rows[:, :3 * w] = rgb.reshape(h, w, 3)[:, :, ::-1].reshape(h, 3 * w)
    pixels = rows[::-1].tobytes()
    return (b"BM" + struct.pack("<IHHI", 54 + len(pixels), 0, 0, 54)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(pixels),
                          2835, 2835, 0, 0)
            + pixels)


def _gif(w: int, h: int, idx: np.ndarray) -> bytes:
    """A 256-colour GIF89a whose LZW stream holds only literal codes:
    9-bit codes, a clear code before every 250 pixels, so the
    decoder's table never widens the code."""
    import struct

    palette = np.arange(256, dtype=np.uint8).repeat(3).tobytes()
    n = w * h
    runs = -(-n // 250)
    codes = np.full(n + runs + 1, 256, dtype=np.uint16)
    pos = np.arange(n) + np.arange(n) // 250 + 1
    codes[pos] = idx
    codes[-1] = 257                           # end of information
    # 8 codes of 9 bits are 9 bytes of the little-endian stream: the
    # first 63 bits and the last code's low bit make one uint64, the
    # last code's other 8 bits the ninth byte
    groups = -(-len(codes) // 8)
    c = np.zeros(groups * 8, dtype=np.uint64)
    c[:len(codes)] = codes
    c = c.reshape(groups, 8)
    lo = np.zeros(groups, dtype=np.uint64)
    for j in range(7):
        lo |= c[:, j] << np.uint64(9 * j)
    lo |= (c[:, 7] & np.uint64(1)) << np.uint64(63)
    packed = np.empty((groups, 9), dtype=np.uint8)
    packed[:, :8] = lo.astype("<u8").view(np.uint8).reshape(groups, 8)
    packed[:, 8] = (c[:, 7] >> np.uint64(1)).astype(np.uint8)
    data = packed.tobytes()[:-(-len(codes) * 9 // 8)]
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0) + palette
            + b"," + struct.pack("<HHHHB", 0, 0, w, h, 0)
            + b"\x08" + blocks + b"\x00;")


def _img_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR, a GIF's screen descriptor or a
    BMP's header."""
    import struct

    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return struct.unpack(">II", data[16:24])
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return struct.unpack("<HH", data[6:10])
    if data[:2] == b"BM":
        w, h = struct.unpack("<ii", data[18:26])
        return w, abs(h)
    fail(f"23: an answer that is no PNG, GIF or BMP: {data[:8]!r}")


def _images() -> list[dict]:
    """The store's seeded images: PNG, GIF and BMP in turn, each close
    to its log-uniform size. -> [{name, mime, data, w, h, query}]."""
    rng = np.random.default_rng([SEED, 23])
    sizes = np.exp(rng.uniform(np.log(IMG_LO), np.log(IMG_HI), IMG_COUNT))
    out = []
    for i, size in enumerate(sizes):
        kind = ("png", "gif", "bmp")[i % 3]
        pixels = int(size * 8 / 9) if kind == "gif" else int(size) // 3
        w = max(8, int((pixels * 4 / 3) ** 0.5))
        h = max(8, pixels // w)
        if kind == "gif":
            data = _gif(w, h, rng.integers(0, 256, w * h, dtype=np.uint8))
        else:
            rgb = rng.integers(0, 256, 3 * w * h, dtype=np.uint8)
            data = (_png if kind == "png" else _bmp)(w, h, rgb)
        query = {"width": max(1, w // 4), "height": max(1, h // 5),
                 "mode": "fit"}
        if i % IMG_CROP_EVERY == 0:
            x1, y1 = w // 8, h // 8
            query.update(crop_x1=x1, crop_y1=y1, crop_x2=x1 + w // 2,
                         crop_y2=y1 + h // 2)
        out.append({"name": f"img-{i:03d}.{kind}", "mime": f"image/{kind}",
                    "data": data, "w": w, "h": h, "query": query})
    return out


def _fit_size(img: dict) -> tuple[int, int]:
    """The size a fit rendition of `img` has: its crop first (png and
    gif only, as the reference crops), then PIL's ImageOps.contain."""
    q, w, h = img["query"], img["w"], img["h"]
    if "crop_x2" in q and img["mime"] != "image/bmp":
        w, h = q["crop_x2"] - q["crop_x1"], q["crop_y2"] - q["crop_y1"]
    bw, bh = q["width"], q["height"]
    if w / h != bw / bh:
        if w / h > bw / bh:
            nh = round(h / w * bw)
            if nh != bh:
                bh = nh
        else:
            nw = round(w / h * bh)
            if nw != bw:
                bw = nw
    return bw, bh


def phase_images(card: str) -> dict:
    """Phase 23: the analyzer over the checkout, then an image store of
    four volume servers on "cuda" whose renditions are read healthy,
    degraded with a server lost after the volumes were sealed through
    the kernel, and rebuilt. -> kernel launches by step and the phase's
    numbers."""
    import importlib.util
    import re

    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.ops import codec_cuda
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import Cluster
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv
    from seaweedfs_tpu_torch.utils import tracing

    t_phase = time.perf_counter()
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke23-")
    launches: dict = {}
    walls: dict[str, float] = {}
    cluster = env = None
    ring = tracing._buffer_size
    try:
        # 23a. the analyzer, as the lint gate runs it
        t0 = time.perf_counter()
        root = os.path.dirname(os.path.abspath(__file__))

        def analysis(*args) -> subprocess.CompletedProcess:
            return subprocess.run(
                [sys.executable, "-m", "seaweedfs_tpu_torch.analysis",
                 *args], cwd=root, capture_output=True, text=True,
                timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

        out = analysis("--json")
        t_lint = time.perf_counter() - t0
        if out.returncode != 0:
            fail(f"23a: the analyzer exited {out.returncode}: "
                 f"{out.stdout[-2000:]}{out.stderr[-2000:]}")
        doc = json.loads(out.stdout)
        if doc["findings"] or doc["files_scanned"] < LINT_MIN_FILES:
            fail(f"23a: {len(doc['findings'])} findings over "
                 f"{doc['files_scanned']} files: {doc['findings'][:5]}")
        rules = analysis("--list-rules")
        names = tuple(line.split()[0] for line in
                      rules.stdout.splitlines() if line.strip())
        if rules.returncode != 0 or names != LINT_RULES:
            fail(f"23a: --list-rules exited {rules.returncode}: {names}")
        launches["analysis"] = {"files": doc["files_scanned"],
                                "findings": len(doc["findings"]),
                                "seconds": round(t_lint, 3)}
        walls["a"] = time.perf_counter() - t0
        log(f"[23a] python -m seaweedfs_tpu_torch.analysis --json: exit 0, "
            f"0 findings ({doc['suppressed']} suppressed on their lines), "
            f"{doc['files_scanned']} files in {t_lint:.3f} s (the "
            f"reference's lint gate: {LINT_GATE_S:.0f} s); --list-rules "
            f"names the {len(names)} rules; {walls['a']:.3f} s")

        # 23b. the image store
        t0 = time.perf_counter()
        pil = importlib.util.find_spec("PIL") is not None
        if pil:
            from importlib import metadata

            try:
                pil_version = metadata.version("pillow")
            except metadata.PackageNotFoundError:
                pil_version = "of unknown version"
            log(f"[23] renditions: PIL (pillow {pil_version}, found by "
                f"importlib, not imported here)")
        else:
            log("[23] renditions: stored bytes (no PIL on this machine)")
        cluster = Cluster(os.path.join(tmp, "img"), n_volume_servers=4,
                          max_volumes=8, volume_size_limit=IMG_VOLUME_LIMIT,
                          pulse_seconds=HEAL_PULSE, ec_backend="cuda")
        env = CommandEnv(cluster.master_url)
        t1 = time.perf_counter()
        imgs = _images()
        t_make = time.perf_counter() - t1
        total = sum(len(im["data"]) for im in imgs)

        def put(im: dict) -> None:
            a = verbs.assign(cluster.master_url, collection=IMG_COLLECTION)
            verbs.upload(a, im["data"], name=im["name"], mime=im["mime"])
            im["fid"] = a.fid

        t1 = time.perf_counter()
        _pool_map(put, imgs, threads=IMG_THREADS)
        t_put = time.perf_counter() - t1
        walls["b"] = time.perf_counter() - t0
        log(f"[23b] {card}; master {cluster.master_url}, 4 volume servers "
            f"ec_backend='cuda', volume limit {IMG_VOLUME_LIMIT} B; "
            f"{IMG_COUNT} images (PNG, GIF, BMP) of {IMG_LO}-{IMG_HI} B "
            f"(log-uniform), {total} B, made in {t_make:.3f} s and POSTed "
            f"on {IMG_THREADS} threads in {t_put:.3f} s "
            f"({total / t_put / 1e6:.1f} MB/s); {walls['b']:.3f} s")

        def server_of(fid: str) -> str:
            vid = int(fid.split(",")[0])
            locs = env.master_get("/dir/lookup", volumeId=vid)["locations"]
            return locs[0]["url"]

        def get_pass(label: str, want: dict | None, traced: bool = False
                     ) -> dict:
            """A rendition GET of every image; -> rate, latencies, the
            answers' sha256 and, when traced, each GET's trace id."""
            lat: dict[str, float] = {}
            shas: dict[str, str] = {}
            tids: dict[str, str] = {}
            urls = {im["fid"]: server_of(im["fid"]) for im in imgs}

            def one(im: dict) -> int:
                headers = {}
                if traced:
                    tid = os.urandom(16).hex()
                    tids[im["fid"]] = tid
                    headers["traceparent"] = \
                        f"00-{tid}-{os.urandom(8).hex()}-01"
                t1 = time.perf_counter()
                r = session().get(f"http://{urls[im['fid']]}/{im['fid']}",
                                  params=im["query"], headers=headers,
                                  timeout=60)
                lat[im["fid"]] = time.perf_counter() - t1
                if r.status_code != 200:
                    fail(f"{label}: GET {im['name']}: {r.status_code}")
                body = r.content
                if not pil and body != im["data"]:
                    fail(f"{label}: {im['name']} without PIL: "
                         f"{len(body)} B, not the stored {len(im['data'])}")
                if pil and _img_size(body) != _fit_size(im):
                    fail(f"{label}: {im['name']} {im['query']}: "
                         f"{_img_size(body)}, not {_fit_size(im)}")
                shas[im["fid"]] = _sha(body)
                if want is not None and shas[im["fid"]] != want[im["fid"]]:
                    fail(f"{label}: {im['name']}: the answer differs from "
                         f"the healthy one")
                return len(body)

            t1 = time.perf_counter()
            nb = sum(_pool_map(one, imgs, threads=IMG_THREADS))
            w = time.perf_counter() - t1
            return {"wall": w, "rate": len(imgs) / w, "mbps": nb / w / 1e6,
                    "lat": lat, "sha": shas, "tids": tids}

        def say(p: dict) -> str:
            return (f"{p['rate']:.1f} images/s ({_lat(list(p['lat'].values()))}"
                    f"), {p['mbps']:.1f} MB/s")

        # 23c. renditions, healthy
        t0 = time.perf_counter()
        healthy = get_pass("23c", None)
        cropped = sum(1 for im in imgs if "crop_x2" in im["query"])
        walls["c"] = time.perf_counter() - t0
        log(f"[23c] {IMG_COUNT} GETs ?width=&height=&mode=fit ({cropped} "
            f"cropped first) on {IMG_THREADS} threads: {say(healthy)}; "
            + ("each answer the stored bytes" if not pil else
               "each answer's header size the one asked for")
            + f"; {walls['c']:.3f} s")

        # 23d. seal through the kernel, lose a server, read degraded
        t0 = time.perf_counter()
        time.sleep(3 * HEAL_PULSE)      # heartbeats carry final sizes
        vids = sorted({int(im["fid"].split(",")[0]) for im in imgs})
        dat = {}
        for vid in vids:
            for st in cluster.stores:
                v = st.find_volume(vid)
                if v is not None:
                    v.sync()
                    dat[vid] = v.content_size()
        if len(vids) < 2:
            fail(f"23d: the images landed in {len(vids)} volume(s)")
        repl.run_command(env, "lock")
        before_stages = feed_stage_seconds()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        launches["encode"] = codec_cuda.coded_matmul.launches
        kernel_s = feed_stage_seconds()["kernel"] - before_stages["kernel"]
        want = sum(_encode_launches(dat[v]) for v in vids)
        by_url = {f"{st.ip}:{st.port}": i
                  for i, st in enumerate(cluster.stores)}
        scraped = _tools_metrics(next(iter(by_url)))["launches"]
        if launches["encode"] <= 0 or launches["encode"] != want or \
                scraped != launches["encode"]:
            fail(f"23d: {launches['encode']} launches sealing {len(vids)} "
                 f"volumes, the .dat sizes give {want}, /metrics "
                 f"cuda_kernel_launches {scraped}")
        held: dict[str, list[tuple[int, int]]] = {u: [] for u in by_url}
        for vid in vids:
            locs = env.ec_shard_locations(vid)
            if sorted(locs) != list(range(14)):
                fail(f"23d: volume {vid} after ec.encode: {locs}")
            for sid, urls in locs.items():
                held[urls[0]].append((vid, sid))
        largest = max(vids, key=lambda v: (dat[v], v))
        victim = max(held, key=lambda u: (sum(1 for v, _ in held[u]
                                              if v == largest), u))
        lost = {vid: sorted(s for v, s in held[victim] if v == vid)
                for vid in vids}
        t1 = time.perf_counter()
        cluster.volume_threads[by_url[victim]].stop()
        _poll(lambda: all(len(env.ec_shard_locations(v)) ==
                          14 - len(lost[v]) for v in vids),
              HEAL_DEADLINE, f"the master drops {victim}'s shards")
        t_gone = time.perf_counter() - t1
        tracing.configure(buffer_size=1 << 16)
        degraded = get_pass("23d", healthy["sha"], traced=True)
        slow = sorted(degraded["lat"], key=degraded["lat"].get)[
            -IMG_SLOWEST:][::-1]
        peer = next(u for u in by_url if u != victim)
        traces = {t["trace_id"]: t["spans"] for t in session().get(
            f"http://{peer}/debug/traces", params={"limit": 1 << 16},
            timeout=60).json()["traces"]}
        walls["d"] = time.perf_counter() - t0
        log(f"[23d] ec.encode of the {len(vids)} image volumes ({dat} .dat "
            f"bytes) {t_encode:.3f} s, {launches['encode']} launches "
            f"(/metrics {scraped}); kernel {kernel_s * 1e3:.3f} ms (CUDA "
            f"events); stopped {victim} (shards {lost}), dropped in "
            f"{t_gone:.3f} s; every rendition again, degraded, equal to "
            f"23c's: {say(degraded)}; {walls['d']:.3f} s")
        p99 = np.percentile(np.array(list(degraded["lat"].values())), 99)
        log(f"[23d] the {IMG_SLOWEST} slowest degraded GETs beside the p99 "
            f"{p99 * 1e3:.3f} ms, their spans from /debug/traces (ms from "
            f"the GET's start):")
        for fid in slow:
            spans = traces.get(degraded["tids"][fid], [])
            t_root = min((sp["start"] for sp in spans), default=0.0)
            by_name: dict[str, list[float]] = {}
            for sp in spans:
                by_name.setdefault(
                    re.sub(r"\d+\.\d+\.\d+\.\d+:\d+", "<peer>", sp["name"]),
                    []).append(sp["duration"])
            summary = ", ".join(
                f"{n} x{len(d)} {sum(d) * 1e3:.1f} ms (max "
                f"{max(d) * 1e3:.1f})" for n, d in sorted(by_name.items()))
            first = "; ".join(
                f"+{(sp['start'] - t_root) * 1e3:.1f} {sp['name']} "
                f"{sp['duration'] * 1e3:.1f}" for sp in spans[:8])
            log(f"  {fid} {degraded['lat'][fid] * 1e3:.3f} ms, "
                f"{len(spans)} spans: {summary} | {first}")

        # 23e. rebuild through the kernel; the pass again; the gauges
        t0 = time.perf_counter()
        codec_cuda.coded_matmul.launches = 0
        t1 = time.perf_counter()
        for vid in vids:
            if lost[vid]:
                repl.run_command(env, f"ec.rebuild -volumeId={vid}")
        t_rebuild = time.perf_counter() - t1
        launches["rebuild"] = codec_cuda.coded_matmul.launches
        scraped_r = _tools_metrics(peer)["launches"]
        if launches["rebuild"] <= 0 or scraped_r != launches["rebuild"]:
            fail(f"23e: ec.rebuild: {launches['rebuild']} launches, the "
                 f"volume servers' cuda_kernel_launches {scraped_r}")
        for vid in vids:
            if sorted(env.ec_shard_locations(vid)) != list(range(14)):
                fail(f"23e: volume {vid} after ec.rebuild: "
                     f"{env.ec_shard_locations(vid)}")
        repl.run_command(env, "unlock")
        rebuilt = get_pass("23e", healthy["sha"])
        gauges = {}
        for url in by_url:
            if url == victim:
                continue
            text = session().get(f"http://{url}/metrics", timeout=30).text
            for kind in ("upload", "download"):
                m = re.search(rf"^volume_server_in_flight_{kind}_bytes "
                              rf"(\S+)$", text, re.M)
                gauges[(url, kind)] = float(m.group(1)) if m else None
        if any(v != 0 for v in gauges.values()):
            fail(f"23e: in-flight gauges after the passes: {gauges}")
        walls["e"] = time.perf_counter() - t0
        log(f"[23e] ec.rebuild {t_rebuild:.3f} s, {launches['rebuild']} "
            f"launches (/metrics {scraped_r}); every rendition rebuilt, "
            f"equal: {say(rebuilt)}; volume_server_in_flight_upload_bytes "
            f"and _download_bytes 0 on the {len(gauges) // 2} live "
            f"servers; {walls['e']:.3f} s")
        wall = time.perf_counter() - t_phase
        busy = kernel_s / wall
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 23 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[23] phase 23 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); renditions "
            f"{'PIL' if pil else 'stored bytes'}; kernel launches "
            f"{ {k: launches[k] for k in ('encode', 'rebuild')} }; the "
            f"seal's kernel time {kernel_s * 1e3:.3f} ms is {busy:.5%} of "
            f"the phase wall (idle share {1 - busy:.5%}); {card}")
        launches["kernel_ms_per_launch"] = round(
            kernel_s * 1e3 / max(1, launches["encode"]), 3)
        launches["idle_share"] = round(1 - busy, 6)
        launches["renditions"] = "PIL" if pil else "stored bytes"
        return launches
    finally:
        tracing.configure(buffer_size=ring)
        if env is not None:
            env.close()
        if cluster is not None:
            cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------------
# phase 24: the heartbeat stream at the default pulse: a SIGKILLed
# volume process dropped when its stream closes, rebuilt by the watchdog
# ----------------------------------------------------------------------
STREAM_SERVERS = 4               # CLI volume processes
STREAM_GRACE = 3.0               # -repair.grace: clear of ec.encode's
#                                  partial mounts (Queue 3 item 4; the
#                                  encode took 1.1 s on the card)
STREAM_INTERVAL = 1.0            # -repair.interval
STREAM_WRITES = (1 << 10, 16 << 10)  # the writer's needles, log-uniform
STREAM_THREADS = 8
STREAM_DEADLINE = 60.0           # longest wait for a process or a repair


def phase_stream(card: str) -> dict:
    """Phase 24: a CLI master at SeaweedFS's 5 s default pulse with the
    watchdog's repairs on and four CLI volume processes on "cuda" (on
    the Python data plane: the native front's two blocking relay workers
    stall concurrent degraded reads across processes); a
    256 MiB volume filled over HTTP and sealed through the kernel; a
    writer assigning into another collection while the server holding
    the fewest shards is SIGKILLed. -> kernel launches by step and the
    phase's numbers."""
    import signal
    import socket

    from seaweedfs_tpu_torch.operation import verbs
    from seaweedfs_tpu_torch.rpc.httpclient import session
    from seaweedfs_tpu_torch.server.cluster import free_ports
    from seaweedfs_tpu_torch.shell import repl
    from seaweedfs_tpu_torch.shell.env import CommandEnv

    t_phase = time.perf_counter()
    on_card = card != "cpu"
    cur = torch.cuda.current_device() if torch.cuda.is_available() else None
    tmp = tempfile.mkdtemp(prefix="ec-smoke24-")
    out: dict = {}
    walls: dict[str, float] = {}
    env = None
    procs: dict[str, subprocess.Popen] = {}
    logs: dict[str, str] = {}
    stop_writer = threading.Event()
    writer = None
    try:
        # 24a. the processes, spawned together (a volume server retries
        # its stream until the master listens): the master with no
        # -pulseSeconds
        t0 = time.perf_counter()
        mport, *vports = free_ports(1 + STREAM_SERVERS)
        murl = f"http://127.0.0.1:{mport}"
        logs["master"] = os.path.join(tmp, "master.log")
        procs["master"] = _spawn(
            ["master", "-ip", "127.0.0.1", "-port", str(mport),
             "-repair.enabled", "-repair.interval", str(STREAM_INTERVAL),
             "-repair.grace", str(STREAM_GRACE)], logs["master"])
        env = CommandEnv(murl)
        dirs: dict[str, str] = {}
        for port in vports:
            url = f"127.0.0.1:{port}"
            dirs[url] = os.path.join(tmp, f"v{port}")
            os.makedirs(dirs[url])
            logs[url] = os.path.join(tmp, f"v{port}.log")
            procs[url] = _spawn(
                ["volume", "-ip", "127.0.0.1", "-port", str(port),
                 "-dir", dirs[url], "-max", "8", "-mserver",
                 f"127.0.0.1:{mport}", "-dataplane", "python",
                 "-ec.backend", "cuda" if on_card else "native"],
                logs[url], card=on_card)

        def warm_master() -> None:
            # the master's first /cluster/status imports the mesh module
            # (torch, 13 s on a slow host): paid beside the volume
            # processes' start and the fill, not inside ec.encode (whose
            # shell reads /cluster/status) or the detection
            end = time.monotonic() + STREAM_DEADLINE
            while time.monotonic() < end:
                try:
                    socket.create_connection(("127.0.0.1", mport),
                                             1).close()
                    break
                except OSError:
                    time.sleep(0.05)
            _get_json(f"{murl}/cluster/status", timeout=STREAM_DEADLINE)

        warm = threading.Thread(target=warm_master, name="smoke24-warm",
                                daemon=True)
        warm.start()

        def listening() -> bool:
            for url, pr in procs.items():
                if pr.poll() is not None:
                    fail(f"24a: the {url} process exited: "
                         f"{_tail(logs[url])}")
            try:
                for port in (mport, *vports):
                    socket.create_connection(("127.0.0.1", port),
                                             1).close()
                return True
            except OSError:
                return False

        _poll(listening, STREAM_DEADLINE, "24a: the processes listening")
        t_listen = time.perf_counter() - t0

        def registered() -> set[str]:
            # /dir/status, not /cluster/status: the latter's first call
            # imports the mesh module (torch) in the master process
            topo = env.master_get("/dir/status")["Topology"]
            return {n["url"] for dc in topo["datacenters"]
                    for rk in dc["racks"] for n in rk["nodes"]}

        _poll(lambda: registered() == set(dirs), STREAM_DEADLINE,
              "24a: every volume process registered")
        wd = env.master_get("/debug/repair")
        walls["a"] = time.perf_counter() - t0
        log(f"[24a] {card}; `master` with no -pulseSeconds (5.0 s, "
            f"SeaweedFS's default), -repair.enabled -repair.interval "
            f"{STREAM_INTERVAL} -repair.grace {STREAM_GRACE}; "
            f"{STREAM_SERVERS} `volume -dataplane python -ec.backend "
            f"{'cuda' if on_card else 'native'}` processes: all listening "
            f"{t_listen:.3f} s after the spawn, each on one heartbeat "
            f"stream and registered {walls['a']:.3f} s after it; "
            f"watchdog enabled {wd['enabled']}, grace {wd['grace']}")

        # 24b. 256 MiB over HTTP into one volume, sealed by ec.encode
        t0 = time.perf_counter()
        g = env.master_get("/vol/grow", collection="s24", count=1)
        if g.get("count") != 1:
            fail(f"24b: /vol/grow of s24: {g}")
        rng = np.random.default_rng([SEED, 24])
        sizes, total = [], 0
        while total < HTTP_FILL_BYTES:
            sizes.append(int(np.exp(rng.uniform(np.log(1 << 10),
                                                np.log(1 << 20)))))
            total += sizes[-1]
        fids: list[str] = []
        while len(fids) < len(sizes):
            a = verbs.assign(murl, collection="s24",
                             count=FILL_ASSIGN_BATCH)
            fids += [a.fid] + [f"{a.fid}_{i}" for i in range(1, a.count)]
            if int(a.fid.split(",")[0]) != int(fids[0].split(",")[0]):
                fail(f"24b: the assigns left one volume: {a.fid}")
        vid = int(fids[0].split(",")[0])
        home = env.volume_locations(vid)[0]
        seeds = rng.integers(0, 1 << 62, len(sizes))
        live: dict[str, str] = {}

        def put(i: int) -> int:
            data = np.random.default_rng(int(seeds[i])).bytes(sizes[i])
            verbs.upload(f"http://{home}/{fids[i]}", data)
            live[fids[i]] = hashlib.sha256(data).hexdigest()
            return len(data)

        t1 = time.perf_counter()
        filled = sum(_pool_map(put, range(len(sizes)),
                               threads=STREAM_THREADS))
        t_fill = time.perf_counter() - t1
        st = _get_json(f"http://{home}/status", timeout=30)
        dat = next(v["size"] for v in st["volumes"] if v["id"] == vid)
        before = {u: _tools_metrics(u)["launches"] for u in dirs}
        warm.join(timeout=STREAM_DEADLINE)
        repl.run_command(env, "lock")
        t1 = time.perf_counter()
        repl.run_command(env, f"ec.encode -volumeId={vid}")
        t_encode = time.perf_counter() - t1
        repl.run_command(env, "unlock")
        after = {u: _tools_metrics(u)["launches"] for u in dirs}
        out["encode"] = sum(after.values()) - sum(before.values())
        want = _encode_launches(dat)
        if on_card and out["encode"] != want:
            fail(f"24b: ec.encode of a {dat} B .dat: {out['encode']} "
                 f"launches, the size gives {want}")
        locs = env.ec_shard_locations(vid)
        if sorted(locs) != list(range(14)):
            fail(f"24b: volume {vid} after ec.encode: {locs}")

        def shard_path(url: str, sid: int) -> str:
            return os.path.join(dirs[url], f"s24_{vid}.ec{sid:02d}")

        sealed = {sid: sha256(shard_path(urls[0], sid))
                  for sid, urls in locs.items()}
        held = {u: sorted(s for s, urls in locs.items() if u in urls)
                for u in dirs}
        for url in dirs:
            g = env.master_get("/vol/grow", collection="w24", count=1,
                               dataNode=url)
            if g.get("count") != 1:
                fail(f"24b: /vol/grow of w24 on {url}: {g}")
        if _repair_results(env, vid=vid):
            fail(f"24b: the watchdog repaired volume {vid} during its "
                 f"ec.encode")
        walls["b"] = time.perf_counter() - t0
        log(f"[24b] volume {vid}: {len(sizes)} needles of 1 KiB-1 MiB, "
            f"{filled} B on {STREAM_THREADS} threads in {t_fill:.3f} s "
            f"({filled / t_fill / 1e6:.1f} MB/s), .dat {dat} B; ec.encode "
            f"{t_encode:.3f} s, {out['encode']} launches (/metrics; the "
            f"size gives {want}); shards by server "
            f"{ {u: len(s) for u, s in held.items()} }; no repair during "
            f"the seal; a w24 volume grown on each server; "
            f"{walls['b']:.3f} s")

        # 24c. a writer assigning into w24; SIGKILL the fewest-shard server
        t0 = time.perf_counter()
        victim = min(held, key=lambda u: (len(held[u]), u))
        assigns: list[tuple[float, str, bool]] = []
        acked: dict[str, tuple[str, bytes]] = {}
        wrng = np.random.default_rng([SEED, 24, 1])
        lo, hi = np.log(STREAM_WRITES[0]), np.log(STREAM_WRITES[1])

        def write_loop() -> None:
            while not stop_writer.is_set():
                data = wrng.bytes(int(np.exp(wrng.uniform(lo, hi))))
                t_a = time.monotonic()
                try:
                    a = verbs.assign(murl, collection="w24")
                except Exception as e:  # noqa: BLE001 — recorded below
                    assigns.append((t_a, f"error: {e}", False))
                    continue
                try:
                    verbs.upload(f"http://{a.url}/{a.fid}", data)
                    acked[a.fid] = (a.url, data)
                    assigns.append((t_a, a.url, True))
                except Exception:  # noqa: BLE001 — counted as failed
                    assigns.append((t_a, a.url, False))

        writer = threading.Thread(target=write_loop, name="smoke24-writer",
                                  daemon=True)
        writer.start()
        _poll(lambda: sum(1 for x in assigns if x[1] == victim) >= 8,
              STREAM_DEADLINE, "24c: the writer reaching every server")
        _repair_results(env)
        rebuild_before = {u: _tools_metrics(u)["launches"]
                          for u in dirs if u != victim}
        since = time.time()
        seen: dict[str, float] = {}

        def reap() -> None:
            procs[victim].wait()
            seen["reaped"] = time.monotonic() - k0

        k0 = time.monotonic()
        os.kill(procs[victim].pid, signal.SIGKILL)
        reaper = threading.Thread(target=reap, name="smoke24-reap",
                                  daemon=True)
        reaper.start()

        def detected() -> bool:
            if "lookup" not in seen:
                urls = env.volume_locations(vid)
                if urls and victim not in urls:
                    seen["lookup"] = time.monotonic() - k0
            if "under" not in seen:
                up = env.master_get("/debug/repair")["under_parity"]
                if any(e["volume"] == vid for e in up):
                    seen["under"] = time.monotonic() - k0
            return "lookup" in seen and "under" in seen

        _poll(detected, STREAM_DEADLINE, "24c: the master dropping "
              f"{victim}", step=0.005)
        t_detect = k0 + seen["lookup"]
        reaper.join(timeout=15)
        rec = _poll(lambda: next(iter(_repair_results(
            env, since=since, vid=vid, kind="ec")), None),
            STREAM_DEADLINE, f"24c: the watchdog's rebuild of {vid}")
        t_repaired = time.monotonic() - k0
        stop_writer.set()
        writer.join(timeout=30)
        before_det = [x for x in assigns if k0 <= x[0] < t_detect]
        after_det = [x for x in assigns if x[0] >= t_detect]
        named_before = sum(1 for x in before_det if x[1] == victim)
        named_after = sum(1 for x in after_det if x[1] == victim)
        if named_after:
            fail(f"24c: {named_after} of {len(after_det)} assigns after "
                 f"the detection named the dead {victim}")
        if on_card and seen["lookup"] >= 1.0:
            fail(f"24c: detection took {seen['lookup']:.3f} s at the 5 s "
                 f"pulse")
        walls["c"] = time.perf_counter() - t0
        log(f"[24c] SIGKILLed {victim} (shards {held[victim]}, the "
            f"fewest): detection (stream closed) {seen['lookup']:.3f} s "
            f"to /dir/lookup dropping it, {seen['under']:.3f} s to "
            f"UnderParity listing volume {vid} (the 5-pulse reaper: up to "
            f"25 s); the killed process reaped {seen['reaped']:.3f} s "
            f"after the kill (its sockets close as it exits); assigns "
            f"naming it {named_before} of "
            f"{len(before_det)} between the kill and the detection, "
            f"{named_after} of {len(after_det)} after it; the watchdog's "
            f"rebuild done {t_repaired:.3f} s after the kill (grace "
            f"{STREAM_GRACE} s): mode {rec['detail'].get('mode')!r}, "
            f"rebuilt {rec['detail'].get('rebuilt')} on "
            f"{rec['detail'].get('rebuilder')}, {rec['seconds']} s; "
            f"{walls['c']:.3f} s")

        # 24d. launches, shards and every live needle
        t0 = time.perf_counter()
        out["rebuild"] = sum(_tools_metrics(u)["launches"] - n
                             for u, n in rebuild_before.items())
        if on_card and out["rebuild"] <= 0:
            fail(f"24d: the watchdog's rebuild made {out['rebuild']} "
                 f"launches")
        locs = _poll(lambda: (lambda m: m if sorted(m) == list(range(14))
                              else None)(env.ec_shard_locations(vid)),
                     STREAM_DEADLINE, "24d: 14 live shards")
        bad = [sid for sid, urls in locs.items()
               if sha256(shard_path(urls[0], sid)) != sealed[sid]]
        if bad or any(victim in urls for urls in locs.values()):
            fail(f"24d: shards {bad} differ from the sealed ones, or the "
                 f"dead server is listed: {locs}")
        readers = sorted({u for urls in locs.values() for u in urls})

        def check(item: tuple[int, str]) -> int:
            i, fid = item
            r = session().get(f"http://{readers[i % len(readers)]}/{fid}",
                              timeout=60)
            if r.status_code != 200 or \
                    hashlib.sha256(r.content).hexdigest() != live[fid]:
                fail(f"24d: {fid} reads {r.status_code}, "
                     f"{len(r.content)} B, not the written bytes "
                     f"({r.content[:200]!r})")
            return len(r.content)

        t1 = time.perf_counter()
        nb = sum(_pool_map(check, list(enumerate(sorted(live))),
                           threads=STREAM_THREADS))
        t_read = time.perf_counter() - t1
        kept = {f: v for f, v in acked.items() if v[0] != victim}

        def check_kept(fid: str) -> None:
            url, data = kept[fid]
            r = session().get(f"http://{url}/{fid}", timeout=30)
            if r.status_code != 200 or r.content != data:
                fail(f"24d: the writer's {fid} on {url} reads "
                     f"{r.status_code}, not its bytes")

        _pool_map(check_kept, sorted(kept), threads=STREAM_THREADS)
        walls["d"] = time.perf_counter() - t0
        log(f"[24d] rebuild launches {out['rebuild']} (the survivors' "
            f"/metrics); 14 shards listed, none on the dead server, "
            f"sha256-equal to the sealed ones; {len(live)} live needles of "
            f"volume {vid} read back byte-equal from {len(readers)} "
            f"servers in {t_read:.3f} s ({nb / t_read / 1e6:.1f} MB/s); "
            f"the writer's {len(kept)} acked needles on live servers "
            f"equal ({len(acked) - len(kept)} acked on {victim} went with "
            f"it, unreplicated); {walls['d']:.3f} s")
        wall = time.perf_counter() - t_phase
        now_dev = (torch.cuda.current_device()
                   if torch.cuda.is_available() else None)
        if now_dev != cur:
            fail(f"phase 24 moved the current device from {cur} to "
                 f"{now_dev}")
        log(f"[24] phase 24 took {wall:.3f} s "
            f"({ {k: round(v, 3) for k, v in walls.items()} }); kernel "
            f"launches { {k: out[k] for k in ('encode', 'rebuild')} }; "
            f"{card}")
        out["detection_s"] = {k: round(seen[k], 6)
                              for k in ("lookup", "under", "reaped")}
        out["assigns_to_dead"] = {"before": named_before,
                                  "after": named_after}
        return out
    finally:
        stop_writer.set()
        if writer is not None:
            writer.join(timeout=30)
        if env is not None:
            env.close()
        for p_ in procs.values():
            if p_.poll() is None:
                p_.terminate()
        for p_ in procs.values():
            try:
                p_.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p_.kill()
                p_.wait(timeout=15)
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        import seaweedfs_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"run from the root of the repository: {e}")
    t_start = time.perf_counter()
    walls: dict[int, float] = {}

    def timed(n: int, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[n] = round(time.perf_counter() - t0, 3)
        # the phase's freed device memory goes back to the card: phase
        # 16's volume processes allocate on the same card
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[mem] after phase {n}: {torch.cuda.memory_allocated()} B "
            f"allocated, {torch.cuda.memory_reserved()} B reserved")
        return out

    card = timed(1, phase_device)
    max_err, timings = timed(2, phase_kernel)
    launches, shard_hashes = timed(3, phase_main_path)
    timed(4, phase_batched)
    sweep_launches, decode_launches = timed(5, phase_router_lifecycle)
    gen_launches, reb_launches = timed(6, phase_store)
    cluster_launches = timed(7, phase_cluster, card)
    mesh = timed(8, phase_mesh, shard_hashes)
    heal_launches = timed(9, phase_heal, card)
    s3_launches = timed(10, phase_s3, card)
    ha_launches = timed(11, phase_ha, card)
    tier_launches = timed(12, phase_tier, card)
    chaos_launches = timed(13, phase_chaos, card)
    secure_launches = timed(14, phase_secure, card)
    native_launches = timed(15, phase_native, card)
    tools_launches = timed(16, phase_tools, card)
    remote = timed(17, phase_remote, card)
    sync = timed(18, phase_sync, card)
    stores = timed(19, phase_stores, card)
    forms = timed(20, phase_form, card)
    gateways = timed(21, phase_gateways, card)
    mounted = timed(22, phase_mount, card)
    pictures = timed(23, phase_images, card)
    stream = timed(24, phase_stream, card)
    log(f"[walls] seconds by phase {walls}; phases 1-24 "
        f"{time.perf_counter() - t_start:.3f} s")
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
        "tools_launches": sum(tools_launches.values()),
        "tools_launches_by_step": tools_launches,
        "remote_launches": remote["encode"] + remote["rebuild"],
        "remote_launches_by_step": {k: remote[k]
                                    for k in ("encode", "rebuild")},
        "remote_kernel_ms_per_launch": remote["kernel_ms_per_launch"],
        "remote_idle_share": remote["idle_share"],
        "sync_launches": sync["encode"] + sync["rebuild"],
        "sync_launches_by_step": {k: sync[k] for k in ("encode", "rebuild")},
        "sync_kernel_ms_per_launch": sync["kernel_ms_per_launch"],
        "sync_idle_share": sync["idle_share"],
        "sync_lag_ms": sync["lag_ms"],
        "stores_launches": stores["encode"] + stores["rebuild"],
        "stores_launches_by_step": {k: stores[k]
                                    for k in ("encode", "rebuild")},
        "stores_kernel_ms_per_launch": stores["kernel_ms_per_launch"],
        "stores_idle_share": stores["idle_share"],
        "form_launches": forms["encode"] + forms["rebuild"],
        "form_launches_by_step": {k: forms[k]
                                  for k in ("encode", "rebuild")},
        "form_kernel_ms_per_launch": forms["kernel_ms_per_launch"],
        "form_idle_share": forms["idle_share"],
        "gateways_launches": gateways["encode"] + gateways["rebuild"],
        "gateways_launches_by_step": {k: gateways[k]
                                      for k in ("encode", "rebuild")},
        "gateways_kernel_ms_per_launch": gateways["kernel_ms_per_launch"],
        "gateways_idle_share": gateways["idle_share"],
        "mount_launches": mounted["encode"] + mounted["rebuild"],
        "mount_launches_by_step": {k: mounted[k]
                                   for k in ("encode", "rebuild")},
        "mount_kernel_ms_per_launch": mounted["kernel_ms_per_launch"],
        "mount_idle_share": mounted["idle_share"],
        "mount_fuse": mounted["fuse"],
        "images_launches": pictures["encode"] + pictures["rebuild"],
        "images_launches_by_step": {k: pictures[k]
                                    for k in ("encode", "rebuild")},
        "images_kernel_ms_per_launch": pictures["kernel_ms_per_launch"],
        "images_idle_share": pictures["idle_share"],
        "images_renditions": pictures["renditions"],
        "analysis": pictures["analysis"],
        "stream_launches": stream["encode"] + stream["rebuild"],
        "stream_launches_by_step": {k: stream[k]
                                    for k in ("encode", "rebuild")},
        "stream_detection_s": stream["detection_s"],
        "stream_assigns_to_dead": stream["assigns_to_dead"],
    }]}
    print(json.dumps(record), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
