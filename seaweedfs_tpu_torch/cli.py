"""Command-line entry point — the `weed` binary equivalent; the
counterpart of seaweedfs_tpu/cli.py. Run as
`python -m seaweedfs_tpu_torch <cmd>`.

Subcommands: master (`-peers` and `-raftDir` for raft-replicated HA
masters), master.follower (a read-only lookup service fed by the
masters' KeepConnected stream), volume (`-mserver` lists every master),
filer, s3, server (master + one volume server in one process, `-filer`
and `-s3` adding a filer and the S3 gateway) and shell (`-filer` takes
the admin lock through the filer's DLM; `-master` may list every
master, and the shell talks to the leader). `-ec.backend` picks the
codec a volume server runs its EC encode and rebuild on: auto (the
measured router; needs a GPU), cuda (the hand-written kernel; needs a
GPU), mesh (the kernel on every local card, shaped by
`-ec.mesh.devices` / `-ec.mesh.col`), native (the AVX2 host codec) or
numpy. `-ec.code` sets the code family
new EC volumes are encoded with. `-repair.*` configure the master's
redundancy watchdog and `-admin.scripts` its maintenance timer, on
`master` and on `server`; `-tier.*` (on `master` only, as the
reference's) its tiering controller, `-tier.remote` the cold tier as
JSON (`{"type": "s3", "endpoint": ..., "bucket": ...}`) or
`local:<root>`. The filer's stores are memory and sqlite
(`-filer.store`, the reference's default sqlite on `server`).

The global flags, placed before the subcommand, are the reference's:
`-trace.slowThreshold|bufferSize|sample|otlpUrl` (tracing, the span
pushers' sampling, and the master's OTLP push), `-fault.spec` /
`-fault.seed` (seeded fault injection on every server and the client),
`-retry.maxAttempts|baseDelay|maxDelay|edgeBudget` and
`-breaker.failures|reset`. Each volume, filer and s3 process pushes
its spans to the master's collector (rpc/trace_push.SpanPusher; the s3
gateway finds the master through its filer); `server` runs everything
in the master's process, whose collector sees every span directly.
`-master.traceStore`, `-master.scrapeInterval` and `-advisor.*` size
the master's collector, federation and workload advisors.

The secured, durable write path, with the reference's names: the global
`-security <json>` (`{"https": {"cert", "key", "ca", "client_auth"}}`,
utils/tls.py) puts HTTPS on the master, master.follower, filer and s3
listeners — the volume servers' blob HTTP stays plain, as the
reference's does — and clients trust the CA through REQUESTS_CA_BUNDLE
or SSL_CERT_FILE; `master -jwt.secret` signs every assign and `volume
-jwt.secret` checks every write; `-commit.durability|maxDelay|maxBytes`
(volume, server) set the ack contract (storage/commit.py); the global
`-qos.*` flags the gateways' per-tenant admission (utils/qos.py).

The native data plane, with the reference's flags: `-dataplane
auto|native|python` (volume, server) puts the C++ front
(native/dataplane.cc) on the volume server's public port — `auto`, the
default, when the library builds (else Python, with one line on
stderr), `native` or fail — and moves the Python app to a loopback
backend port it relays to; the store's public url is the front's.
`server -filer.native` and `-s3.native` (auto|native|python) put the
native filer and S3 fronts on the public filer and S3 ports; they append
to the in-process volume store, so they need the native volume front
(`auto` follows it, `native` without it is an error) and a standalone
`filer` serves Python only. `-filer.native.workers` sizes the filer
front's relay pool. Requests a front answers never reach the Python
taps (spans, workload sketches): run `-dataplane python` to see them.

The client and offline tools, with the reference's flags and output
lines: `upload` (`-maxMB` splits a file into chunk needles and a
?cm=true manifest), `download`, `backup` (operation/backup.py),
`benchmark` (`-client python` on threads over rpc/httpclient,
`-client native` on the C++ bench client of native/dataplane.py,
`-target s3|filer` the gateways), `fix`, `compact`, `export`,
`see.dat`, `see.idx` (operation/tools.py, on a stopped volume's
files), `filer.cat`, `filer.copy`, `scaffold`, `version`,
`autocomplete`, `unautocomplete`, `update`. The python benchmark signs
its writes when the master hands out tokens and counts a non-2xx write
as an error (the reference counts any answer as a write).

The filer's metadata-stream consumers (rpc/meta_subscriber.py over the
filer's /ws/meta_subscribe), with the reference's flags and lines:
`filer.remote.sync -dir` pushes writes under a remote mount back to its
cloud storage, `filer.remote.gateway` (`-createBucketAt`,
`-createBucketWithRandomSuffix`, `-include`, `-exclude`) mirrors the
buckets under /buckets, `filer.meta.tail` (`-path`, `-pattern`) prints
each event as one JSON line. The replication workers over the same
stream (replication/): `filer.replicate -sink kind:args` mirrors
`-path` into one of six sinks (local, filer, s3, gcs, azure, b2),
`filer.sync -a -b` keeps two filers in sync both ways (`-oneWay` for
A -> B only) under `-path`, `filer.backup -dir` copies the files under
`-path` into a local directory (its offset key names the path and the
directory) and `filer.meta.backup -o` keeps the namespace in a sqlite
file.

The gateways over the filer, with the reference's flags and defaults:
`ftp` (port 8021, `-filer.path`, `-user user:password`, anonymous
without it; ftpd/), `webdav` (7333, `-filer.path`; webdav/, HTTPS from
`-security`, its spans pushed to the master its filer names), `iam`
(8111; iam/, HTTPS from `-security`) and `mq.broker` (17777,
`-master`, where it announces itself as a `broker`; mq/). Each runs
until interrupted: stop a broker with SIGINT, which flushes its
unflushed records (a SIGTERM loses them, as the reference's does).

The FUSE mount (mount/): `mount -filer F -dir D` serves the filer
directory `-filer.path` at the mountpoint D through the kernel
(libfuse.so.2 over ctypes) until `fusermount -u D`, with
`-cacheDir` (the chunk cache's disk tier and the dirty pages' swap
file), `-writeMemoryLimitMB` (dirty RAM per open file),
`-collection`, `-replication`, `-o` (fuse options) and
`-disableXAttr`; `fuse D -o filer=F,filer.path=/d,ro` is the
/sbin/mount.fuse helper form, which takes filer, filer.path,
collection, replication, cacheDir and disableXAttr from `-o` and
passes the rest to fuse. Profiling and metrics, as global flags:
`-cpuprofile FILE` writes a cProfile dump of the subcommand when it
returns, `-memprofile FILE` a tracemalloc report of its top
allocations, and `-metrics.address HOST:PORT` PUTs the process's
metrics to that Prometheus pushgateway as job <subcommand> every
`-metrics.intervalSec` seconds.
"""
from __future__ import annotations

import argparse
import os
import sys


def _add_ec_flags(p) -> None:
    p.add_argument("-ec.backend", dest="ec_backend", default="auto",
                   help="erasure-coding codec: auto (measured-curve "
                        "router; needs a GPU) | cuda (the CUDA kernel; "
                        "needs a GPU) | mesh (the kernel on every local "
                        "GPU) | native | numpy")
    p.add_argument("-ec.code", dest="ec_code", default="",
                   help="erasure-code family new EC volumes are "
                        "encoded with: 10.4 (RS default) | 28.4 "
                        "(wide RS) | lrc-k.l.g e.g. lrc-12.3.2 "
                        "(k data, l local XOR parities, g global "
                        "parities; single-shard repair reads one "
                        "local group instead of k shards); recorded "
                        "per volume so mixed-code clusters decode "
                        "correctly")
    p.add_argument("-ec.mesh.devices", dest="ec_mesh_devices",
                   type=int, default=0,
                   help="GPUs the mesh codec spans (0 = all local GPUs)")
    p.add_argument("-ec.mesh.col", dest="ec_mesh_col", type=int,
                   default=0,
                   help="column-parallel axis of the mesh codec's "
                        "(vol, col) grid; must divide the device "
                        "count (0 = heuristic)")
    p.add_argument("-index", default="memory",
                   help="needle map kind: memory | compact | btree")


def _add_master_flags(p) -> None:
    """The self-healing plane's flags, with the reference's defaults."""
    p.add_argument("-admin.scripts", dest="admin_scripts",
                   default="",
                   help="semicolon-separated shell maintenance commands "
                        "run periodically by the master, e.g. "
                        "'volume.vacuum; volume.fix.replication'")
    p.add_argument("-admin.scriptInterval",
                   dest="admin_script_interval", type=float,
                   default=60.0)
    p.add_argument("-repair.enabled", dest="repair_enabled",
                   action="store_true",
                   help="drive automatic repair of under-replicated "
                        "volumes and under-parity EC volumes from the "
                        "redundancy watchdog queue (tracking and "
                        "/debug/repair reporting are always on)")
    p.add_argument("-repair.interval", dest="repair_interval",
                   type=float, default=10.0,
                   help="seconds between watchdog deficit scans; "
                        "heartbeats and unregistrations also trigger "
                        "an immediate scan")
    p.add_argument("-repair.concurrency", dest="repair_concurrency",
                   type=int, default=2,
                   help="max repairs (volume re-replications / EC "
                        "shard rebuilds) running at once")
    p.add_argument("-repair.maxAttempts", dest="repair_max_attempts",
                   type=int, default=5,
                   help="attempts per repair task before giving up; "
                        "retries back off with the shared full-jitter "
                        "retry policy")
    p.add_argument("-repair.grace", dest="repair_grace",
                   type=float, default=0.0,
                   help="seconds a deficit must persist before repair "
                        "starts (0 = repair on first scan)")
    p.add_argument("-repair.maxBytesPerSec",
                   dest="repair_max_bytes_per_sec",
                   type=float, default=0.0,
                   help="per-node repair byte-rate cap: every repair "
                        "copy and reconstruction read debits a shared "
                        "token bucket on its source and destination "
                        "volume server (0 = unshaped)")
    p.add_argument("-repair.partialEc", dest="repair_partial_ec",
                   type=lambda s: s.lower() not in
                   ("0", "false", "no"),
                   default=True,
                   help="rebuild a lost EC shard from only the k shard "
                        "ranges reconstruction needs, instead of "
                        "borrowing every surviving shard file (false = "
                        "always full-stripe)")


def _add_tier_flags(p) -> None:
    """The tiering controller's flags (master only, as the
    reference's), with the reference's defaults."""
    p.add_argument("-tier.enabled", dest="tier_enabled",
                   action="store_true",
                   help="drive the tiered-storage lifecycle (hot -> "
                        "warm EC -> cold remote) from the master "
                        "tiering controller; heat tracking and "
                        "/debug/tiering reporting are always on")
    p.add_argument("-tier.interval", dest="tier_interval",
                   type=float, default=30.0,
                   help="seconds between tiering heat scans; "
                        "heartbeats also trigger an immediate scan")
    p.add_argument("-tier.concurrency", dest="tier_concurrency",
                   type=int, default=1,
                   help="max tier transitions (seal/offload/recall) "
                        "running at once")
    p.add_argument("-tier.sealAfterIdle", dest="tier_seal_after_idle",
                   type=float, default=3600.0,
                   help="seconds a plain volume must be idle (no "
                        "reads or writes) before it is sealed and "
                        "erasure-coded into the warm tier")
    p.add_argument("-tier.offloadAfterIdle",
                   dest="tier_offload_after_idle",
                   type=float, default=7200.0,
                   help="seconds an EC volume must go unread before "
                        "its shard bytes are offloaded to the remote "
                        "cold tier (indexes stay local)")
    p.add_argument("-tier.recallReads", dest="tier_recall_reads",
                   type=int, default=3,
                   help="reads within -tier.recallWindow that recall "
                        "a remote volume back to the hot tier")
    p.add_argument("-tier.recallWindow", dest="tier_recall_window",
                   type=float, default=300.0,
                   help="trailing window (seconds) over which "
                        "-tier.recallReads is counted")
    p.add_argument("-tier.maxAttempts", dest="tier_max_attempts",
                   type=int, default=5,
                   help="attempts per tier transition before giving "
                        "up; retries back off with the shared "
                        "-retry.* full-jitter policy")
    p.add_argument("-tier.maxBytesPerSec",
                   dest="tier_max_bytes_per_sec",
                   type=float, default=0.0,
                   help="per-node tier byte-rate cap: every offload "
                        "upload and recall download debits a shared "
                        "token bucket on its volume server, so bulk "
                        "tier movement cannot saturate the data "
                        "plane (fill/debt live in /cluster/status; "
                        "0 = unshaped)")
    p.add_argument("-tier.remote", dest="tier_remote", default="",
                   help="cold-tier destination: JSON client conf "
                        "('{\"type\": \"s3\", ...}') or the "
                        "local:<root> shorthand; offload stays off "
                        "until set")
    p.add_argument("-tier.stateDir", dest="tier_state_dir", default="",
                   help="dir persisting the per-volume tier state "
                        "machine so transitions resume across master "
                        "restarts (empty = in-memory only)")


def _tier_kwargs(args) -> dict:
    from .remote_storage.client import parse_remote_spec

    return {
        "tier_enabled": args.tier_enabled,
        "tier_interval": args.tier_interval,
        "tier_concurrency": args.tier_concurrency,
        "tier_seal_after_idle": args.tier_seal_after_idle,
        "tier_offload_after_idle": args.tier_offload_after_idle,
        "tier_recall_reads": args.tier_recall_reads,
        "tier_recall_window": args.tier_recall_window,
        "tier_max_attempts": args.tier_max_attempts,
        "tier_max_bytes_per_sec": args.tier_max_bytes_per_sec,
        "tier_remote": (parse_remote_spec(args.tier_remote)
                        if args.tier_remote else None),
        "tier_state_dir": args.tier_state_dir,
    }


def _ssl_ctx(args):
    """The server SSLContext from -security (None = plain HTTP), for the
    control-plane and gateway listeners (master, follower, filer, s3);
    the volume servers' HTTP data path stays plain, as the reference's
    (tls.go wraps gRPC, not the blob HTTP port)."""
    path = getattr(args, "security", "")
    if not path:
        return None
    from .utils.tls import context_from_config, load_security_config

    return context_from_config(load_security_config(path))


def _add_commit_flags(p) -> None:
    """The group-commit knobs of the volume and server commands
    (storage/commit.py)."""
    p.add_argument(
        "-commit.durability", dest="commit_durability",
        default="buffered", choices=["buffered", "batch", "sync"],
        help="write ack contract: buffered = ack after the userspace "
             "append (today's semantics), batch = ack only after the "
             "covering group-commit fsync (~1 fsync/batch), sync = "
             "per-write fsync oracle; recorded per response in the "
             "X-Sw-Durability header")
    p.add_argument(
        "-commit.maxDelay", dest="commit_max_delay", type=float,
        default=0.002,
        help="seconds the group-commit batch window stays open after "
             "its first write before the covering fsync (default "
             "0.002); smaller = lower ack latency, larger = more "
             "coalescing")
    p.add_argument(
        "-commit.maxBytes", dest="commit_max_bytes", type=int,
        default=4 << 20,
        help="bytes that close the group-commit batch window early, "
             "before -commit.maxDelay elapses (default 4MiB)")


def _commit_kwargs(args) -> dict:
    return {"commit_durability": args.commit_durability,
            "commit_max_delay": args.commit_max_delay,
            "commit_max_bytes": args.commit_max_bytes}


def _master_kwargs(args) -> dict:
    return {
        "admin_scripts": [s.strip() for s in args.admin_scripts.split(";")
                          if s.strip()],
        "admin_script_interval": args.admin_script_interval,
        "repair_enabled": args.repair_enabled,
        "repair_interval": args.repair_interval,
        "repair_concurrency": args.repair_concurrency,
        "repair_max_attempts": args.repair_max_attempts,
        "repair_grace": args.repair_grace,
        "repair_max_bytes_per_sec": args.repair_max_bytes_per_sec,
        "repair_partial_ec": args.repair_partial_ec,
    }


class _TopParser(argparse.ArgumentParser):
    """The top-level parser, which matches no prefix of its flags. Some
    Python 3.12 releases match every argument against those prefixes
    before the subcommand's parser sees it, whatever allow_abbrev says,
    so `filer.sync -a A -b B` stopped with "ambiguous option: -b could
    match -breaker.failures, -breaker.reset" (the reference's parser
    keeps that fault)."""

    def _get_option_tuples(self, option_string):
        # a one-letter flag with its value attached (-v2) still parses
        return [t for t in super()._get_option_tuples(option_string)
                if t[1] == option_string[:2]]


def build_parser() -> argparse.ArgumentParser:
    parser = _TopParser(
        prog="seaweedfs-tpu-torch",
        description="SeaweedFS with its erasure coding on a GPU")
    parser.add_argument(
        "-cpuprofile", default="",
        help="write a cProfile dump here on exit (the reference's "
             "grace.SetupProfiling, util/grace/pprof.go:11); place "
             "BEFORE the subcommand")
    parser.add_argument(
        "-v", dest="verbosity", type=int, default=0,
        help="log verbosity for glog.v() messages; place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-vmodule", default="",
        help="per-file log levels, e.g. store=2,volume_server=3")
    parser.add_argument(
        "-memprofile", default="",
        help="write a tracemalloc top-allocations report here on exit "
             "(the reference's -memprofile); place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-metrics.address", dest="metrics_address", default="",
        help="Prometheus pushgateway address to push metrics to "
             "(stats/metrics.go pusher); place BEFORE the subcommand")
    parser.add_argument(
        "-metrics.intervalSec", dest="metrics_interval", type=float,
        default=15.0)
    parser.add_argument(
        "-trace.slowThreshold", dest="trace_slow_threshold", type=float,
        default=1.0,
        help="emit one structured glog line with the full span tree "
             "for root requests slower than this many seconds "
             "(<= 0 disables); place BEFORE the subcommand")
    parser.add_argument(
        "-trace.bufferSize", dest="trace_buffer_size", type=int,
        default=1024,
        help="spans kept in the in-process ring served at "
             "/debug/traces; place BEFORE the subcommand")
    parser.add_argument(
        "-trace.sample", dest="trace_sample", type=float, default=1.0,
        help="head-sampling fraction (0..1) of traces shipped to the "
             "master's span collector; the verdict hashes the trace-id "
             "so every process keeps the same traces; place BEFORE "
             "the subcommand")
    parser.add_argument(
        "-trace.otlpUrl", dest="trace_otlp_url", default="",
        help="master only: push collected traces as OTLP/JSON to this "
             "HTTP endpoint (e.g. a Jaeger/Tempo collector's "
             "/v1/traces); place BEFORE the subcommand")
    parser.add_argument(
        "-fault.spec", dest="fault_spec", default="",
        help="deterministic fault injection for internal hops, e.g. "
             "'volume:read:error=0.05,filer:*:delay=30ms' "
             "(service:op:kind=value, comma-separated; also via "
             "SEAWEEDFS_TPU_FAULT_SPEC); place BEFORE the subcommand")
    parser.add_argument(
        "-fault.seed", dest="fault_seed", type=int, default=0,
        help="RNG seed for -fault.spec error draws (same seed + same "
             "request sequence = same chaos); place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-retry.maxAttempts", dest="retry_max_attempts", type=int,
        default=None,
        help="attempts per internal hop (default 3); place BEFORE "
             "the subcommand")
    parser.add_argument(
        "-retry.baseDelay", dest="retry_base_delay", type=float,
        default=None,
        help="first-retry backoff cap in seconds (full jitter, "
             "default 0.02); place BEFORE the subcommand")
    parser.add_argument(
        "-retry.maxDelay", dest="retry_max_delay", type=float,
        default=None,
        help="backoff cap in seconds (default 1.0); place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-retry.edgeBudget", dest="retry_edge_budget", type=float,
        default=None,
        help="overall deadline in seconds minted at the s3/filer edge "
             "when the client sent no X-Sw-Deadline (default 300); "
             "place BEFORE the subcommand")
    parser.add_argument(
        "-breaker.failures", dest="breaker_failures", type=int,
        default=None,
        help="consecutive connection failures that open a peer's "
             "circuit breaker (default 5); place BEFORE the subcommand")
    parser.add_argument(
        "-breaker.reset", dest="breaker_reset", type=float,
        default=None,
        help="seconds an open breaker waits before its half-open "
             "probe (default 5); place BEFORE the subcommand")
    parser.add_argument(
        "-hedge.delay", dest="hedge_delay", type=float, default=None,
        help="seconds a replica read waits before hedging to an "
             "alternate location (default 0.35); place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-qos.enabled", dest="qos_enabled", action="store_true",
        help="per-tenant QoS + overload shedding at the s3/filer "
             "gateway edge (tenant = access key at s3, first path "
             "segment at the filer); place BEFORE the subcommand")
    parser.add_argument(
        "-qos.rate", dest="qos_rate", type=float, default=None,
        help="default per-tenant byte rate at the gateway edge "
             "(bytes/sec; 0 = unlimited); place BEFORE the subcommand")
    parser.add_argument(
        "-qos.burst", dest="qos_burst", type=float, default=None,
        help="default per-tenant burst allowance in bytes (default "
             "max(64KiB, rate/8)); place BEFORE the subcommand")
    parser.add_argument(
        "-qos.maxTenants", dest="qos_max_tenants", type=int,
        default=None,
        help="distinct tenant buckets a gateway tracks before later "
             "tenants share the __overflow__ bucket — bounds both "
             "memory and the tenant metric label (default 256); "
             "place BEFORE the subcommand")
    parser.add_argument(
        "-qos.maxDelay", dest="qos_max_delay", type=float,
        default=None,
        help="seconds of quoted queue delay beyond which a request "
             "is shed with 503 instead of paced (default 2.0); "
             "requests whose X-Sw-Deadline budget is smaller than "
             "the quote are shed regardless; place BEFORE the "
             "subcommand")
    parser.add_argument(
        "-qos.requestFloor", dest="qos_request_floor", type=int,
        default=None,
        help="minimum bytes charged per request so body-less ops "
             "(GET/HEAD/LIST) are shaped too (default 4096); place "
             "BEFORE the subcommand")
    parser.add_argument(
        "-qos.spec", dest="qos_spec", default="",
        help="path to a per-tenant JSON spec "
             "('{\"default\": {\"rate\":...}, \"tenants\": {\"akid\": "
             "{\"rate\":..., \"priority\":...}}}'), hot-reloaded on "
             "mtime change; place BEFORE the subcommand")
    parser.add_argument(
        "-telemetry.enabled", dest="telemetry_enabled",
        type=lambda s: s.lower() not in ("0", "false", "no"),
        default=True,
        help="record workload sketches (per-volume heat histograms, "
             "per-tenant demand) and ship them on the heartbeat; "
             "false disables every record path (default true); "
             "place BEFORE the subcommand")
    parser.add_argument(
        "-telemetry.alpha", dest="telemetry_alpha", type=float,
        default=None,
        help="relative-error bound of the quantile sketches: any "
             "reported quantile is within alpha of the true value "
             "(default 0.01 = 1%%); place BEFORE the subcommand")
    parser.add_argument(
        "-telemetry.window", dest="telemetry_window", type=float,
        default=None,
        help="sliding-window horizon in seconds for workload "
             "sketches; older samples age out (default 300); place "
             "BEFORE the subcommand")
    parser.add_argument(
        "-security", default="",
        help="path to a security config JSON (scaffold "
             "-config=security): enables HTTPS (+ optional mutual "
             "TLS) on this process's listeners; place BEFORE the "
             "subcommand. Clients trust the CA via REQUESTS_CA_BUNDLE/"
             "SSL_CERT_FILE")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("master", help="start a master server")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    p.add_argument("-jwt.secret", dest="jwt_secret", default="")
    p.add_argument("-peers", default="",
                   help="comma-separated ip:port of all masters (HA mode)")
    p.add_argument("-raftDir", dest="raft_dir", default="",
                   help="raft log/term persistence dir")
    p.add_argument("-sequencer", default="memory",
                   choices=["memory", "snowflake"],
                   help="file-id sequencer (HA masters force "
                        "snowflake)")
    p.add_argument("-pulseSeconds", dest="pulse_seconds", type=float,
                   default=5.0,
                   help="the master's pulse, sent in each heartbeat "
                        "reply (a volume server beats at the shorter of "
                        "it and its own); members live 3 pulses and a "
                        "fresh leader holds repairs for 5. The "
                        "reference has no pulse flag")
    _add_master_flags(p)
    _add_tier_flags(p)
    p.add_argument("-master.traceStore", dest="trace_store_size",
                   type=int, default=2048,
                   help="max traces kept in the cluster span "
                        "collector (tail-based retention pins "
                        "error/slow traces)")
    p.add_argument("-master.scrapeInterval", dest="scrape_interval",
                   type=float, default=10.0,
                   help="seconds between metrics-federation sweeps "
                        "over every registered node's /metrics")
    p.add_argument("-advisor.sealQuantile",
                   dest="advisor_seal_quantile", type=float,
                   default=0.95,
                   help="idle-gap quantile the auto-seal advisor "
                        "targets: it recommends -tier.sealAfterIdle "
                        "just above this fraction of observed "
                        "inter-access gaps (default 0.95)")
    p.add_argument("-advisor.demandQuantile",
                   dest="advisor_demand_quantile", type=float,
                   default=0.9,
                   help="per-tenant demand quantile the QoS advisor "
                        "sizes provisioned rates against "
                        "(default 0.9)")
    p.add_argument("-advisor.headroom", dest="advisor_headroom",
                   type=float, default=1.5,
                   help="multiplier applied on top of observed "
                        "demand/idle quantiles before recommending "
                        "a threshold (default 1.5)")

    p = sub.add_parser("master.follower",
                       help="read-only master follower for lookup traffic")
    p.add_argument("-port", type=int, default=9334)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-masters", default="http://127.0.0.1:9333",
                   help="comma-separated master urls to follow")

    p = sub.add_parser("volume", help="start a volume server")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data", help="comma-separated dirs")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-mserver", default="127.0.0.1:9333",
                   help="comma-separated masters; heartbeats go to the "
                        "raft leader among them")
    p.add_argument("-dataCenter", default="DefaultDataCenter")
    p.add_argument("-rack", default="DefaultRack")
    p.add_argument("-disk", default="hdd",
                   help="disk class of this server (hdd | ssd)")
    p.add_argument("-concurrentUploadLimitMB", dest="upload_limit_mb",
                   type=int, default=256,
                   help="limit total in-flight upload bytes (0 = off)")
    p.add_argument("-concurrentDownloadLimitMB",
                   dest="download_limit_mb", type=int, default=256,
                   help="limit total in-flight download bytes (0 = off)")
    p.add_argument("-jwt.secret", dest="jwt_secret", default="",
                   help="HS256 secret for write authorization; must "
                        "match the master's -jwt.secret")
    _add_dataplane_flag(p)
    _add_ec_flags(p)
    _add_commit_flags(p)

    p = sub.add_parser("filer", help="start a filer server")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master", default="http://127.0.0.1:9333",
                   help="comma-separated masters")
    p.add_argument("-store", default="memory",
                   help="metadata store: memory | sqlite | leveldb | "
                        "redis | redis_cluster (seed list in "
                        "-store.host) | etcd | mongodb | cassandra | "
                        "mysql | mysql2 | postgres | postgres2 "
                        "(per-bucket tables, O(1) bucket drop) | "
                        "elastic | arangodb | hbase | tikv | ydb | "
                        "rocksdb (needs librocksdb)")
    p.add_argument("-store.path", dest="store_path", default=":memory:")
    p.add_argument("-store.host", dest="store_host", default="")
    p.add_argument("-store.port", dest="store_port", type=int, default=0)
    p.add_argument("-store.user", dest="store_user", default="",
                   help="db username (mysql/postgres/cassandra)")
    p.add_argument("-store.password", dest="store_password", default="")
    p.add_argument("-store.database", dest="store_database", default="")
    _add_store_layout_flags(p, "-store")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-encryptVolumeData", dest="encrypt_volume_data",
                   action="store_true",
                   help="encrypt chunk data on volume servers "
                        "(AES-256-GCM, per-chunk keys in filer metadata)")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=8,
                   help="split uploads into chunks of this many MiB")
    p.add_argument("-saveToFilerLimit", dest="save_to_filer_limit",
                   type=int, default=0,
                   help="files smaller than this many bytes are stored "
                        "inside the filer metadata entry (no volume "
                        "round trip); per-request ?saveInside=true "
                        "forces it")
    _add_filer_native_flags(p, default="python",
                            note="only the combined `server` command can "
                                 "honor 'native' (the front appends to an "
                                 "in-process volume store); a standalone "
                                 "filer always serves Python")

    p = sub.add_parser("s3", help="start an S3 gateway")
    p.add_argument("-port", type=int, default=8333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-config", default="",
                   help="json file with s3 identities")

    p = sub.add_parser("server",
                       help="combined master + volume (+ filer + s3)")
    p.add_argument("-dir", default="./data")
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master.port", dest="master_port", type=int,
                   default=9333)
    p.add_argument("-volume.port", dest="volume_port", type=int,
                   default=8080)
    p.add_argument("-filer", action="store_true")
    p.add_argument("-filer.port", dest="filer_port", type=int, default=8888)
    p.add_argument("-filer.store", dest="filer_store", default="sqlite")
    _add_store_layout_flags(p, "-filer.store")
    p.add_argument("-s3", action="store_true")
    p.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    p.add_argument("-s3.config", dest="s3_config", default="",
                   help="json file with s3 identities")
    p.add_argument("-s3.native", dest="s3_native", default="auto",
                   choices=["auto", "native", "python"],
                   help="native C++ S3 front for small-object PUT/GET "
                        "(needs the native volume front; everything "
                        "else relays to the Python S3 app)")
    _add_filer_native_flags(p, default="auto",
                            note="needs the native volume front; "
                                 "listings, renames and every other verb "
                                 "relay to the Python filer app")
    _add_dataplane_flag(p)
    p.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    _add_ec_flags(p)
    _add_master_flags(p)
    _add_commit_flags(p)

    p = sub.add_parser("shell", help="interactive admin shell")
    p.add_argument("-master", default="http://127.0.0.1:9333",
                   help="comma-separated masters; the shell talks to "
                        "the raft leader among them")
    p.add_argument("-filer", default="",
                   help="filer address for the cluster-wide admin lock")
    _add_gateway_parsers(sub)
    _add_mount_parsers(sub)
    _add_filer_worker_parsers(sub)
    _add_tool_parsers(sub)
    return parser


def _add_mount_parsers(sub) -> None:
    """The FUSE mount and its mount.fuse helper form (the reference's
    cli.py:660-690)."""
    p = sub.add_parser("mount", help="FUSE-mount a filer directory")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-filer.path", dest="filer_path", default="/")
    p.add_argument("-dir", required=True, help="local mountpoint")
    p.add_argument("-cacheDir", dest="cache_dir", default="")
    p.add_argument("-writeMemoryLimitMB", dest="write_memory_limit_mb",
                   type=int, default=64,
                   help="dirty-write RAM cap per open file; writes past "
                        "it spill to a swap file (0 = 64MB default)")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-o", dest="mount_options", default="",
                   help="extra comma-separated fuse options "
                        "(allow_other, ro, ...)")
    p.add_argument("-disableXAttr", dest="disable_xattr",
                   action="store_true",
                   help="disable extended attribute support "
                        "(get/set/list/remove return ENOTSUP)")

    p = sub.add_parser(
        "fuse",
        help="/sbin/mount.fuse-style mount helper: "
             "`fuse <mountpoint> -o filer=...,filer.path=/,ro` "
             "(the reference's weed fuse, command/fuse.go) — lets "
             "/etc/fstab mount a filer via `mount -t fuse.seaweedfs`")
    p.add_argument("mountpoint")
    p.add_argument("-o", dest="fuse_options", default="",
                   help="comma-separated key=value options; recognised: "
                        "filer, filer.path, collection, replication, "
                        "cacheDir; everything else passes to fuse")


def _add_gateway_parsers(sub) -> None:
    """The gateways over the filer (the reference's cli.py:577-582,
    :643-658)."""
    p = sub.add_parser("ftp", help="start an FTP gateway")
    p.add_argument("-port", type=int, default=8021)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-filer.path", dest="filer_path", default="/")
    p.add_argument("-user", default="",
                   help="user:password (empty = anonymous)")

    p = sub.add_parser("mq.broker", help="start a message-queue broker")
    p.add_argument("-port", type=int, default=17777)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-master", default="http://127.0.0.1:9333")

    p = sub.add_parser("webdav", help="start a WebDAV gateway")
    p.add_argument("-port", type=int, default=7333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-filer.path", dest="filer_path", default="/")

    p = sub.add_parser("iam", help="start an IAM API server")
    p.add_argument("-port", type=int, default=8111)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-filer", default="http://127.0.0.1:8888")


def _add_filer_worker_parsers(sub) -> None:
    """The filer's metadata-stream consumers, with the reference's
    flags: replication, sync and backups, remote-mount write-back, the
    bucket gateway and the tail."""
    p = sub.add_parser("filer.replicate",
                       help="mirror filer changes into a sink")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-path", default="/", help="source path prefix")
    p.add_argument("-sink", required=True,
                   help="local:<dir> | filer:<url>[,<destPath>] | "
                        "s3:<endpoint>,<bucket>[,<prefix>] | "
                        "gcs:<bucket>[,<prefix>[,<endpoint>]] | "
                        "azure:<account>,<key>,<container>[,<prefix>] | "
                        "b2:<keyId>,<appKey>,<bucket>[,<prefix>]")

    p = sub.add_parser("filer.sync",
                       help="active-active sync between two filers")
    p.add_argument("-a", required=True, help="filer A url")
    p.add_argument("-b", required=True, help="filer B url")
    p.add_argument("-path", default="/")
    p.add_argument("-oneWay", dest="one_way", action="store_true")

    p = sub.add_parser("filer.remote.sync",
                       help="push local writes under a remote mount "
                            "back to the cloud storage")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-dir", required=True, help="mounted directory")

    p = sub.add_parser("filer.remote.gateway",
                       help="mirror bucket creation/deletion and bucket "
                            "contents to the primary remote storage")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-createBucketAt", dest="create_bucket_at", default="",
                   help="remote storage name for new buckets "
                        "(defaults to the only configured storage)")
    p.add_argument("-createBucketWithRandomSuffix", dest="bucket_suffix",
                   action="store_true")
    p.add_argument("-include", default="",
                   help="glob of bucket names to mirror, e.g. s3*")
    p.add_argument("-exclude", default="",
                   help="glob of bucket names to skip, e.g. local*")

    p = sub.add_parser("filer.meta.backup",
                       help="continuous metadata backup to sqlite")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-path", default="/")
    p.add_argument("-o", dest="output", default="filer_meta_backup.db")

    p = sub.add_parser("filer.backup",
                       help="continuous file backup into a local dir "
                            "(filer.replicate with a local sink)")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-path", default="/", help="source path prefix")
    p.add_argument("-dir", required=True, help="local target directory")

    p = sub.add_parser("filer.meta.tail",
                       help="print the filer metadata event stream")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-path", default="/", help="path prefix filter")
    p.add_argument("-pattern", default="",
                   help="only events whose path contains this substring")


def _add_tool_parsers(sub) -> None:
    """The client and offline subcommands, with the reference's flags."""
    p = sub.add_parser("upload", help="upload files")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=0,
                   help="split files larger than this into chunk "
                        "needles + a manifest (submit.go maxMB)")
    p.add_argument("files", nargs="+")

    p = sub.add_parser("download", help="download a fid")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-o", dest="output", default="")
    p.add_argument("fid")

    p = sub.add_parser("fix", help="offline: rebuild a volume's .idx "
                                   "by scanning its .dat")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")

    for name, hlp in (("see.dat", "offline: dump every .dat record as "
                                  "JSON lines (debug inspector)"),
                      ("see.idx", "offline: dump every .idx entry as "
                                  "JSON lines (debug inspector)")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("-dir", default=".")
        p.add_argument("-volumeId", dest="volume_id", type=int,
                       required=True)
        p.add_argument("-collection", default="")

    p = sub.add_parser("compact", help="offline: vacuum a volume's "
                                       "deleted records")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")

    p = sub.add_parser("export", help="offline: dump live needles to tar")
    p.add_argument("-dir", default=".")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-collection", default="")
    p.add_argument("-o", dest="output", default="")
    p.add_argument("-newerThanNs", dest="newer_than_ns", type=int,
                   default=0)

    p = sub.add_parser("filer.cat", help="print a filer file to stdout")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("path")

    p = sub.add_parser("filer.copy", help="upload local files/dirs to a "
                                          "filer directory")
    p.add_argument("-filer", default="http://127.0.0.1:8888")
    p.add_argument("-collection", default="")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=0)
    p.add_argument("sources", nargs="+")
    p.add_argument("dest")

    p = sub.add_parser("backup", help="incrementally back up a volume "
                                      "to a local directory")
    p.add_argument("-server", "-master", dest="master",
                   default="http://127.0.0.1:9333")
    p.add_argument("-volumeId", dest="volume_id", type=int, required=True)
    p.add_argument("-dir", default=".")
    p.add_argument("-collection", default="")

    p = sub.add_parser("benchmark", help="write/read load generator")
    p.add_argument("-client", default="python",
                   choices=["python", "native"],
                   help="load generator: python threads or the C++ "
                        "keep-alive client — use native to measure a "
                        "native-dataplane server without the client's "
                        "GIL being the bottleneck")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-n", type=int, default=1000)
    p.add_argument("-size", type=int, default=1024)
    p.add_argument("-c", dest="concurrency", type=int, default=16)
    p.add_argument("-collection", default="benchmark")
    p.add_argument("-replication", default="",
                   help="replica placement for the benchmark volumes "
                        "(e.g. 001); empty = master default")
    p.add_argument("-target", default="fid",
                   choices=["fid", "s3", "filer"],
                   help="fid = raw volume path (default); s3 = the "
                        "gateway path (SigV4 auth -> filer autochunk "
                        "-> assign -> volume); filer = the filer HTTP "
                        "path without S3 auth")
    p.add_argument("-s3.url", dest="s3_url",
                   default="http://127.0.0.1:8333")
    p.add_argument("-s3.access", dest="s3_access", default="")
    p.add_argument("-s3.secret", dest="s3_secret", default="")
    p.add_argument("-filer.url", dest="filer_url",
                   default="http://127.0.0.1:8888")
    p.add_argument("-bucket", default="benchbucket")

    p = sub.add_parser("scaffold", help="print a starter config "
                                        "template")
    p.add_argument("-config", default="filer",
                   help="filer | master | security | replication | "
                        "notification | s3 | shell")
    p.add_argument("-output", default="",
                   help="write to a file instead of stdout")

    p = sub.add_parser(
        "autocomplete",
        help="print shell tab-completion setup (the reference's "
             "autocomplete command); eval it or add to your rc file")
    p.add_argument("-shell", default="bash", choices=["bash", "zsh"])

    sub.add_parser("unautocomplete",
                   help="print how to remove shell completion")

    sub.add_parser("update",
                   help="self-update placeholder (no binary releases "
                        "in this distribution)")

    sub.add_parser("version")


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from .utils import glog

    glog.set_verbosity(args.verbosity)
    glog.set_vmodule(args.vmodule)
    if args.metrics_address:
        from .utils import metrics

        metrics.start_push(args.metrics_address, job=args.cmd,
                           interval_seconds=args.metrics_interval)
    apply_env_flags(args)
    apply_global_flags(args)
    if args.memprofile:
        import tracemalloc

        # one frame: the report groups allocations by line, which reads
        # the newest frame only; the reference's 16 frames made a
        # filer ten times slower for the same report
        tracemalloc.start(1)
    try:
        if args.cpuprofile:
            import cProfile

            prof = cProfile.Profile()
            prof.enable()
            try:
                return _dispatch(args, parser)
            finally:
                prof.disable()
                prof.dump_stats(args.cpuprofile)
                print(f"cpu profile written to {args.cpuprofile}")
        return _dispatch(args, parser)
    finally:
        if args.memprofile:
            snap = tracemalloc.take_snapshot()
            with open(args.memprofile, "w") as f:
                for stat in snap.statistics("lineno")[:200]:
                    f.write(f"{stat}\n")
            print(f"memory profile written to {args.memprofile}")


def _dispatch(args, parser) -> int:
    if args.cmd in TOOL_COMMANDS:
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return run_tool(args, list(sub.choices))
    if args.cmd == "master":
        return _run_master(args)
    if args.cmd == "master.follower":
        return _run_master_follower(args)
    if args.cmd == "volume":
        return _run_volume(args)
    if args.cmd == "server":
        return _run_server(args)
    if args.cmd == "filer":
        return _run_filer(args)
    if args.cmd == "s3":
        return _run_s3(args)
    if args.cmd in FILER_WORKER_COMMANDS:
        return _run_filer_worker(args)
    if args.cmd in GATEWAY_COMMANDS:
        return _run_gateway(args)
    if args.cmd in ("mount", "fuse"):
        return _run_mount(args)
    from .shell.repl import run_shell

    return run_shell(args.master, filer_url=_http(args.filer)
                     if args.filer else "")


GATEWAY_COMMANDS = ("ftp", "mq.broker", "webdav", "iam")
FILER_WORKER_COMMANDS = ("filer.replicate", "filer.sync",
                         "filer.backup", "filer.meta.backup",
                         "filer.remote.sync", "filer.remote.gateway",
                         "filer.meta.tail")


def parse_sink(spec: str):
    """-sink kind:args -> the sink, as the reference's
    `_run_replicate` reads it; None for an unknown kind."""
    from .replication import make_sink

    kind, _, rest = spec.partition(":")
    parts = rest.split(",")

    def opt(i: int, default: str = "") -> str:
        return parts[i] if len(parts) > i else default

    if kind == "local":
        return make_sink("local", directory=parts[0])
    if kind == "filer":
        return make_sink("filer", filer_url=parts[0], dest_path=opt(1, "/"))
    if kind == "s3":
        return make_sink("s3", endpoint=parts[0], bucket=parts[1],
                         prefix=opt(2))
    if kind == "gcs":
        return make_sink("gcs", bucket=parts[0], prefix=opt(1),
                         endpoint=opt(2))
    if kind == "azure":
        return make_sink("azure", account=parts[0], key=parts[1],
                         container=parts[2], prefix=opt(3))
    if kind == "b2":
        return make_sink("b2", key_id=parts[0], application_key=parts[1],
                         bucket=parts[2], prefix=opt(3))
    return None


def backup_offset_key(path: str, directory: str) -> str:
    """filer.backup's per-target resume offset: two backups (different
    -dir or -path) must not share/clobber one offset key."""
    import hashlib

    target_id = hashlib.sha256(
        f"{path}\x00{os.path.abspath(directory)}".encode()).hexdigest()[:16]
    return f"replication/backup/{target_id}/offset"


def _run_filer_worker(args) -> int:
    """Start one metadata-stream consumer against -filer (or -a / -b)
    and run it until interrupted, printing the reference's lines."""
    import json
    import time

    from .replication import Replicator

    line = ""
    if args.cmd == "filer.replicate":
        sink = parse_sink(args.sink)
        if sink is None:
            print(f"unknown sink kind {args.sink.partition(':')[0]!r}")
            return 1
        worker = Replicator(args.filer, sink, path_prefix=args.path)
        line = f"replicating {args.filer}{args.path} -> {args.sink}"
    elif args.cmd == "filer.sync":
        from .replication.filer_sync import FilerSync

        worker = FilerSync(args.a, args.b, path_prefix=args.path,
                           both_ways=not args.one_way)
        line = f"syncing {args.a} <-> {args.b} under {args.path}"
    elif args.cmd == "filer.backup":
        from .replication.sink import LocalSink

        worker = Replicator(args.filer, LocalSink(args.dir),
                            path_prefix=args.path,
                            offset_key=backup_offset_key(args.path,
                                                         args.dir))
        line = f"backing up {args.filer}{args.path} -> {args.dir}"
    elif args.cmd == "filer.meta.backup":
        from .replication.meta_backup import FilerMetaBackup

        worker = FilerMetaBackup(args.filer, args.output,
                                 path_prefix=args.path)
        line = (f"backing up {args.filer}{args.path} metadata "
                f"to {args.output}")
    elif args.cmd == "filer.remote.gateway":
        from .remote_storage.gateway import RemoteGateway

        worker = RemoteGateway(args.filer,
                               create_bucket_at=args.create_bucket_at,
                               bucket_suffix=args.bucket_suffix,
                               include=args.include, exclude=args.exclude)
        line = (f"mirroring {args.filer}/buckets to remote storage "
                f"{worker.create_bucket_at or '(none configured)'}")
    elif args.cmd == "filer.remote.sync":
        from .remote_storage.sync import RemoteSyncWorker

        worker = RemoteSyncWorker(args.filer, args.dir)
        line = (f"pushing {args.filer}{args.dir} writes to "
                f"storage {worker.mount.storage!r}")
    else:
        from .rpc.meta_subscriber import MetaSubscriber

        def emit(ev: dict) -> None:
            entry = ev.get("new_entry") or ev.get("old_entry") or {}
            path = entry.get("full_path") or ev.get("directory", "")
            if args.pattern and args.pattern not in path:
                return
            print(json.dumps(ev, separators=(",", ":")), flush=True)

        worker = MetaSubscriber(args.filer, args.path, emit)
    worker.start()
    if line:
        print(line, flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        worker.stop()
    return 0


def apply_env_flags(args) -> None:
    """Flags that travel by env. The default code family: shell
    `ec.encode` (in another process) and the probe fingerprint both
    consult it. The mesh shape: MeshCodec reads it at construction, and
    the probe fingerprint carries it."""
    if getattr(args, "ec_code", ""):
        from .ec import geometry as _geo

        _geo.parse_code(args.ec_code)  # fail fast on a bad spec
        os.environ["SEAWEEDFS_TPU_EC_CODE"] = args.ec_code
    if getattr(args, "ec_mesh_devices", 0):
        os.environ["SEAWEEDFS_TPU_EC_MESH_DEVICES"] = str(
            args.ec_mesh_devices)
    if getattr(args, "ec_mesh_col", 0):
        os.environ["SEAWEEDFS_TPU_EC_MESH_COL"] = str(args.ec_mesh_col)


def apply_global_flags(args) -> None:
    """The process-wide tracing, fault-injection, retry, breaker, hedge,
    qos and telemetry settings (the reference's cli.py:826-867)."""
    from .utils import faults, retry, sketch, tracing

    tracing.configure(slow_threshold=args.trace_slow_threshold,
                      buffer_size=args.trace_buffer_size,
                      sample_rate=args.trace_sample)
    faults.configure(spec=args.fault_spec or None,
                     seed=args.fault_seed or None)
    retry.configure(max_attempts=args.retry_max_attempts,
                    base_delay=args.retry_base_delay,
                    max_delay=args.retry_max_delay,
                    edge_budget=args.retry_edge_budget,
                    breaker_failures=args.breaker_failures,
                    breaker_reset=args.breaker_reset,
                    hedge_delay=args.hedge_delay)
    from .utils import qos

    qos.configure(enabled=args.qos_enabled or None,
                  rate=args.qos_rate,
                  burst=args.qos_burst,
                  max_tenants=args.qos_max_tenants,
                  max_delay=args.qos_max_delay,
                  request_floor=args.qos_request_floor,
                  spec=args.qos_spec or None)
    sketch.configure(enabled=args.telemetry_enabled,
                     alpha=args.telemetry_alpha,
                     window=args.telemetry_window)


def _add_dataplane_flag(p) -> None:
    p.add_argument("-dataplane", default="auto",
                   choices=["auto", "native", "python"],
                   help="object hot-path server: native = C++ epoll "
                        "front (GET/HEAD/POST/DELETE by fid), python = "
                        "the Python app only, auto = native when the "
                        "library builds")


def _add_store_layout_flags(p, kind_flag: str) -> None:
    """-filer.store.shards and -filer.cache.*, over the store that
    `kind_flag` names."""
    p.add_argument("-filer.store.shards", dest="filer_store_shards",
                   type=int, default=0,
                   help="partition the filer namespace across N "
                        f"independent {kind_flag} engines (bucket/"
                        "first-segment routing, consistent-hash ring; "
                        "compaction stays per-shard); 0 = single store")
    p.add_argument("-filer.cache.entries", dest="filer_cache_entries",
                   type=int, default=0,
                   help="read-through metadata cache: max cached "
                        "entries (positive + negative), exactly "
                        "invalidated via the meta event log; "
                        "0 = cache off")
    p.add_argument("-filer.cache.pages", dest="filer_cache_pages",
                   type=int, default=0,
                   help="read-through metadata cache: max cached "
                        "directory-listing pages; 0 = default when "
                        "-filer.cache.entries is set, else off")


def _add_filer_native_flags(p, default: str, note: str) -> None:
    p.add_argument("-filer.native", dest="filer_native", default=default,
                   choices=["auto", "native", "python"],
                   help="native C++ filer front for plain-file "
                        f"GET/PUT/HEAD/DELETE; {note}")
    p.add_argument("-filer.native.workers", dest="filer_native_workers",
                   type=int, default=2,
                   help="relay worker threads of the native filer front "
                        "(requests it cannot serve natively are relayed "
                        "to the Python filer app)")


def _start_span_pusher(master_url, service: str, instance: str):
    """Ship this process's finished spans to the master's collector
    (rpc/trace_push.py). `master_url` may be a callable, for a gateway
    that resolves the master through its filer. Never fatal: a process
    that cannot push still serves (drops are counted)."""
    from .rpc.trace_push import SpanPusher

    sp = SpanPusher(master_url, service, instance)
    sp.start()
    return sp


def _run_master(args) -> int:
    from .rpc.http import ServerThread, run_apps_forever
    from .server.master_server import MasterServer

    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    raft_dir = args.raft_dir
    if peers and not raft_dir:
        # raft safety needs a durable term, vote and log: a master that
        # restarts without them could vote twice in one term
        raft_dir = os.path.join(os.path.expanduser("~"),
                                ".seaweedfs_tpu", "raft")
        print(f"-raftDir not set; persisting raft state to {raft_dir}")
    if raft_dir:
        os.makedirs(raft_dir, exist_ok=True)
    ms = MasterServer(volume_size_limit=args.volumeSizeLimitMB << 20,
                      default_replication=args.defaultReplication,
                      pulse_seconds=args.pulse_seconds,
                      sequencer=args.sequencer,
                      me=f"{args.ip}:{args.port}", peers=peers,
                      raft_state_dir=raft_dir or None,
                      trace_store_size=args.trace_store_size,
                      scrape_interval=args.scrape_interval,
                      otlp_url=args.trace_otlp_url,
                      advisor_seal_quantile=args.advisor_seal_quantile,
                      advisor_demand_quantile=(
                          args.advisor_demand_quantile),
                      advisor_headroom=args.advisor_headroom,
                      jwt_secret=args.jwt_secret,
                      **_master_kwargs(args), **_tier_kwargs(args))
    t = ServerThread(ms.app, host=args.ip, port=args.port,
                     ssl_context=_ssl_ctx(args)).start()
    ms.admin_scripts_url = t.url
    print(f"master listening on {t.url}", flush=True)
    run_apps_forever([t])
    return 0


def _run_master_follower(args) -> int:
    from .rpc.http import ServerThread, run_apps_forever
    from .server.master_follower import MasterFollower

    mf = MasterFollower(args.masters)
    t = ServerThread(mf.app, host=args.ip, port=args.port,
                     ssl_context=_ssl_ctx(args)).start()
    print(f"master follower listening on {t.url}, following "
          f"{mf.client.masters}", flush=True)
    run_apps_forever([t])
    return 0


def _start_volume(args, dirs: list[str], port: int, master: str,
                  max_volumes: int | None = None, **labels):
    from .rpc.http import ServerThread
    from .server.volume_server import VolumeServer
    from .storage.store import Store

    store = Store(dirs, ip=args.ip, port=port, ec_backend=args.ec_backend,
                  needle_map_kind=args.index)
    if max_volumes is not None:
        for loc in store.locations:
            loc.max_volumes = max_volumes
    vs = VolumeServer(store, master, **labels)
    public = _start_volume_front(vs, args, port)
    if public is not None:
        t = vs._backend_thread
        store.port = public
        store.public_url = f"{args.ip}:{public}"
        print(f"volume server listening on http://{store.public_url} "
              f"(native data plane; Python backend :{t.port}), "
              f"dirs={dirs}, ec.backend={args.ec_backend}", flush=True)
        return t, vs
    t = ServerThread(vs.app, host=args.ip, port=port).start()
    store.port = t.port
    store.public_url = t.address
    print(f"volume server listening on {t.url}, dirs={dirs}, "
          f"ec.backend={args.ec_backend}", flush=True)
    return t, vs


def _start_volume_front(vs, args, port: int) -> int | None:
    """Put the C++ data plane in front of volume server `vs` as
    `-dataplane` asks: -> the public port, or None to serve Python
    only."""
    if args.dataplane == "python":
        return None
    from .native import dataplane as dpmod
    from .rpc.http import ServerThread

    # build and load the library BEFORE the backend thread starts: once
    # the backend runs, stopping it would close the store — so every
    # graceful fallback happens here
    try:
        dpmod._load()
    except (OSError, RuntimeError) as e:  # no g++, a failed build
        if args.dataplane == "native":
            raise
        print(f"native data plane unavailable ({e}); serving Python",
              file=sys.stderr, flush=True)
        return None
    # past this point failures are fatal, exactly like the Python
    # server failing to bind its port
    backend = ServerThread(vs.app, host="127.0.0.1", port=0).start()
    vs._backend_thread = backend
    return vs.enable_native(port, backend.port, listen_ip=args.ip)


def _run_volume(args) -> int:
    from .rpc.http import run_apps_forever

    t, vs = _start_volume(args, args.dir.split(","), args.port,
                          args.mserver, max_volumes=args.max,
                          data_center=args.dataCenter, rack=args.rack,
                          disk_type=args.disk, jwt_secret=args.jwt_secret,
                          concurrent_upload_limit=args.upload_limit_mb << 20,
                          concurrent_download_limit=args.download_limit_mb
                          << 20,
                          **_commit_kwargs(args))
    _start_span_pusher(_http(args.mserver.split(",")[0].strip()),
                       "volume", vs.store.public_url)
    run_apps_forever([t])
    return 0


def _run_server(args) -> int:
    from .rpc.http import ServerThread, run_apps_forever
    from .server.master_server import MasterServer

    ms = MasterServer(volume_size_limit=args.volumeSizeLimitMB << 20,
                      **_master_kwargs(args))
    mt = ServerThread(ms.app, host=args.ip, port=args.master_port).start()
    ms.admin_scripts_url = mt.url
    print(f"master listening on {mt.url}", flush=True)
    vol_dir = os.path.join(args.dir, "volume")
    os.makedirs(vol_dir, exist_ok=True)
    try:
        vt, vs = _start_volume(args, [vol_dir], args.volume_port,
                               mt.url, **_commit_kwargs(args))
    except BaseException:
        mt.stop()
        raise
    threads = [vt, mt]
    native_volume = vs.dp is not None
    for flag, want in (("-filer.native", args.filer_native),
                       ("-s3.native", args.s3_native)):
        if want == "native" and not native_volume:
            raise SystemExit(f"{flag}=native needs the native volume "
                             "data plane in-process (-dataplane native)")
    if args.filer or args.s3:
        filer_dir = os.path.join(args.dir, "filer")
        os.makedirs(filer_dir, exist_ok=True)
        store_path = os.path.join(filer_dir, "filer.db")
        store_kw = dict(store_shards=args.filer_store_shards,
                        cache_entries=args.filer_cache_entries,
                        cache_pages=args.filer_cache_pages)
        if args.filer_native != "python" and native_volume:
            from .filer.native_front import NativeFilerFront

            # the Python filer app becomes the relay backend on a
            # loopback port; the native front owns the public filer
            # port (the S3 gateway below talks to the Python app
            # directly: its filer calls carry queries, which the front
            # would only relay)
            ft, fs = _start_filer(args, mt.url, 0, store=args.filer_store,
                                  store_path=store_path, host="127.0.0.1",
                                  **store_kw)
            fs._native_front = NativeFilerFront(
                fs, mt.url, args.filer_port, ft.port, listen_ip=args.ip,
                workers=args.filer_native_workers)
            print(f"filer listening on "
                  f"http://{args.ip}:{fs._native_front.port} (native "
                  f"front; Python backend :{ft.port})", flush=True)
        else:
            ft, fs = _start_filer(args, mt.url, args.filer_port,
                                  store=args.filer_store,
                                  store_path=store_path, **store_kw)
        threads.insert(0, ft)
        if args.s3:
            if args.s3_native != "python" and native_volume:
                from .s3.native_front import NativeS3Front

                st, s3 = _start_s3(args, ft.url, 0, args.s3_config,
                                   host="127.0.0.1")
                s3._native_front = NativeS3Front(
                    s3, fs.filer, mt.url, args.s3_port, st.port,
                    listen_ip=args.ip)
                print(f"s3 gateway listening on "
                      f"http://{args.ip}:{s3._native_front.port} (native "
                      f"front; Python backend :{st.port})", flush=True)
            else:
                st, _ = _start_s3(args, ft.url, args.s3_port,
                                  args.s3_config)
            threads.insert(0, st)
    run_apps_forever(threads)
    return 0


def _http(url: str) -> str:
    return url if url.startswith("http") else f"http://{url}"


def _start_filer(args, master: str, port: int, store: str,
                 store_path: str, ssl_context=None, host: str | None = None,
                 **kwargs):
    from .rpc.http import ServerThread
    from .server.filer_server import FilerServer

    fs = FilerServer(_http(master), store=store, store_path=store_path,
                     **kwargs)
    t = ServerThread(fs.app, host=host or args.ip, port=port,
                     ssl_context=ssl_context).start()
    fs.address = t.address
    print(f"filer listening on {t.url} (store={store})", flush=True)
    return t, fs


def _start_s3(args, filer: str, port: int, config_path: str,
              ssl_context=None, host: str | None = None):
    import json

    from .rpc.http import ServerThread
    from .s3.server import S3ApiServer

    config = None
    if config_path:
        with open(config_path) as f:
            config = json.load(f)
    s3 = S3ApiServer(_http(filer), iam_config=config)
    t = ServerThread(s3.app, host=host or args.ip, port=port,
                     ssl_context=ssl_context).start()
    print(f"s3 gateway listening on {t.url}", flush=True)
    return t, s3


def _run_filer(args) -> int:
    from .rpc.http import run_apps_forever

    if args.filer_native == "native":
        raise SystemExit(
            "-filer.native=native needs an in-process volume store: use "
            "the combined `server` command with -dataplane native")

    store_options = {k: v for k, v in (
        ("host", args.store_host), ("port", args.store_port),
        ("user", args.store_user), ("password", args.store_password),
        ("database", args.store_database)) if v}
    t, _ = _start_filer(args, args.master, args.port, store=args.store,
                        store_path=args.store_path,
                        collection=args.collection,
                        replication=args.replication,
                        chunk_size=args.max_mb << 20,
                        store_options=store_options,
                        cipher=args.encrypt_volume_data,
                        save_to_filer_limit=args.save_to_filer_limit,
                        store_shards=args.filer_store_shards,
                        cache_entries=args.filer_cache_entries,
                        cache_pages=args.filer_cache_pages,
                        ssl_context=_ssl_ctx(args))
    _start_span_pusher(_http(args.master.split(",")[0].strip()), "filer",
                       t.address)
    run_apps_forever([t])
    return 0


def _run_s3(args) -> int:
    from .rpc.http import run_apps_forever

    from .rpc.trace_push import master_from_filer

    t, _ = _start_s3(args, args.filer, args.port, args.config,
                  ssl_context=_ssl_ctx(args))
    # the gateway only knows its filer; resolving per flush keeps the
    # pusher on the master across failovers
    filer = _http(args.filer)
    _start_span_pusher(lambda: master_from_filer(filer), "s3", t.address)
    run_apps_forever([t])
    return 0


def _run_gateway(args) -> int:
    """ftp, mq.broker, webdav and iam (the reference's cli.py
    :1116-1170): serve until interrupted."""
    from .rpc.http import ServerThread, run_apps_forever

    if args.cmd == "ftp":
        import time

        from .ftpd import FtpServer

        users = {}
        if args.user:
            u, _, pw = args.user.partition(":")
            users[u] = pw
        f = FtpServer(args.filer, port=args.port, host=args.ip,
                      root=args.filer_path, users=users,
                      anonymous=not users).start()
        print(f"ftp gateway listening on {args.ip}:{f.port}", flush=True)
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            f.stop()
        return 0
    if args.cmd == "mq.broker":
        from .mq.broker import BrokerServer

        b = BrokerServer(args.filer, args.master)
        t = ServerThread(b.app, host=args.ip, port=args.port).start()
        b.address = t.address
        print(f"mq broker listening on {t.url}", flush=True)
        run_apps_forever([t])
        return 0
    if args.cmd == "webdav":
        from .rpc.trace_push import master_from_filer
        from .webdav.server import WebDavServer

        w = WebDavServer(args.filer, root=args.filer_path)
        t = ServerThread(w.app, host=args.ip, port=args.port,
                         ssl_context=_ssl_ctx(args)).start()
        print(f"webdav listening on {t.url}", flush=True)
        filer = _http(args.filer)
        _start_span_pusher(lambda: master_from_filer(filer), "webdav",
                           t.address)
        run_apps_forever([t])
        return 0
    from .iam.server import IamApiServer

    i = IamApiServer(args.filer)
    t = ServerThread(i.app, host=args.ip, port=args.port,
                     ssl_context=_ssl_ctx(args)).start()
    print(f"iam api listening on {t.url}", flush=True)
    run_apps_forever([t])
    return 0


def fuse_options(spec: str) -> tuple[dict, str]:
    """`fuse`'s -o: the options the mount takes itself (their defaults
    filled in) and the rest, passed on to fuse (the reference's
    cli.py:1183-1193)."""
    known = {"filer": "http://127.0.0.1:8888", "filer.path": "/",
             "collection": "", "replication": "", "cacheDir": "",
             "disableXAttr": ""}
    passthrough = []
    for opt in (spec or "").split(","):
        if not opt:
            continue
        k, sep, v = opt.partition("=")
        if k in known:
            known[k] = v if sep else "true"
        else:
            passthrough.append(opt)
    return known, ",".join(passthrough)


def _run_mount(args) -> int:
    """mount and fuse (the reference's cli.py:1171-1200): serve until
    the mountpoint is unmounted."""
    from .mount.fuse_adapter import mount

    if args.cmd == "mount":
        mount(args.filer, args.dir, root=args.filer_path,
              options=args.mount_options or None,
              cache_dir=args.cache_dir or None,
              collection=args.collection, replication=args.replication,
              write_memory_limit=(args.write_memory_limit_mb
                                  or 64) << 20,
              disable_xattr=args.disable_xattr)
        return 0
    known, passthrough = fuse_options(args.fuse_options)
    mount(known["filer"], args.mountpoint, root=known["filer.path"],
          options=passthrough or None,
          cache_dir=known["cacheDir"] or None,
          collection=known["collection"],
          replication=known["replication"],
          disable_xattr=known["disableXAttr"] == "true")
    return 0


# ----------------------------------------------------------------------
# the client and offline tools (the reference's cli.py:897-979,
# :1208-1257, _run_benchmark*, _run_filer_copy)
# ----------------------------------------------------------------------
TOOL_COMMANDS = ("version", "autocomplete", "unautocomplete", "update",
                 "scaffold", "see.dat", "see.idx", "fix", "compact",
                 "export", "filer.cat", "filer.copy", "backup", "upload",
                 "download", "benchmark")
PROG = "seaweedfs-tpu-torch"


def run_tool(args, subcommands: list[str]) -> int:
    import json

    if args.cmd == "version":
        from . import __version__

        print(f"{PROG} {__version__}")
        return 0
    if args.cmd == "autocomplete":
        cmds = " ".join(sorted(subcommands))
        if args.shell == "bash":
            print(f"complete -W '{cmds}' {PROG}\n"
                  f"complete -W '{cmds}' weed\n"
                  "# add the lines above to ~/.bashrc, or: "
                  f"eval \"$({PROG} autocomplete)\"")
        else:
            print(f"compdef '_arguments \"1:command:({cmds})\"' "
                  f"{PROG}\n# add to ~/.zshrc after compinit")
        return 0
    if args.cmd == "unautocomplete":
        print(f"remove the 'complete -W ... {PROG}' lines from "
              "your shell rc file (this build never edits it for you)")
        return 0
    if args.cmd == "update":
        print(f"{PROG} is distributed as a Python package, not a "
              "downloadable binary; update it with your package "
              "manager / git checkout")
        return 1
    if args.cmd == "scaffold":
        from .scaffold import scaffold

        text = scaffold(args.config)
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
            print(f"wrote {args.output}")
        else:
            print(text, end="")
        return 0
    if args.cmd in ("see.dat", "see.idx"):
        from .operation import tools

        it = (tools.see_dat if args.cmd == "see.dat" else
              tools.see_idx)(args.dir, args.volume_id, args.collection)
        for rec in it:
            print(json.dumps(rec))
        return 0
    if args.cmd in ("fix", "compact", "export"):
        from .operation import tools

        if args.cmd == "fix":
            out = tools.fix_volume(args.dir, args.volume_id,
                                   args.collection)
        elif args.cmd == "compact":
            out = tools.compact_volume(args.dir, args.volume_id,
                                       args.collection)
        else:
            out = tools.export_volume(
                args.dir, args.volume_id,
                args.output or f"vol{args.volume_id}.tar",
                args.collection, args.newer_than_ns)
        print(json.dumps(out))
        return 0
    if args.cmd == "filer.cat":
        from .rpc.httpclient import session

        with session().get(f"{args.filer.rstrip('/')}/"
                           f"{args.path.lstrip('/')}", stream=True,
                           timeout=600) as r:
            if r.status_code >= 300:
                print(r.text, file=sys.stderr)
                return 1
            for chunk in r.iter_content(1 << 20):
                sys.stdout.buffer.write(chunk)
        sys.stdout.flush()
        return 0
    if args.cmd == "filer.copy":
        return _run_filer_copy(args)
    if args.cmd == "backup":
        from .operation.backup import backup_volume

        print(json.dumps(backup_volume(args.master, args.volume_id,
                                       args.dir,
                                       collection=args.collection)))
        return 0
    if args.cmd == "upload":
        return _run_upload(args)
    if args.cmd == "download":
        from .operation import verbs
        from .wdclient.client import MasterClient

        data = verbs.download(MasterClient(args.master)
                              .lookup_file_id(args.fid))
        out = args.output or args.fid.replace(",", "_")
        with open(out, "wb") as f:
            f.write(data)
        print(f"{args.fid} -> {out} ({len(data)} bytes)")
        return 0
    if args.target in ("s3", "filer"):
        return _run_benchmark_gateway(args)
    if args.client == "native":
        return _run_benchmark_native(args)
    return _run_benchmark(args)


def _run_upload(args) -> int:
    """Each file as one needle, or past -maxMB as chunk needles of that
    size and a ?cm=true manifest needle (submit.go:134)."""
    import json
    import mimetypes

    from .operation import verbs
    from .operation.chunked_file import upload_chunked

    for path in args.files:
        size = os.path.getsize(path)
        limit = args.max_mb << 20
        if limit and size > limit:
            name = os.path.basename(path)

            def pieces(p=path, lim=limit):
                with open(p, "rb") as f:
                    while True:
                        piece = f.read(lim)
                        if not piece:
                            return
                        yield piece

            fid, stored = upload_chunked(
                args.master, pieces(), size, name,
                mimetypes.guess_type(name)[0] or "", limit,
                collection=args.collection, replication=args.replication)
            print(json.dumps({"file": path, "fid": fid, "size": stored,
                              "chunked": True}))
            continue
        with open(path, "rb") as f:
            data = f.read()
        fid = verbs.upload_data(
            args.master, data, name=os.path.basename(path),
            collection=args.collection, replication=args.replication)
        print(json.dumps({"file": path, "fid": fid, "size": len(data)}))
    return 0


def _pct_ms(lat, p) -> float:
    import numpy as np

    return float(np.percentile(lat, p)) * 1000 if len(lat) else 0


def _bench_report(client: str, wcount: int, wwall: float, wlat,
                  rcount: int, rwall: float, rlat, size: int,
                  errors: int, **extra) -> int:
    import json

    out = {**extra, "client": client,
           "write_rps": round(wcount / wwall, 1),
           "write_mbps": round(wcount * size / wwall / 1e6, 2),
           "write_p50_ms": round(_pct_ms(wlat, 50), 2),
           "write_p99_ms": round(_pct_ms(wlat, 99), 2),
           "read_rps": round(rcount / rwall, 1),
           "read_mbps": round(rcount * size / rwall / 1e6, 2),
           "read_p50_ms": round(_pct_ms(rlat, 50), 2),
           "read_p99_ms": round(_pct_ms(rlat, 99), 2),
           "errors": errors}
    print(json.dumps(out, indent=2))
    return 0


def _run_benchmark(args) -> int:
    """The benchmark command (command/benchmark.go:111) on Python
    threads over rpc/httpclient: concurrent writes, then reads of what
    was written, with latency percentiles."""
    import threading
    import time

    import numpy as np

    from .operation import verbs
    from .rpc.httpclient import session
    from .wdclient.client import MasterClient

    n, size, conc = args.n, args.size, args.concurrency
    payload = np.random.default_rng(0).bytes(size)
    fids: list[str] = []
    lock = threading.Lock()
    write_lat: list[float] = []
    read_lat: list[float] = []
    err = [0]

    def writer(count):
        sess = session()
        done = 0
        while done < count:
            # one assign hands out a run of fids (fid, fid_1, ...): the
            # master round trip amortizes over the batch
            batch = min(100, count - done)
            try:
                a = verbs.assign(args.master, count=batch,
                                 collection=args.collection,
                                 replication=args.replication)
            except Exception:  # noqa: BLE001 — counted, as the reference
                with lock:
                    err[0] += batch
                done += batch
                continue
            headers = {"Authorization": f"Bearer {a.auth}"} \
                if a.auth else {}
            for i in range(batch):
                fid = a.fid if i == 0 else f"{a.fid}_{i}"
                t0 = time.perf_counter()
                try:
                    r = sess.post(f"http://{a.url}/{fid}", data=payload,
                                  headers=headers, timeout=30)
                    if r.status_code >= 300:
                        raise IOError(f"POST {fid}: {r.status_code}")
                    with lock:
                        fids.append(fid)
                        write_lat.append(time.perf_counter() - t0)
                except Exception:  # noqa: BLE001
                    with lock:
                        err[0] += 1
            done += batch

    def reader(my_fids):
        mc = MasterClient(args.master)
        sess = session()
        for fid in my_fids:
            t0 = time.perf_counter()
            try:
                resp = sess.get(mc.lookup_file_id(fid), timeout=30)
                if len(resp.content) != size:
                    raise IOError(f"GET {fid}: {len(resp.content)} B")
                with lock:
                    read_lat.append(time.perf_counter() - t0)
            except Exception:  # noqa: BLE001
                with lock:
                    err[0] += 1

    def run_phase(fn, work) -> float:
        threads = [threading.Thread(target=fn, args=(w,)) for w in work]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    wdt = run_phase(writer, [n // conc + (1 if i < n % conc else 0)
                             for i in range(conc)])
    rdt = run_phase(reader, [fids[i::conc] for i in range(conc)])
    return _bench_report("python", len(write_lat), wdt, write_lat,
                         len(read_lat), rdt, read_lat, size, err[0])


def _run_benchmark_gateway(args) -> int:
    """The gateway path: PUT + GET through the S3 gateway (SigV4 ->
    filer autochunk -> assign -> volume) or the bare filer. Requests
    are built (and signed) here, then replayed by the native keep-alive
    client, so the server is measured and not this process."""
    import time
    import urllib.parse

    from .native import dataplane as dpmod
    from .rpc.httpclient import session

    if not dpmod.available():
        raise SystemExit("gateway benchmark needs the native client "
                         "(g++ builds native/dataplane.cc)")
    n, size, conc = args.n, args.size, args.concurrency
    payload = bytes(ord("a") + (i * 31 + 7) % 26 for i in range(size))
    is_s3 = args.target == "s3"
    base = (args.s3_url if is_s3 else args.filer_url).rstrip("/")
    parts = urllib.parse.urlsplit(base)
    host, _, port = parts.netloc.partition(":")

    def build(method: str, path: str, body: bytes) -> bytes:
        headers = {"Host": parts.netloc,
                   "Content-Length": str(len(body))}
        if body:
            headers["Content-Type"] = "application/octet-stream"
        if is_s3 and args.s3_access:
            from .s3.sigv4_client import sign_headers

            headers.update(sign_headers(method, f"{base}{path}",
                                        args.s3_access, args.s3_secret,
                                        body))
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in headers.items()) + "\r\n"
        return head.encode() + body

    prefix = f"/{args.bucket}/bench" if is_s3 else "/bench"
    if is_s3:
        # the bucket must exist before objects land in it
        from .s3.sigv4_client import sign_headers

        h = sign_headers("PUT", f"{base}/{args.bucket}", args.s3_access,
                         args.s3_secret) if args.s3_access else {}
        session().put(f"{base}/{args.bucket}", headers=h, timeout=10)
    t0 = time.perf_counter()
    puts = [build("PUT", f"{prefix}/{i:07d}", payload) for i in range(n)]
    gets = [build("GET", f"{prefix}/{i:07d}", b"") for i in range(n)]
    sign_s = time.perf_counter() - t0
    wwall, wlat, werr = dpmod.bench_raw(host, int(port or 80), puts, conc)
    rwall, rlat, rerr = dpmod.bench_raw(host, int(port or 80), gets, conc)
    return _bench_report("native-raw", n - werr, wwall, wlat[wlat > 0],
                         n - rerr, rwall, rlat[rlat > 0], size,
                         werr + rerr, target=args.target,
                         signing=bool(is_s3 and args.s3_access),
                         sign_build_s=round(sign_s, 2))


def _run_benchmark_native(args) -> int:
    """The benchmark on the C++ load generator: Python only assigns
    fids (in batches) and aggregates; every timed request is native."""
    import time

    import numpy as np

    from .native import dataplane as dpmod
    from .operation import verbs
    from .rpc.httpclient import session

    n, size, conc = args.n, args.size, args.concurrency
    if args.replication:
        # replicated volumes fan out natively only once the control
        # plane pushed their peer lists (~2 s refresh): wait for a
        # warmup write on the native path BEFORE minting the measured
        # fids, whose 10 s tokens must not be spent here. repl_post
        # counts for the process's life: gate on its delta
        def repl_post(url):
            st = session().get(f"http://{url}/status", timeout=5).json()
            nd = st.get("native_dataplane")
            return None if nd is None else nd.get("repl_post", 0)

        base: dict[str, int | None] = {}
        deadline = time.time() + 20
        while time.time() < deadline:
            a = verbs.assign(args.master, collection=args.collection,
                             replication=args.replication)
            if a.url not in base:
                base[a.url] = repl_post(a.url)
            verbs.upload(a, b"warmup")
            now_ct = repl_post(a.url)
            if now_ct is None or now_ct > (base[a.url] or 0):
                break  # native fan-out live, or a Python-only server
            time.sleep(0.5)

    by_url: dict[str, tuple[list[str], list[str]]] = {}
    left = n
    while left > 0:
        batch = min(1000, left)
        a = verbs.assign(args.master, count=batch,
                         collection=args.collection,
                         replication=args.replication)
        fids, auths = by_url.setdefault(a.url, ([], []))
        fids.append(a.fid)
        fids.extend(f"{a.fid}_{i}" for i in range(1, batch))
        # batch slots share the base fid's token
        # (volume_server_handlers.go:181 strips the _N suffix)
        auths.extend([a.auth] * batch)
        left -= batch

    def run(mode: str):
        total_wall, lats, errs, count = 0.0, [], 0, 0
        for url, (fids, auths) in by_url.items():
            host, _, port = url.partition(":")
            wall, lat, err = dpmod.bench(
                host, int(port), mode, fids, size, conc,
                auths=auths if any(auths) else None)
            total_wall += wall
            lats.append(lat[lat > 0])
            errs += err
            count += len(fids) - err
        return total_wall, np.concatenate(lats), errs, count

    wwall, wlat, werr, wcount = run("post")
    rwall, rlat, rerr, rcount = run("get")
    return _bench_report("native", wcount, wwall, wlat, rcount, rwall,
                         rlat, size, werr + rerr)


def _run_filer_copy(args) -> int:
    """Upload local files and directories into a filer directory
    (command/filer_copy.go); directories recurse, and the destination
    is always a directory."""
    from .rpc.httpclient import session

    filer = args.filer.rstrip("/")
    dest = "/" + args.dest.strip("/")
    params = {}
    if args.collection:
        params["collection"] = args.collection
    if args.max_mb:
        params["maxMB"] = str(args.max_mb)

    def post(src: str, target: str) -> bool:
        with open(src, "rb") as fh:
            r = session().post(
                f"{filer}/{target.lstrip('/')}", params=params, data=fh,
                headers={"Content-Length": str(os.path.getsize(src))},
                timeout=600)
        if r.status_code >= 300:
            print(f"{target}: {r.text}")
            return False
        return True

    uploaded = 0
    for src in args.sources:
        if os.path.isdir(src):
            base = os.path.basename(os.path.abspath(src))
            for dirpath, _, files in os.walk(src):
                rel = os.path.relpath(dirpath, src)
                for f in sorted(files):
                    target = "/".join(
                        p for p in (dest, base,
                                    "" if rel == "." else rel, f) if p)
                    if not post(os.path.join(dirpath, f), target):
                        return 1
                    uploaded += 1
                    print(f"{os.path.join(dirpath, f)} -> "
                          f"/{target.lstrip('/')}")
        else:
            target = f"{dest}/{os.path.basename(src)}"
            if not post(src, target):
                return 1
            uploaded += 1
            print(f"{src} -> {target}")
    print(f"copied {uploaded} files")
    return 0
