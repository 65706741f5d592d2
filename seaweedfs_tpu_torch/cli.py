"""Command-line entry point — the `weed` binary equivalent; the
counterpart of seaweedfs_tpu/cli.py. Run as
`python -m seaweedfs_tpu_torch <cmd>`.

Subcommands: master, volume, filer, s3, server (master + one volume
server in one process, `-filer` and `-s3` adding a filer and the S3
gateway) and shell (`-filer` takes the admin lock through the filer's
DLM). `-ec.backend` picks the codec a volume server
runs its EC encode and rebuild on: auto (the measured router; needs a
GPU), cuda (the hand-written kernel; needs a GPU), mesh (the kernel on
every local card, shaped by `-ec.mesh.devices` / `-ec.mesh.col`),
native (the AVX2 host codec) or numpy. `-ec.code` sets the code family
new EC volumes are encoded with. `-repair.*` configure the master's
redundancy watchdog and `-admin.scripts` its maintenance timer, on
`master` and on `server`. The filer's stores are memory and sqlite
(`-filer.store`, the reference's default sqlite on `server`). Every
other subcommand of the reference is not here.
"""
from __future__ import annotations

import argparse
import os


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


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="seaweedfs-tpu-torch",
        description="SeaweedFS with its erasure coding on a GPU")
    parser.add_argument(
        "-v", dest="verbosity", type=int, default=0,
        help="log verbosity for glog.v() messages; place BEFORE the "
             "subcommand")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("master", help="start a master server")
    p.add_argument("-port", type=int, default=9333)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-volumeSizeLimitMB", type=int, default=30 * 1024)
    p.add_argument("-defaultReplication", default="000")
    _add_master_flags(p)

    p = sub.add_parser("volume", help="start a volume server")
    p.add_argument("-port", type=int, default=8080)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-dir", default="./data", help="comma-separated dirs")
    p.add_argument("-max", type=int, default=8)
    p.add_argument("-mserver", default="127.0.0.1:9333")
    p.add_argument("-dataCenter", default="DefaultDataCenter")
    p.add_argument("-rack", default="DefaultRack")
    p.add_argument("-disk", default="hdd",
                   help="disk class of this server (hdd | ssd)")
    _add_ec_flags(p)

    p = sub.add_parser("filer", help="start a filer server")
    p.add_argument("-port", type=int, default=8888)
    p.add_argument("-ip", default="127.0.0.1")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-store", default="memory",
                   help="metadata store: memory | sqlite")
    p.add_argument("-store.path", dest="store_path", default=":memory:")
    p.add_argument("-collection", default="")
    p.add_argument("-replication", default="")
    p.add_argument("-maxMB", dest="max_mb", type=int, default=8,
                   help="split uploads into chunks of this many MiB")
    p.add_argument("-saveToFilerLimit", dest="save_to_filer_limit",
                   type=int, default=0,
                   help="files smaller than this many bytes are stored "
                        "inside the filer metadata entry (no volume "
                        "round trip); per-request ?saveInside=true "
                        "forces it")

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
    p.add_argument("-filer.store", dest="filer_store", default="sqlite",
                   help="metadata store: memory | sqlite")
    p.add_argument("-s3", action="store_true")
    p.add_argument("-s3.port", dest="s3_port", type=int, default=8333)
    p.add_argument("-s3.config", dest="s3_config", default="",
                   help="json file with s3 identities")
    p.add_argument("-volumeSizeLimitMB", type=int, default=1024)
    _add_ec_flags(p)
    _add_master_flags(p)

    p = sub.add_parser("shell", help="interactive admin shell")
    p.add_argument("-master", default="http://127.0.0.1:9333")
    p.add_argument("-filer", default="",
                   help="filer address for the cluster-wide admin lock")
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from .utils import glog

    glog.set_verbosity(args.verbosity)
    apply_env_flags(args)
    if args.cmd == "master":
        return _run_master(args)
    if args.cmd == "volume":
        return _run_volume(args)
    if args.cmd == "server":
        return _run_server(args)
    if args.cmd == "filer":
        return _run_filer(args)
    if args.cmd == "s3":
        return _run_s3(args)
    from .shell.repl import run_shell

    return run_shell(args.master, filer_url=_http(args.filer)
                     if args.filer else "")


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


def _run_master(args) -> int:
    from .rpc.http import ServerThread, run_apps_forever
    from .server.master_server import MasterServer

    ms = MasterServer(volume_size_limit=args.volumeSizeLimitMB << 20,
                      default_replication=args.defaultReplication,
                      **_master_kwargs(args))
    t = ServerThread(ms.app, host=args.ip, port=args.port).start()
    ms.admin_scripts_url = t.url
    print(f"master listening on {t.url}", flush=True)
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
    t = ServerThread(vs.app, host=args.ip, port=port).start()
    store.port = t.port
    store.public_url = t.address
    print(f"volume server listening on {t.url}, dirs={dirs}, "
          f"ec.backend={args.ec_backend}", flush=True)
    return t


def _run_volume(args) -> int:
    from .rpc.http import run_apps_forever

    t = _start_volume(args, args.dir.split(","), args.port, args.mserver,
                      max_volumes=args.max, data_center=args.dataCenter,
                      rack=args.rack, disk_type=args.disk)
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
        vt = _start_volume(args, [vol_dir], args.volume_port, mt.url)
    except BaseException:
        mt.stop()
        raise
    threads = [vt, mt]
    if args.filer or args.s3:
        filer_dir = os.path.join(args.dir, "filer")
        os.makedirs(filer_dir, exist_ok=True)
        ft = _start_filer(args, mt.url, args.filer_port,
                          store=args.filer_store,
                          store_path=os.path.join(filer_dir, "filer.db"))
        threads.insert(0, ft)
        if args.s3:
            threads.insert(0, _start_s3(args, ft.url, args.s3_port,
                                        args.s3_config))
    run_apps_forever(threads)
    return 0


def _http(url: str) -> str:
    return url if url.startswith("http") else f"http://{url}"


def _start_filer(args, master: str, port: int, store: str,
                 store_path: str, **kwargs):
    from .rpc.http import ServerThread
    from .server.filer_server import FilerServer

    fs = FilerServer(_http(master), store=store, store_path=store_path,
                     **kwargs)
    t = ServerThread(fs.app, host=args.ip, port=port).start()
    fs.address = t.address
    print(f"filer listening on {t.url} (store={store})", flush=True)
    return t


def _start_s3(args, filer: str, port: int, config_path: str):
    import json

    from .rpc.http import ServerThread
    from .s3.server import S3ApiServer

    config = None
    if config_path:
        with open(config_path) as f:
            config = json.load(f)
    s3 = S3ApiServer(_http(filer), iam_config=config)
    t = ServerThread(s3.app, host=args.ip, port=port).start()
    print(f"s3 gateway listening on {t.url}", flush=True)
    return t


def _run_filer(args) -> int:
    from .rpc.http import run_apps_forever

    t = _start_filer(args, args.master, args.port, store=args.store,
                     store_path=args.store_path,
                     collection=args.collection,
                     replication=args.replication,
                     chunk_size=args.max_mb << 20,
                     save_to_filer_limit=args.save_to_filer_limit)
    run_apps_forever([t])
    return 0


def _run_s3(args) -> int:
    from .rpc.http import run_apps_forever

    t = _start_s3(args, args.filer, args.port, args.config)
    run_apps_forever([t])
    return 0
