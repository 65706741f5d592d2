"""Admin shell REPL; the counterpart of seaweedfs_tpu/shell/repl.py.

Equivalent of SeaweedFS weed/shell/shell_liner.go: a line-based REPL
over the command registry, with the admin lock (commands.go:78). The
port's registry holds lock / unlock, cluster.check, cluster.ps and the
cluster.raft.* commands, the collection.* and volume.* commands (scrub,
vacuum, replication, mount, move, the volume.tier.* remote tier, ...),
the ec.* commands, the filer's fs.* commands and mount.configure, the
remote.* mounts, the s3.* gateway state and the mq.topic.* commands
(the broker found through the cluster's membership); `fs.meta.notify`
re-publishes events to notifications.
"""
from __future__ import annotations

import json
import shlex

from ..remote_storage.client import parse_remote_spec
from . import (commands_cluster, commands_ec, commands_fs, commands_mq,
               commands_remote, commands_s3, commands_volume)
from .env import CommandEnv, ShellError

HELP = """commands:
  lock / unlock                     acquire/release the admin lock
  cluster.check                     cluster health summary
  cluster.ps                        list masters/filers/volume servers
  cluster.raft.ps                   raft peer status
  cluster.raft.add -peer=H:P        add a master to the raft quorum
  cluster.raft.remove -peer=H:P     remove a master from the quorum
  collection.list                   list collections
  collection.delete <name>          delete all volumes of a collection
  volume.list                       list volumes and ec shards
  volume.grow [-count=1] [-collection=] [-replication=]
  volume.vacuum [-threshold=0.3]    compact garbage-heavy volumes
  volume.vacuum.disable/.enable     toggle vacuum cluster-wide
  volume.configure.replication -volumeId=N -replication=xyz
  volume.deleteEmpty [-quietFor=86400] [-force]
  volume.server.leave -server=H     stop a server's heartbeats
  volume.tier.move -toDiskType=ssd [-fromDiskType=] [-collection=]
  volume.balance                    even out volume counts
  volume.fix.replication            re-replicate under-replicated volumes
  volume.copy -volumeId=N -source=H -target=H
  volume.move -volumeId=N -source=H -target=H
  volume.delete -volumeId=N [-server=H]
  volume.mark -volumeId=N -readonly|-writable
  volume.mount/-unmount -volumeId=N -server=H
  volume.evacuate -server=H         move everything off a server
  volume.check.disk -volumeId=N     compare + repair replica divergence
  volume.fsck                       filer chunks vs volume needles
  volume.scrub [-volumeId=N] [-collection=C] [-limit=N]
                                    full-read CRC verification
  volume.tier.upload -volumeId=N [-dest=s3.default] [-keepLocalDatFile]
  volume.tier.download -volumeId=N  bring a tiered .dat back to disk
  volume.tier.offload -volumeId=N -remote='{"type":...}' [-maxBps=0]
                                    offload EC shard bytes to cold tier
  volume.tier.recall -volumeId=N [-maxBps=0] [-noDecode]
  ec.encode -volumeId=N [-codec=k.m]  erasure-code a volume (wide tier)
  ec.verify -volumeId=N [-sampleMB=4] [-backend=numpy|native|torch|cuda]
                                    parity-check spread shards
  ec.rebuild -volumeId=N            rebuild missing shards
  ec.balance                        even out shard counts
  ec.decode -volumeId=N             decode shards back to a volume
  fs.cd <dir> / fs.pwd              shell working directory
  fs.ls [-l] <dir>                  list a filer directory
  fs.cat <file>                     print file contents
  fs.du <dir>                       recursive usage
  fs.tree <dir>                     recursive listing
  fs.mkdir <dir>                    create a directory
  fs.rm [-r] <path>                 delete
  fs.mv <src> <dst>                 rename/move
  fs.meta.save <dir> <out.jsonl>    snapshot metadata
  fs.meta.load <in.jsonl>           restore metadata
  fs.meta.cat <path>                print one entry's stored metadata
  fs.meta.notify <dir>              re-publish events to notifications
  fs.meta.changeVolumeId <dir> -mapping=old:new[,..] [-apply]
  mount.configure -dir=/d -quotaMB=N   per-mount quota (0 clears)
  fs.verify <dir>                   check chunks are readable
  fs.configure [-locationPrefix=/p -collection=C -ttl=1d -readOnly=true
                -replication=001 -maxFileNameLength=N -delete -apply]
  remote.configure [-name=X -type=s3|local ...] [-delete]
  remote.mount [-dir=/d -remote=storage/prefix]
  remote.mount.buckets -remote=storage [-bucketPattern=glob]
  remote.unmount -dir=/d
  remote.meta.sync -dir=/d          pull remote listing into metadata
  remote.cache -dir=/d              materialise remote files locally
  remote.uncache -dir=/d            drop local copies, keep metadata
  s3.configure [-user=U -access_key=AK -secret_key=SK
                -actions=Read,Write -delete -apply]
  s3.bucket.list / s3.bucket.create -name=B
  s3.bucket.delete -name=B [-includeObjects]
  s3.bucket.quota -name=B [-quotaMB=N]   show/set quota (0 clears)
  s3.bucket.quota.enforce           mark over-quota buckets read-only
  s3.clean.uploads [-timeAgo=86400] abort stale multipart uploads
  s3.circuit.breaker [-global='{"writeCount":32}'
                      -bucket=B -bucketConf='{...}' -delete -apply]
  mq.topic.list                     list message-queue topics
  mq.topic.create [-namespace=ns] -topic=T [-partitions=4]
  mq.topic.describe [-namespace=ns] -topic=T
  mq.topic.delete [-namespace=ns] -topic=T
  help / exit
"""



def run_command(env: CommandEnv, line: str) -> object:
    parts = shlex.split(line)
    if not parts:
        return None
    cmd, args = parts[0], parts[1:]
    opts: dict[str, str] = {}
    pos: list[str] = []
    for a in args:
        if a.startswith("-") and "=" in a:
            k, _, v = a[1:].partition("=")
            opts[k] = v
        elif a.startswith("-"):
            opts[a.lstrip("-")] = "true"
        else:
            pos.append(a)

    def arg(i: int, default: str | None = None) -> str:
        if i < len(pos):
            return pos[i]
        if default is not None:
            return default
        raise ShellError(f"{cmd}: missing argument {i + 1}")

    if cmd == "lock":
        env.acquire_lock()
        return "locked"
    if cmd == "unlock":
        env.release_lock()
        return "unlocked"
    # -- cluster / collection ------------------------------------------
    if cmd == "cluster.check":
        return commands_volume.cluster_check(env)
    if cmd == "cluster.ps":
        return commands_cluster.cluster_ps(env)
    if cmd == "cluster.raft.ps":
        return commands_cluster.cluster_raft_ps(env)
    if cmd in ("cluster.raft.add", "cluster.raft.remove"):
        return commands_cluster.cluster_raft_change(
            env, opts.get("peer", ""), add=cmd.endswith(".add"))
    if cmd == "collection.list":
        return commands_volume.collection_list(env)
    if cmd == "collection.delete":
        name = opts.get("collection") or arg(0)
        return commands_volume.collection_delete(env, name)
    # -- volume ---------------------------------------------------------
    if cmd == "volume.list":
        return commands_volume.volume_list(env)
    if cmd == "volume.grow":
        return commands_volume.volume_grow(
            env, int(opts.get("count", "1")), opts.get("collection", ""),
            opts.get("replication", ""), opts.get("disk", ""))
    if cmd == "volume.vacuum":
        return commands_volume.volume_vacuum(
            env, float(opts.get("threshold", 0.3)))
    if cmd == "volume.vacuum.disable":
        return commands_volume.volume_vacuum_toggle(env, disable=True)
    if cmd == "volume.vacuum.enable":
        return commands_volume.volume_vacuum_toggle(env, disable=False)
    if cmd == "volume.configure.replication":
        return commands_volume.volume_configure_replication(
            env, int(opts["volumeId"]), opts.get("replication", ""))
    if cmd == "volume.deleteEmpty":
        return commands_volume.volume_delete_empty(
            env, quiet_for_seconds=int(opts.get("quietFor", "86400")),
            force="force" in opts)
    if cmd == "volume.server.leave":
        return commands_volume.volume_server_leave(env, opts["server"])
    if cmd == "volume.tier.move":
        return commands_volume.volume_tier_move(
            env, opts["toDiskType"], opts.get("collection", ""),
            opts.get("fromDiskType", ""))
    if cmd == "volume.balance":
        return commands_volume.volume_balance(env)
    if cmd == "volume.fix.replication":
        return commands_volume.volume_fix_replication(env)
    if cmd == "volume.copy":
        return commands_volume.volume_copy(
            env, int(opts["volumeId"]), opts["source"], opts["target"])
    if cmd == "volume.move":
        return commands_volume.volume_move(
            env, int(opts["volumeId"]), opts["source"], opts["target"])
    if cmd == "volume.delete":
        return commands_volume.volume_delete(
            env, int(opts["volumeId"]), opts.get("server", ""))
    if cmd == "volume.mark":
        return commands_volume.volume_mark(
            env, int(opts["volumeId"]), writable="writable" in opts)
    if cmd == "volume.mount":
        return commands_volume.volume_mount(
            env, int(opts["volumeId"]), opts["server"])
    if cmd == "volume.unmount":
        return commands_volume.volume_unmount(
            env, int(opts["volumeId"]), opts["server"])
    if cmd == "volume.evacuate":
        return commands_volume.volume_evacuate(env, opts["server"])
    if cmd == "volume.check.disk":
        return commands_volume.volume_check_disk(
            env, int(opts["volumeId"]))
    if cmd == "volume.fsck":
        return commands_volume.volume_fsck(env)
    if cmd == "volume.scrub":
        return commands_volume.volume_scrub(
            env, int(opts.get("volumeId", 0)),
            opts.get("collection", ""), int(opts.get("limit", 0)))
    if cmd == "volume.tier.upload":
        return commands_volume.volume_tier_upload(
            env, int(opts["volumeId"]), opts.get("dest", "s3.default"),
            keep_local="keepLocalDatFile" in opts)
    if cmd == "volume.tier.download":
        return commands_volume.volume_tier_download(
            env, int(opts["volumeId"]))
    if cmd == "volume.tier.offload":
        return commands_volume.volume_tier_offload(
            env, int(opts["volumeId"]),
            parse_remote_spec(opts["remote"]),
            max_bps=float(opts.get("maxBps", 0) or 0))
    if cmd == "volume.tier.recall":
        return commands_volume.volume_tier_recall(
            env, int(opts["volumeId"]),
            max_bps=float(opts.get("maxBps", 0) or 0),
            decode="noDecode" not in opts)
    # -- erasure coding -------------------------------------------------
    if cmd == "ec.encode":
        return commands_ec.ec_encode(env, int(opts["volumeId"]),
                                     opts.get("collection", ""),
                                     codec=opts.get("codec", ""))
    if cmd == "ec.rebuild":
        return commands_ec.ec_rebuild(env, int(opts["volumeId"]),
                                      opts.get("collection", ""))
    if cmd == "ec.balance":
        return commands_ec.ec_balance(env, opts.get("collection", ""))
    if cmd == "ec.decode":
        return commands_ec.ec_decode(env, int(opts["volumeId"]),
                                     opts.get("collection", ""))
    if cmd == "ec.verify":
        return commands_ec.ec_verify(
            env, int(opts["volumeId"]),
            sample_mb=int(opts.get("sampleMB", 4)),
            backend=opts.get("backend", "numpy"))
    # -- filesystem -----------------------------------------------------
    def rarg(i: int, default: str | None = None) -> str:
        # fs paths resolve against the fs.cd working directory
        return env.resolve(arg(i, default))

    if cmd == "fs.cd":
        return commands_fs.fs_cd(env, arg(0, "/"))
    if cmd == "fs.pwd":
        return commands_fs.fs_pwd(env)
    if cmd == "fs.ls":
        return commands_fs.fs_ls(env, rarg(0, "."), long="l" in opts)
    if cmd == "fs.cat":
        return commands_fs.fs_cat(env, rarg(0)).decode(errors="replace")
    if cmd == "fs.du":
        return commands_fs.fs_du(env, rarg(0, "."))
    if cmd == "fs.tree":
        return "\n".join(commands_fs.fs_tree(env, rarg(0, ".")))
    if cmd == "fs.mkdir":
        return commands_fs.fs_mkdir(env, rarg(0))
    if cmd == "fs.rm":
        commands_fs.fs_rm(env, rarg(0), recursive="r" in opts)
        return "removed"
    if cmd == "fs.mv":
        commands_fs.fs_mv(env, rarg(0), rarg(1))
        return "moved"
    if cmd == "fs.meta.save":
        n = commands_fs.fs_meta_save(env, rarg(0, "."),
                                     arg(1, "meta.jsonl"))
        return f"saved {n} entries"
    if cmd == "fs.meta.load":
        n = commands_fs.fs_meta_load(env, arg(0))
        return f"loaded {n} entries"
    if cmd == "fs.meta.cat":
        return commands_fs.fs_meta_cat(env, rarg(0))
    if cmd == "fs.meta.notify":
        return commands_fs.fs_meta_notify(env, rarg(0, "."))
    if cmd == "fs.meta.changeVolumeId":
        return commands_fs.fs_meta_change_volume_id(
            env, rarg(0, "."), opts.get("mapping", ""),
            apply="apply" in opts or "force" in opts)
    if cmd == "fs.verify":
        return commands_fs.fs_verify(env, rarg(0, "."))
    if cmd == "mount.configure":
        return commands_fs.mount_configure(
            env, opts.get("dir", ""),
            int(opts.get("quotaMB", "-1")))
    if cmd == "fs.configure":
        return commands_fs.fs_configure(
            env, opts.pop("locationPrefix", ""),
            delete=opts.pop("delete", "") == "true",
            apply=opts.pop("apply", "") == "true", **opts)
    # -- remote storage -------------------------------------------------
    if cmd == "remote.configure":
        conf = {k: v for k, v in opts.items()
                if k not in ("name", "delete")}
        return commands_remote.remote_configure(
            env, opts.get("name", ""), delete="delete" in opts, **conf)
    if cmd == "remote.mount":
        return commands_remote.remote_mount(
            env, opts.get("dir", ""), opts.get("remote", ""))
    if cmd == "remote.mount.buckets":
        return commands_remote.remote_mount_buckets(
            env, opts.get("remote", ""),
            opts.get("bucketPattern", ""))
    if cmd == "remote.unmount":
        return commands_remote.remote_unmount(env, opts["dir"])
    if cmd == "remote.meta.sync":
        return commands_remote.remote_meta_sync(env, opts["dir"])
    if cmd == "remote.cache":
        return commands_remote.remote_cache(env, opts["dir"])
    if cmd == "remote.uncache":
        return commands_remote.remote_uncache(env, opts["dir"])
    # -- s3 gateway state -----------------------------------------------
    if cmd == "s3.configure":
        return commands_s3.s3_configure(
            env, user=opts.get("user", ""),
            access_key=opts.get("access_key", ""),
            secret_key=opts.get("secret_key", ""),
            actions=opts.get("actions", ""),
            delete=opts.get("delete", "") == "true",
            apply=opts.get("apply", "") == "true")
    if cmd == "s3.bucket.list":
        return commands_s3.s3_bucket_list(env)
    if cmd == "s3.bucket.create":
        return commands_s3.s3_bucket_create(
            env, opts.get("name") or arg(0, ""))
    if cmd == "s3.bucket.delete":
        return commands_s3.s3_bucket_delete(
            env, opts.get("name") or arg(0, ""),
            include_objects=opts.get("includeObjects", "") == "true")
    if cmd == "s3.bucket.quota":
        return commands_s3.s3_bucket_quota(
            env, opts.get("name") or arg(0, ""),
            quota_mb=int(opts.get("quotaMB", "-1")))
    if cmd == "s3.bucket.quota.enforce":
        return commands_s3.s3_bucket_quota_enforce(env)
    if cmd == "s3.clean.uploads":
        return commands_s3.s3_clean_uploads(
            env, time_ago_seconds=int(opts.get("timeAgo", "86400")))
    if cmd == "s3.circuit.breaker":
        return commands_s3.s3_circuit_breaker(
            env, global_conf=opts.get("global", ""),
            bucket=opts.get("bucket", ""),
            bucket_conf=opts.get("bucketConf", ""),
            delete=opts.get("delete", "") == "true",
            apply=opts.get("apply", "") == "true")
    # -- message queue --------------------------------------------------
    if cmd == "mq.topic.list":
        return commands_mq.mq_topic_list(env)
    if cmd == "mq.topic.create":
        ns = opts.get("namespace", "default")
        name = opts.get("topic", "")
        if not name:  # positional `ns/topic` or bare `topic`
            p = arg(0)
            if "/" in p:
                ns, _, name = p.partition("/")
            else:
                name = p
        return commands_mq.mq_topic_create(
            env, ns, name, int(opts.get("partitions", "4")))
    if cmd == "mq.topic.describe":
        return commands_mq.mq_topic_describe(
            env, opts.get("namespace", "default"), opts["topic"])
    if cmd == "mq.topic.delete":
        return commands_mq.mq_topic_delete(
            env, opts.get("namespace", "default"), opts["topic"])
    if cmd == "help":
        return HELP
    raise ShellError(f"unknown command {cmd!r} (try `help`)")


def run_shell(master_url: str, filer_url: str = "") -> int:
    env = CommandEnv(master_url, filer_url=filer_url)
    print(f"seaweedfs-tpu-torch shell connected to {master_url}")
    print("type `help` for commands, `exit` to quit")
    try:
        while True:
            try:
                line = input("> ").strip()
            except (EOFError, KeyboardInterrupt):
                print()
                return 0
            if line in ("exit", "quit"):
                return 0
            if not line:
                continue
            try:
                out = run_command(env, line)
                if out is not None:
                    print(out if isinstance(out, str)
                          else json.dumps(out, indent=2, default=str))
            except ShellError as e:
                print(f"error: {e}")
            except Exception as e:  # noqa: BLE001 — the REPL goes on
                print(f"error: {type(e).__name__}: {e}")
    finally:
        env.close()
