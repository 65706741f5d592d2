"""Admin shell REPL; the counterpart of seaweedfs_tpu/shell/repl.py.

Equivalent of SeaweedFS weed/shell/shell_liner.go: a line-based REPL
over the command registry, with the admin lock (commands.go:78). The
port's registry holds lock / unlock, cluster.check, the collection.*
and volume.* commands (scrub, vacuum, replication, mount, move, ...)
and the ec.* commands. The volume.tier.* commands wait for the remote
tier and raise a ShellError that says so; every other command of the
reference (fs.*, remote.*, s3.*, mq.*, cluster.ps / raft) is not
ported and answers "unknown command".
"""
from __future__ import annotations

import json
import shlex

from . import commands_ec, commands_volume
from .env import CommandEnv, ShellError

HELP = """commands:
  lock / unlock                     acquire/release the admin lock
  cluster.check                     cluster health summary
  collection.list                   list collections
  collection.delete <name>          delete all volumes of a collection
  volume.list                       list volumes and ec shards
  volume.grow [-count=1] [-collection=] [-replication=]
  volume.vacuum [-threshold=0.3]    compact garbage-heavy volumes
  volume.vacuum.disable/.enable     toggle vacuum cluster-wide
  volume.configure.replication -volumeId=N -replication=xyz
  volume.deleteEmpty [-quietFor=86400] [-force]
  volume.server.leave -server=H     stop a server's heartbeats
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
  ec.encode -volumeId=N [-codec=k.m]  erasure-code a volume (wide tier)
  ec.verify -volumeId=N [-sampleMB=4] [-backend=numpy|native|torch|cuda]
                                    parity-check spread shards
  ec.rebuild -volumeId=N            rebuild missing shards
  ec.balance                        even out shard counts
  ec.decode -volumeId=N             decode shards back to a volume
  help / exit
"""


# the reference's remote-tier commands, which need the remote tier
TIER_COMMANDS = frozenset({"volume.tier.move", "volume.tier.upload",
                           "volume.tier.download", "volume.tier.offload",
                           "volume.tier.recall"})


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

    def arg(i: int) -> str:
        if i < len(pos):
            return pos[i]
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
    if cmd in TIER_COMMANDS:
        raise ShellError(f"{cmd} is not yet ported: it waits for the "
                         f"remote tier")
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
