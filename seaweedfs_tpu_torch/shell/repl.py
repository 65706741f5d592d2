"""Admin shell REPL; the counterpart of seaweedfs_tpu/shell/repl.py.

Equivalent of SeaweedFS weed/shell/shell_liner.go: a line-based REPL
over the command registry, with the admin lock (commands.go:78). The
port's registry holds the erasure-coding commands and what they need:
lock, unlock, volume.list, volume.fix.replication, ec.encode,
ec.rebuild, ec.decode, ec.balance, ec.verify. Every other command of
the reference is not ported and answers "unknown command".
"""
from __future__ import annotations

import json
import shlex

from . import commands_ec, commands_volume
from .env import CommandEnv, ShellError

HELP = """commands:
  lock / unlock                     acquire/release the admin lock
  volume.list                       list volumes and ec shards
  volume.fix.replication            re-replicate under-replicated volumes
  ec.encode -volumeId=N [-codec=k.m]  erasure-code a volume (wide tier)
  ec.verify -volumeId=N [-sampleMB=4] [-backend=numpy|native|torch|cuda]
                                    parity-check spread shards
  ec.rebuild -volumeId=N            rebuild missing shards
  ec.balance                        even out shard counts
  ec.decode -volumeId=N             decode shards back to a volume
  help / exit
"""


def run_command(env: CommandEnv, line: str) -> object:
    parts = shlex.split(line)
    if not parts:
        return None
    cmd, args = parts[0], parts[1:]
    opts: dict[str, str] = {}
    for a in args:
        if a.startswith("-") and "=" in a:
            k, _, v = a[1:].partition("=")
            opts[k] = v
        elif a.startswith("-"):
            opts[a.lstrip("-")] = "true"

    if cmd == "lock":
        env.acquire_lock()
        return "locked"
    if cmd == "unlock":
        env.release_lock()
        return "unlocked"
    if cmd == "volume.list":
        return commands_volume.volume_list(env)
    if cmd == "volume.fix.replication":
        return commands_volume.volume_fix_replication(env)
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


def run_shell(master_url: str) -> int:
    env = CommandEnv(master_url)
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
