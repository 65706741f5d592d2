"""The port CLI's replication subcommands against the JAX package's:
filer.replicate, filer.sync, filer.backup and filer.meta.backup.

* `-h` of each gives the reference's usage and flags (the program's
  name aside).
* Each started against live filers prints the reference's first line,
  and runs until interrupted (the interrupt stops its worker).
* `-sink` of filer.replicate is parsed into the same sink arguments for
  all six kinds, and an unknown kind prints the reference's line.
* filer.backup keeps its offset under the same key as the reference's.
* No prefix of a global flag takes a subcommand's short flag.
"""
import functools
import os
import time
import types

import pytest

import seaweedfs_tpu.replication as ref_replication
import seaweedfs_tpu_torch.replication as port_replication
from seaweedfs_tpu import cli as ref_cli
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu_torch import cli
from seaweedfs_tpu_torch.server.cluster import Cluster

from tests.torch_port_cases import within

PortCluster = functools.partial(Cluster, ec_backend="native")
COMMANDS = ("filer.replicate", "filer.sync", "filer.backup",
            "filer.meta.backup")
SINKS = ["local:/tmp/mirror", "filer:127.0.0.1:8888",
         "filer:http://h:8888,/dest", "s3:http://h:8333,bkt",
         "s3:h:8333,bkt,pre/fix", "gcs:bkt", "gcs:bkt,pre",
         "gcs:bkt,pre,http://emu:4443", "azure:acct,a2V5,cont",
         "azure:acct,a2V5,cont,pre", "b2:kid,akey,bkt",
         "b2:kid,akey,bkt,pre"]


def _normalized(text: str, prog: str) -> str:
    return " ".join(text.replace(prog, "PROG").split())


@pytest.mark.parametrize("name", COMMANDS)
def test_help_is_the_references(name, capsys):
    out = {}
    for side, main, prog in (("reference", ref_cli.main, "seaweedfs-tpu"),
                             ("port", cli.main, "seaweedfs-tpu-torch")):
        with pytest.raises(SystemExit) as ei:
            main([name, "-h"])
        assert ei.value.code == 0
        out[side] = _normalized(capsys.readouterr().out, prog)
    assert out["port"] == out["reference"]
    assert out["port"].startswith(f"usage: PROG {name} [-h]")


def test_no_global_flag_prefix_takes_a_subcommands_flag():
    """The top-level parser matches no prefix of its flags: on the
    Python 3.12 releases that classify every argument up front,
    `filer.sync -a A -b B` failed with "ambiguous option: -b could
    match -breaker.failures, -breaker.reset"."""
    parser = cli.build_parser()
    for flag in ("-a", "-b", "-o", "-dir", "-path", "-filer", "-sink"):
        assert parser._get_option_tuples(flag) == []
    args = parser.parse_args(["filer.sync", "-a", "A", "-b", "B"])
    assert (args.a, args.b, args.path, args.one_way) == ("A", "B", "/",
                                                         False)
    assert parser.parse_args(["-v2", "version"]).verbosity == 2


class _Built(Exception):
    pass


def _replicate_args(spec: str):
    """The parsed flags the reference's _run_replicate reads."""
    return types.SimpleNamespace(sink=spec, filer="http://127.0.0.1:8888",
                                 path="/")


def test_sink_flag_parsed_as_the_reference(monkeypatch):
    got = {"reference": [], "port": []}

    def recorder(side):
        def make_sink(kind, **kwargs):
            got[side].append((kind, kwargs))
            raise _Built
        return make_sink

    monkeypatch.setattr(ref_replication, "make_sink", recorder("reference"))
    monkeypatch.setattr(port_replication, "make_sink", recorder("port"))
    for spec in SINKS:
        args = _replicate_args(spec)
        with pytest.raises(_Built):
            ref_cli._run_replicate(args)
        with pytest.raises(_Built):
            cli.parse_sink(spec)
    assert got["port"] == got["reference"]
    assert sorted({k for k, _ in got["port"]}) == [
        "azure", "b2", "filer", "gcs", "local", "s3"]


def test_unknown_sink_kind(capsys):
    assert ref_cli._run_replicate(_replicate_args("ftp:host")) == 1
    ref_line = capsys.readouterr().out
    assert cli.main(["filer.replicate", "-sink", "ftp:host"]) == 1
    assert capsys.readouterr().out == ref_line == "unknown sink kind 'ftp'\n"


def test_backup_offset_key_is_the_references(tmp_path):
    import hashlib

    target = hashlib.sha256(
        f"/src\x00{os.path.abspath(str(tmp_path))}".encode()).hexdigest()
    assert cli.backup_offset_key("/src", str(tmp_path)) == \
        f"replication/backup/{target[:16]}/offset"


@pytest.fixture(scope="module")
def filers(tmp_path_factory):
    out = {}
    try:
        for side, cls in (("reference", RefCluster), ("port", PortCluster)):
            out[side] = within(60, cls, str(tmp_path_factory.mktemp(
                f"cli_repl_{side}")), n_volume_servers=1, with_filer=True)
        yield out
    finally:
        for c in out.values():
            within(30, c.stop)


def _argv(name: str, filers, tmp_path) -> list[str]:
    a, b = filers["port"].filer_url, filers["reference"].filer_url
    return {"filer.replicate": [name, "-filer", a, "-path", "/cr",
                                "-sink", f"local:{tmp_path}/mirror"],
            "filer.sync": [name, "-a", a, "-b", b, "-path", "/cr",
                           "-oneWay"],
            "filer.backup": [name, "-filer", a, "-path", "/cr", "-dir",
                             f"{tmp_path}/backup"],
            "filer.meta.backup": [name, "-filer", a, "-path", "/cr", "-o",
                                  f"{tmp_path}/meta.db"]}[name]


@pytest.mark.parametrize("name", COMMANDS)
def test_first_line_is_the_references(name, filers, tmp_path, capsys,
                                      monkeypatch):
    """Each package's command runs until its sleep is interrupted, as
    by ^C, and prints the same first line."""
    real_sleep = time.sleep

    def sleep(s):
        if s == 3600:
            raise KeyboardInterrupt
        real_sleep(s)

    monkeypatch.setattr(time, "sleep", sleep)
    out = {}
    for side, main in (("reference", ref_cli.main), ("port", cli.main)):
        assert within(30, main, _argv(name, filers, tmp_path)) == 0
        out[side] = capsys.readouterr().out.splitlines()[0]
    assert out["port"] == out["reference"]
