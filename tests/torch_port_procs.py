"""Run a reference test's spawned processes on the port.

A reference case that starts servers as processes spells the package
in its argv (`python -m seaweedfs_tpu volume ...`) and in the patterns
it finds them by (`pgrep -f "seaweedfs_tpu volume -port N"`). Bound as
the case's `subprocess` (tests/torch_port_cases.port_cases), this
module runs the same argv against `seaweedfs_tpu_torch`, with
`-ec.backend native` on the subcommands that run a codec (the port's
default, the measured router, needs a GPU).
"""
import subprocess as _sp

PIPE = _sp.PIPE
STDOUT = _sp.STDOUT
DEVNULL = _sp.DEVNULL
TimeoutExpired = _sp.TimeoutExpired
CalledProcessError = _sp.CalledProcessError

_CODEC_COMMANDS = ("volume", "server")


def port_argv(argv: list) -> list:
    argv = [a.replace("seaweedfs_tpu volume", "seaweedfs_tpu_torch volume")
            if isinstance(a, str) else a for a in argv]
    if "seaweedfs_tpu" not in argv:
        return argv
    at = argv.index("seaweedfs_tpu")
    argv[at] = "seaweedfs_tpu_torch"
    if any(a in _CODEC_COMMANDS for a in argv[at + 1:]) and \
            "-ec.backend" not in argv:
        argv += ["-ec.backend", "native"]  # after the subcommand's own
    return argv


def Popen(argv, *args, **kwargs):
    return _sp.Popen(port_argv(list(argv)), *args, **kwargs)


def run(argv, *args, **kwargs):
    return _sp.run(port_argv(list(argv)), *args, **kwargs)
