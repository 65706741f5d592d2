"""mq.topic.* shell commands; the counterpart of
seaweedfs_tpu/shell/commands_mq.py.

Equivalents of SeaweedFS weed/shell/command_mq_topic_list.go and its
siblings: find a live broker through the cluster's membership
(`/cluster/nodes?type=broker`), then manage topics over its API.
"""
from __future__ import annotations

from ..rpc.httpclient import RequestException, session
from .env import CommandEnv, ShellError


def _broker(env: CommandEnv) -> str:
    body = env.master_get("/cluster/nodes", type="broker")
    nodes = body.get("nodes", [])
    if not nodes:
        raise ShellError("no mq broker registered in the cluster "
                         "(start one with `mq.broker`)")
    return f"http://{nodes[0]['address']}"


def _call(method: str, url: str, what: str, **kw):
    """Broker HTTP with shell-shaped errors: a broker that died inside
    its membership-TTL window must read as a ShellError, not a
    traceback."""
    try:
        r = session().request(method, url, timeout=30, **kw)
    except RequestException as e:
        raise ShellError(f"{what}: broker unreachable: {e}")
    if r.status_code >= 300:
        raise ShellError(f"{what}: {r.text}")
    return r


def mq_topic_list(env: CommandEnv) -> dict:
    return _call("GET", f"{_broker(env)}/topics",
                 "mq.topic.list").json()


def mq_topic_create(env: CommandEnv, namespace: str, name: str,
                    partitions: int = 4) -> dict:
    return _call("POST", f"{_broker(env)}/topics/{namespace}/{name}",
                 "mq.topic.create",
                 json={"partitions": partitions}).json()


def mq_topic_describe(env: CommandEnv, namespace: str,
                      name: str) -> dict:
    return _call("GET", f"{_broker(env)}/topics/{namespace}/{name}",
                 "mq.topic.describe").json()


def mq_topic_delete(env: CommandEnv, namespace: str, name: str) -> str:
    _call("DELETE", f"{_broker(env)}/topics/{namespace}/{name}",
          "mq.topic.delete")
    return f"deleted {namespace}/{name}"
