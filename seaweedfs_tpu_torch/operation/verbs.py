"""Client SDK verbs: assign, upload, download, delete; the counterpart of
seaweedfs_tpu/operation/verbs.py.

Equivalent of SeaweedFS weed/operation/ (Assign assign_file_id.go:141,
upload_content.go, delete, lookup), over rpc/httpclient.py.
Not here: chunked files and backup.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..rpc.httpclient import session
from ..utils import retry


@dataclass
class AssignResult:
    fid: str
    url: str
    public_url: str
    count: int = 1
    auth: str = ""
    replicas: list[dict] = field(default_factory=list)


def assign(master_url: str, count: int = 1, collection: str = "",
           replication: str = "", ttl: str = "",
           data_center: str = "", disk_type: str = "") -> AssignResult:
    params = {"count": count}
    if collection:
        params["collection"] = collection
    if replication:
        params["replication"] = replication
    if ttl:
        params["ttl"] = ttl
    if data_center:
        params["dataCenter"] = data_center
    if disk_type:
        params["disk"] = disk_type
    resp = session().get(f"{master_url.rstrip('/')}/dir/assign",
                         params=params, timeout=30)
    body = resp.json()
    if resp.status_code != 200 or "error" in body:
        raise RuntimeError(f"assign: {body.get('error', resp.status_code)}")
    return AssignResult(fid=body["fid"], url=body["url"],
                        public_url=body.get("publicUrl", body["url"]),
                        count=body.get("count", count),
                        auth=body.get("auth", ""),
                        replicas=body.get("replicas", []))


def upload(url_or_assign, data: bytes, name: str = "",
           mime: str = "", auth: str = "", ts: int = 0) -> dict:
    """Upload bytes to a volume server as a raw body. Accepts an
    AssignResult or a full 'http://host:port/fid' url."""
    if isinstance(url_or_assign, AssignResult):
        url = f"http://{url_or_assign.url}/{url_or_assign.fid}"
        auth = auth or url_or_assign.auth
    else:
        url = url_or_assign
    headers = {"Content-Type": mime or "application/octet-stream"}
    if auth:
        headers["Authorization"] = f"Bearer {auth}"
    params = {}
    if ts:
        params["ts"] = str(ts)
    if name:
        params["name"] = name
    resp = session().post(url, data=data, headers=headers, params=params,
                          timeout=60)
    body = resp.json()
    if resp.status_code >= 300 or "error" in body:
        raise RuntimeError(f"upload: {body.get('error', resp.status_code)}")
    return body


def download(url: str, auth: str = "") -> bytes:
    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    resp = session().get(url, headers=headers, timeout=60)
    if resp.status_code != 200:
        raise RuntimeError(f"download {url}: {resp.status_code}")
    return resp.content


def delete(url: str, auth: str = "") -> None:
    headers = {"Authorization": f"Bearer {auth}"} if auth else {}
    resp = session().delete(url, headers=headers, timeout=30)
    if resp.status_code not in (200, 202, 404):
        raise RuntimeError(f"delete {url}: {resp.status_code}")


def upload_data(master_url: str, data: bytes, name: str = "",
                collection: str = "", replication: str = "",
                ttl: str = "", mime: str = "") -> str:
    """assign + upload in one call; returns the fid.

    Mints an overall deadline covering both hops (the SDK is its own
    gateway edge), so a slow assign eats into the upload's budget
    instead of each hop getting a fresh clock.
    """
    with retry.deadline_scope(budget=retry.EDGE_BUDGET):
        a = assign(master_url, collection=collection,
                   replication=replication, ttl=ttl)
        upload(a, data, name=name, mime=mime)
    return a.fid
