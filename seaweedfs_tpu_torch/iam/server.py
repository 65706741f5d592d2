"""A minimal AWS IAM REST API managing the S3 gateway's identities; the
counterpart of seaweedfs_tpu/iam/server.py.

Equivalent of SeaweedFS weed/iamapi/ (iamapi_server.go,
iamapi_management_handlers.go): form-encoded Action= requests with XML
responses — CreateUser / GetUser / DeleteUser / ListUsers,
CreateAccessKey / DeleteAccessKey / ListAccessKeys, PutUserPolicy /
GetUserPolicy / DeleteUserPolicy. The state is the same s3.configure
identities document the S3 gateway reloads, kept in the filer KV under
`s3/identities` (s3/server.py IDENTITIES_KV_KEY).

Policy documents map onto the gateway's action strings as the
reference maps them (iamapi_management_handlers.go GetActions): s3:* ->
Admin, s3:Get* -> Read, s3:Put* / s3:Delete* -> Write, s3:List* ->
List, any tagging verb -> Tagging, each narrowed per bucket as
"Action:bucket".

The port serves it from an `rpc/http.App` on threads; one mutex
serializes each request's load-change-save of the document, where the
reference held an asyncio lock, so concurrent requests lose no update.
The document's bytes, the replies' XML and their statuses are the
reference's.
"""
from __future__ import annotations

import email.parser
import email.policy
import json
import secrets
import threading
import uuid
from urllib.parse import parse_qsl
from xml.sax.saxutils import escape

from ..rpc.http import App, Request, Response, json_response
from ..rpc.httpclient import session

IDENTITIES_KV_KEY = "s3/identities"
# each filer hop, as the reference's ClientTimeout(total=10)
FILER_TIMEOUT = 10.0
# aiohttp's default client_max_size, which the reference's app keeps
MAX_BODY = 1 << 20
_XML = "application/xml; charset=utf-8"


def _xml(action: str, inner: str) -> str:
    rid = uuid.uuid4()
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<{action}Response xmlns='
            f'"https://iam.amazonaws.com/doc/2010-05-08/">'
            f"{inner}"
            f"<ResponseMetadata><RequestId>{rid}</RequestId>"
            f"</ResponseMetadata></{action}Response>")


def _error(code: str, message: str, status: int = 400) -> Response:
    body = ('<?xml version="1.0" encoding="UTF-8"?>'
            "<ErrorResponse><Error>"
            f"<Code>{escape(code)}</Code>"
            f"<Message>{escape(message)}</Message>"
            "</Error></ErrorResponse>")
    return Response(body.encode(), status=status, content_type=_XML)


def _form(req: Request) -> dict[str, str]:
    """The request's form fields, first value of each (aiohttp's
    `await request.post()`): a url-encoded body, or multipart/form-data
    text fields; any other body reads as no field."""
    ctype = req.content_type
    if ctype in ("", "application/x-www-form-urlencoded"):
        out: dict[str, str] = {}
        for k, v in parse_qsl(req.read().decode("utf-8"),
                              keep_blank_values=True):
            out.setdefault(k, v)
        return out
    if ctype == "multipart/form-data":
        head = f"Content-Type: {req.headers['Content-Type']}\r\n\r\n"
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            head.encode() + req.read())
        out = {}
        for part in msg.iter_parts():
            name = part.get_param("name", header="content-disposition")
            if name is not None and name not in out:
                out[name] = part.get_content()
        return out
    return {}


def policy_to_actions(policy: dict) -> list[str]:
    """AWS policy document -> gateway action strings
    (iamapi_management_handlers.go GetActions)."""
    out: list[str] = []
    for st in policy.get("Statement", []):
        if st.get("Effect") != "Allow":
            continue
        actions = st.get("Action", [])
        if isinstance(actions, str):
            actions = [actions]
        resources = st.get("Resource", [])
        if isinstance(resources, str):
            resources = [resources]
        buckets = []
        for res in resources:
            # arn:aws:s3:::bucket/*, arn:aws:s3:::bucket, arn:aws:s3:::*
            tail = res.rsplit(":::", 1)[-1]
            bucket = tail.split("/", 1)[0]
            buckets.append("" if bucket in ("*", "") else bucket)
        for a in actions:
            verb = a.split(":", 1)[-1]
            if verb == "*":
                mapped = ["Admin"]
            elif "Tagging" in verb:
                # before the prefix arms: every tagging verb starts
                # with Get/Put/Delete and must NOT grant body access
                mapped = ["Tagging"]
            elif verb.startswith("Get"):
                mapped = ["Read"]
            elif verb.startswith("Put") or verb.startswith("Delete"):
                mapped = ["Write"]
            elif verb.startswith("List"):
                mapped = ["List"]
            else:
                mapped = []
            for m in mapped:
                for b in buckets or [""]:
                    out.append(f"{m}:{b}" if b else m)
    seen, uniq = set(), []
    for a in out:
        if a not in seen:
            seen.add(a)
            uniq.append(a)
    return uniq


class IamApiServer:
    def __init__(self, filer_url: str):
        self.filer_url = filer_url.rstrip("/") \
            if filer_url.startswith("http") else f"http://{filer_url}"
        # serializes load-mutate-save so concurrent requests cannot
        # lose each other's identity updates
        self._config_lock = threading.Lock()
        self.app = App(max_body=MAX_BODY)
        self.app.post("/", self.dispatch)
        self.app.get("/status", self.handle_status)

    def handle_status(self, req: Request) -> Response:
        return json_response({"filer": self.filer_url})

    # -- config persistence (filer KV, shared with the S3 gateway) -----
    def _load(self) -> dict:
        r = session().get(f"{self.filer_url}/kv/{IDENTITIES_KV_KEY}",
                          timeout=FILER_TIMEOUT)
        if r.status_code != 200:
            return {"identities": []}
        try:
            return json.loads(r.content)
        except json.JSONDecodeError:
            return {"identities": []}

    def _save(self, config: dict) -> None:
        session().put(f"{self.filer_url}/kv/{IDENTITIES_KV_KEY}",
                      data=json.dumps(config).encode(),
                      headers={"Content-Type": "application/octet-stream"},
                      timeout=FILER_TIMEOUT).raise_for_status()

    @staticmethod
    def _user(config: dict, name: str) -> dict | None:
        for ident in config.get("identities", []):
            if ident.get("name") == name:
                return ident
        return None

    # -- dispatch -------------------------------------------------------
    def dispatch(self, req: Request) -> Response:
        form = _form(req)
        action = form.get("Action", "")
        handler = getattr(self, f"do_{action}", None)
        if handler is None:
            return _error("InvalidAction", f"unsupported: {action}")
        with self._config_lock:
            config = self._load()
            try:
                inner, changed = handler(form, config)
            except KeyError as e:
                return _error("MissingParameter", str(e))
            if changed:
                self._save(config)
        if isinstance(inner, Response):
            return inner
        return Response(_xml(action, inner).encode(), content_type=_XML)

    # -- users ----------------------------------------------------------
    def do_CreateUser(self, form, config):
        name = form["UserName"]
        if self._user(config, name) is not None:
            return _error("EntityAlreadyExists",
                          f"user {name} exists", 409), False
        config.setdefault("identities", []).append(
            {"name": name, "credentials": [], "actions": []})
        return (f"<CreateUserResult><User>"
                f"<UserName>{escape(name)}</UserName>"
                f"<UserId>{uuid.uuid4()}</UserId>"
                f"<Arn>arn:aws:iam:::user/{escape(name)}</Arn>"
                f"</User></CreateUserResult>"), True

    def do_GetUser(self, form, config):
        name = form["UserName"]
        if self._user(config, name) is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        return (f"<GetUserResult><User>"
                f"<UserName>{escape(name)}</UserName>"
                f"<Arn>arn:aws:iam:::user/{escape(name)}</Arn>"
                f"</User></GetUserResult>"), False

    def do_DeleteUser(self, form, config):
        name = form["UserName"]
        ids = config.get("identities", [])
        if self._user(config, name) is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        config["identities"] = [i for i in ids if i.get("name") != name]
        return "", True

    def do_ListUsers(self, form, config):
        users = "".join(
            f"<member><UserName>{escape(i['name'])}</UserName>"
            f"<Arn>arn:aws:iam:::user/{escape(i['name'])}</Arn></member>"
            for i in config.get("identities", []))
        return (f"<ListUsersResult><Users>{users}</Users>"
                f"<IsTruncated>false</IsTruncated></ListUsersResult>"), \
            False

    # -- access keys ----------------------------------------------------
    def do_CreateAccessKey(self, form, config):
        name = form["UserName"]
        user = self._user(config, name)
        if user is None:  # the reference creates the user on a key request
            user = {"name": name, "credentials": [], "actions": []}
            config.setdefault("identities", []).append(user)
        access_key = "AKI" + secrets.token_hex(8).upper()
        secret_key = secrets.token_urlsafe(30)
        user.setdefault("credentials", []).append(
            {"accessKey": access_key, "secretKey": secret_key})
        return (f"<CreateAccessKeyResult><AccessKey>"
                f"<UserName>{escape(name)}</UserName>"
                f"<AccessKeyId>{access_key}</AccessKeyId>"
                f"<Status>Active</Status>"
                f"<SecretAccessKey>{secret_key}</SecretAccessKey>"
                f"</AccessKey></CreateAccessKeyResult>"), True

    def do_DeleteAccessKey(self, form, config):
        name, key_id = form["UserName"], form["AccessKeyId"]
        user = self._user(config, name)
        if user is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        before = len(user.get("credentials", []))
        user["credentials"] = [c for c in user.get("credentials", [])
                               if c.get("accessKey") != key_id]
        if len(user["credentials"]) == before:
            return _error("NoSuchEntity", f"no key {key_id}", 404), False
        return "", True

    def do_ListAccessKeys(self, form, config):
        name = form["UserName"]
        user = self._user(config, name)
        if user is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        members = "".join(
            f"<member><UserName>{escape(name)}</UserName>"
            f"<AccessKeyId>{c['accessKey']}</AccessKeyId>"
            f"<Status>Active</Status></member>"
            for c in user.get("credentials", []))
        return (f"<ListAccessKeysResult><AccessKeyMetadata>{members}"
                f"</AccessKeyMetadata><IsTruncated>false</IsTruncated>"
                f"</ListAccessKeysResult>"), False

    # -- user policies ---------------------------------------------------
    def do_PutUserPolicy(self, form, config):
        name = form["UserName"]
        doc = json.loads(form["PolicyDocument"])
        user = self._user(config, name)
        if user is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        user["actions"] = policy_to_actions(doc)
        user["policy_name"] = form.get("PolicyName", "")
        user["policy_document"] = form["PolicyDocument"]
        return "", True

    def do_GetUserPolicy(self, form, config):
        name = form["UserName"]
        user = self._user(config, name)
        if user is None or not user.get("policy_document"):
            return _error("NoSuchEntity", f"no policy for {name}",
                          404), False
        return (f"<GetUserPolicyResult>"
                f"<UserName>{escape(name)}</UserName>"
                f"<PolicyName>{escape(user.get('policy_name', ''))}"
                f"</PolicyName>"
                f"<PolicyDocument>"
                f"{escape(user['policy_document'])}"
                f"</PolicyDocument></GetUserPolicyResult>"), False

    def do_DeleteUserPolicy(self, form, config):
        name = form["UserName"]
        user = self._user(config, name)
        if user is None:
            return _error("NoSuchEntity", f"no user {name}", 404), False
        user["actions"] = []
        user.pop("policy_document", None)
        user.pop("policy_name", None)
        return "", True
