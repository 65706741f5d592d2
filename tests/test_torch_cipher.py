"""The port's -encryptVolumeData against the JAX package's (tolerance 0).

* utils/cipher.py over libcrypto: the AES-256 test cases of the GCM
  specification with no additional data (McGrew and Viega, "The
  Galois/Counter Mode of Operation", test cases 13-15), through a
  fixed-nonce helper; every ciphertext one package makes decrypts in
  the other (the reference's is the `cryptography` package); the same
  ValueErrors for a tampered or short input and a wrong key size.
* The cases of tests/test_cipher.py but the mount's (the mount is not
  ported), against a reference and a port cluster with `filer_cipher`.
* On a port cluster: the chunk bytes on the volume server are
  ciphertext 28 bytes longer than the plaintext piece; ranged reads
  across chunks, multi-chunk files and a ciphered manifest read back;
  nothing is inlined or gzipped under the cipher; `native_writes_ok`
  turns false; `/status` says "cipher": true.
* A file a reference filer with the cipher wrote reads back through a
  port filer over the same sqlite store and volumes, and the reverse.
"""
import functools
import hashlib

import numpy as np
import pytest
import requests

from seaweedfs_tpu.rpc.http import ServerThread as RefServerThread
from seaweedfs_tpu.server.cluster import Cluster as RefCluster
from seaweedfs_tpu.server.filer_server import FilerServer as RefFilerServer
from seaweedfs_tpu.utils import cipher as ref_cipher
from seaweedfs_tpu_torch.filer import filechunks as port_filechunks
from seaweedfs_tpu_torch.rpc.http import ServerThread
from seaweedfs_tpu_torch.server import filer_server as port_filer_server
from seaweedfs_tpu_torch.server.cluster import Cluster
from seaweedfs_tpu_torch.server.filer_server import FilerServer
from seaweedfs_tpu_torch.utils import cipher

from tests import test_cipher as ref_cases
from tests.torch_port_cases import call_case, port_cases, within

SEED = 20261018
PortCluster = functools.partial(Cluster, ec_backend="native")

# (key, iv, plaintext, ciphertext, tag): GCM spec test cases 13, 14, 15
GCM_VECTORS = [
    ("00" * 32, "00" * 12, "", "", "530f8afbc74536b9a963b4f1c4cb738b"),
    ("00" * 32, "00" * 12, "00" * 16, "cea7403d4d606b6e074ec5d3baf39d18",
     "d0d1c8a799996bf0265b98b5d48ab919"),
    ("feffe9928665731c6d6a8f9467308308feffe9928665731c6d6a8f9467308308",
     "cafebabefacedbaddecaf888",
     "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
     "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b391aafd255",
     "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
     "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662898015ad",
     "b094dac5d93471bdec1a502270e3cc6c"),
]


@pytest.mark.parametrize("vec", range(len(GCM_VECTORS)))
def test_gcm_spec_vectors(vec):
    key, iv, pt, ct, tag = (bytes.fromhex(x) for x in GCM_VECTORS[vec])
    sealed = cipher._encrypt_with_nonce(pt, key, iv)
    assert sealed == iv + ct + tag
    assert cipher.decrypt(sealed, key) == pt
    assert ref_cipher.decrypt(sealed, key) == pt


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 4095, 1 << 20])
def test_each_package_decrypts_the_others(n):
    rng = np.random.default_rng([SEED, n])
    data = rng.bytes(n)
    key = rng.bytes(32)
    a, b = cipher.encrypt(data, key), ref_cipher.encrypt(data, key)
    assert len(a) == len(b) == n + cipher.NONCE_SIZE + cipher.TAG_SIZE
    assert a[:12] != b[:12]                     # fresh random nonces
    assert ref_cipher.decrypt(a, key) == data
    assert cipher.decrypt(b, key) == data
    assert cipher.decrypt(a, key) == data
    assert len(cipher.gen_cipher_key()) == cipher.KEY_SIZE == 32


def _error(fn, *args) -> str:
    with pytest.raises(ValueError) as ei:
        fn(*args)
    return str(ei.value)


@pytest.mark.parametrize("case", ["tamper_tag", "tamper_body",
                                  "tamper_nonce", "short", "no_tag",
                                  "wrong_key", "key_size_encrypt",
                                  "key_size_decrypt"])
def test_errors_as_the_reference(case):
    key = bytes(range(32))
    sealed = bytearray(ref_cipher.encrypt(b"payload bytes", key))
    args = {
        "tamper_tag": (bytes(sealed[:-1]) + bytes([sealed[-1] ^ 1]), key),
        "tamper_body": (bytes(sealed[:13]) + bytes([sealed[13] ^ 1])
                        + bytes(sealed[14:]), key),
        "tamper_nonce": (bytes([sealed[0] ^ 1]) + bytes(sealed[1:]), key),
        "short": (b"\x00" * 4, key),
        "no_tag": (bytes(sealed[:20]), key),
        "wrong_key": (bytes(sealed), bytes(32)),
        "key_size_decrypt": (bytes(sealed), b"short-key"),
    }
    if case == "key_size_encrypt":
        assert _error(cipher.encrypt, b"x", b"short-key") == \
            _error(ref_cipher.encrypt, b"x", b"short-key")
        return
    assert _error(cipher.decrypt, *args[case]) == \
        _error(ref_cipher.decrypt, *args[case])


def test_a_missing_libcrypto_raises_at_first_use(monkeypatch):
    monkeypatch.setattr(cipher, "_lib", None)
    monkeypatch.setattr(cipher.ctypes.util, "find_library", lambda n: None)
    monkeypatch.setattr(cipher, "_LIB_NAMES", ("libcrypto-absent.so.9",))
    key = cipher.gen_cipher_key()             # no library needed
    with pytest.raises(OSError, match="libcrypto"):
        cipher.encrypt(b"x", key)
    with pytest.raises(OSError, match="libcrypto"):
        cipher.decrypt(b"\x00" * 40, key)


# -- the reference's e2e cases, on both packages ---------------------------
CASES = {
    "reference": port_cases(ref_cases),
    "port": port_cases(ref_cases, Cluster=PortCluster,
                       FilerServer=FilerServer, ServerThread=ServerThread,
                       cipher=cipher),
}
E2E = [c for c in CASES["port"]
       if c not in ("test_cipher_round_trip", "test_cipher_tamper_and_short",
                    "test_mount_client_reads_and_writes_cipher")]
PRIMITIVE = ["test_cipher_round_trip", "test_cipher_tamper_and_short"]


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """A reference and a port cluster, each with a ciphered sqlite filer
    (its store file under "db")."""
    dirs = {pkg: tmp_path_factory.mktemp(f"{pkg}_ciph")
            for pkg in ("reference", "port")}
    kw = dict(n_volume_servers=1, volume_size_limit=16 << 20,
              with_filer=True, filer_store="sqlite", filer_cipher=True)
    ref = within(60, RefCluster, str(dirs["reference"]), **kw)
    try:
        port = within(60, PortCluster, str(dirs["port"]), **kw)
    except BaseException:
        within(60, ref.stop)
        raise
    yield {"reference": ref, "port": port,
           "db": {pkg: str(d / "filer.db") for pkg, d in dirs.items()}}
    within(60, port.stop)
    within(60, ref.stop)


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("case", PRIMITIVE)
def test_cipher_primitive_cases(case, pkg):
    call_case(CASES[pkg][case], {})


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("case", E2E)
def test_cipher_cases_on_each_cluster(case, pkg, clusters,
                                      tmp_path_factory):
    call_case(CASES[pkg][case], {"cluster": clusters[pkg],
                                 "tmp_path_factory": tmp_path_factory})


# -- the port cluster, chunk by chunk ---------------------------------------
def _raw(cluster, fid: str) -> bytes:
    vid = fid.split(",")[0]
    loc = requests.get(f"{cluster.master_url}/dir/lookup",
                       params={"volumeId": vid}, timeout=30).json()
    r = requests.get(f"http://{loc['locations'][0]['url']}/{fid}",
                     timeout=30)
    r.raise_for_status()
    return r.content


def _meta(base: str, path: str) -> dict:
    r = requests.get(f"{base}{path}", params={"meta": "1"}, timeout=30)
    r.raise_for_status()
    return r.json()


def test_volume_bytes_are_ciphertext_28_bytes_longer(clusters):
    c = clusters["port"]
    rng = np.random.default_rng(SEED)
    # a compressible name and body: under the cipher it is never gzipped
    body = b"text " * 40_000 + rng.bytes(1000)
    url = f"{c.filer_url}/enc/notes.txt"
    assert requests.post(url, data=body, timeout=30).status_code == 201
    meta = _meta(c.filer_url, "/enc/notes.txt")
    assert "content" not in meta             # never inlined
    for ch in meta["chunks"]:
        raw = _raw(c, ch["fid"])
        piece = body[ch["offset"]:ch["offset"] + ch["size"]]
        assert len(raw) == ch["size"] + 28
        assert piece not in raw and raw[12:-16] != piece
        assert cipher.decrypt(raw, bytes.fromhex(ch["cipher_key"])) == piece
        assert ch["etag"] == hashlib.md5(piece).hexdigest()
    assert requests.get(url, timeout=30).content == body


def test_save_inside_is_ignored_under_the_cipher(clusters):
    c = clusters["port"]
    url = f"{c.filer_url}/enc/tiny.bin"
    r = requests.post(url, data=b"tiny", params={"saveInside": "true"},
                      timeout=30)
    assert r.status_code == 201
    meta = _meta(c.filer_url, "/enc/tiny.bin")
    assert "content" not in meta and meta["chunks"][0]["cipher_key"]
    assert requests.get(url, timeout=30).content == b"tiny"


def test_ranged_multichunk_and_manifest_reads(clusters, monkeypatch):
    """Small chunks and a manifest batch of 4: the manifest chunk is
    itself ciphertext, and ranges across chunk seams read back."""
    c = clusters["port"]
    monkeypatch.setattr(port_filer_server, "MANIFEST_BATCH", 4)
    monkeypatch.setattr(port_filer_server, "maybe_manifestize",
                        functools.partial(port_filechunks.maybe_manifestize,
                                          batch=4))
    fs = FilerServer(c.master_url, store="memory", chunk_size=1000,
                     cipher=True)
    t = within(30, ServerThread(fs.app).start)
    fs.address = t.address
    try:
        body = np.random.default_rng(SEED + 1).bytes(23_456)
        url = f"{t.url}/m/big.bin"
        assert requests.post(url, data=body, timeout=60).status_code == 201
        chunks = _meta(t.url, "/m/big.bin")["chunks"]
        manifests = [ch for ch in chunks if ch.get("is_chunk_manifest")]
        assert manifests and all(ch["cipher_key"] for ch in chunks)
        raw = _raw(c, manifests[0]["fid"])
        assert b"chunks" not in raw
        assert b"chunks" in cipher.decrypt(
            raw, bytes.fromhex(manifests[0]["cipher_key"]))
        assert requests.get(url, timeout=60).content == body
        for lo, hi in ((0, 0), (999, 1000), (1500, 2600), (3990, 12_345),
                       (23_000, 23_455)):
            r = requests.get(url, headers={"Range": f"bytes={lo}-{hi}"},
                             timeout=30)
            assert r.status_code == 206 and r.content == body[lo:hi + 1]
    finally:
        within(30, t.stop)


def test_native_writes_gate_and_status(clusters):
    c = clusters["port"]
    assert c.filer.native_writes_ok() is False
    assert requests.get(f"{c.filer_url}/status",
                        timeout=30).json()["cipher"] is True
    plain = FilerServer(c.master_url, store="memory")
    assert plain.native_writes_ok() is True
    assert plain.cipher is False


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_an_encrypted_file_reads_back_in_the_other_filer(writer, clusters):
    """Both filers over the writer cluster's sqlite store and volumes:
    the file one package encrypted, the other decrypts."""
    c, store_path = clusters[writer], clusters["db"][writer]
    other = {"reference": (FilerServer, ServerThread),
             "port": (RefFilerServer, RefServerThread)}[writer]
    fs = other[0](c.master_url, store="sqlite", store_path=store_path,
                  cipher=True)
    t = within(30, other[1](fs.app).start)
    fs.address = t.address
    try:
        rng = np.random.default_rng([SEED, len(writer)])
        body = rng.bytes(3 << 20)
        name = f"/x/{writer}-written.bin"
        r = requests.post(f"{c.filer_url}{name}", data=body,
                          params={"maxMB": "1"}, timeout=60)
        assert r.status_code == 201
        assert requests.get(f"{t.url}{name}", timeout=60).content == body
        r = requests.get(f"{t.url}{name}",
                         headers={"Range": "bytes=1048000-2097999"},
                         timeout=60)
        assert r.content == body[1048000:2098000]
        # and back: the other filer writes, the writer's filer reads
        back = f"/x/{writer}-read-back.bin"
        assert requests.post(f"{t.url}{back}", data=body[:70_000],
                             timeout=60).status_code == 201
        assert requests.get(f"{c.filer_url}{back}",
                            timeout=60).content == body[:70_000]
        for ch in _meta(c.filer_url, back)["chunks"]:
            assert ch["cipher_key"]
    finally:
        within(30, t.stop)
