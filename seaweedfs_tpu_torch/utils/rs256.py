"""RS256 (RSASSA-PKCS1-v1_5 with SHA-256) signing, stdlib only; the
counterpart of seaweedfs_tpu/utils/rs256.py, copied as is.

Needed exactly once in this tree: Google service-account JWT grants
(remote_storage/gcs_client.py). A PEM private key is parsed from its
DER encoding (PKCS#8 `PrivateKeyInfo` wrapping, or a bare PKCS#1
`RSAPrivateKey`) with a ~40-line ASN.1 reader, and the signature is
the textbook `pow(em, d, n)` — RSA signing needs no randomness, so
the stdlib suffices. Verified against `openssl dgst -sha256 -sign`
in the test suite.
"""
from __future__ import annotations

import base64
import hashlib

# DigestInfo prefix for SHA-256 (RFC 8017 section 9.2 notes)
_SHA256_PREFIX = bytes.fromhex(
    "3031300d060960864801650304020105000420")


def _pem_to_der(pem: str) -> bytes:
    lines = [ln.strip() for ln in pem.strip().splitlines()
             if ln.strip() and not ln.startswith("-----")]
    return base64.b64decode("".join(lines))


def _read_tlv(der: bytes, at: int) -> tuple[int, bytes, int]:
    """-> (tag, value, offset after the TLV)."""
    tag = der[at]
    length = der[at + 1]
    at += 2
    if length & 0x80:
        n = length & 0x7F
        length = int.from_bytes(der[at:at + n], "big")
        at += n
    return tag, der[at:at + length], at + length


def _parse_rsa_key(der: bytes) -> tuple[int, int]:
    """DER -> (n, d). Accepts PKCS#8 PrivateKeyInfo or PKCS#1
    RSAPrivateKey."""
    tag, body, _ = _read_tlv(der, 0)
    if tag != 0x30:
        raise ValueError("not a DER SEQUENCE")
    # collect the top-level sequence elements
    elems = []
    at = 0
    while at < len(body):
        t, v, at = _read_tlv(body, at)
        elems.append((t, v))
    if len(elems) >= 3 and elems[0][0] == 0x02 and elems[1][0] == 0x30:
        # PKCS#8: version, AlgorithmIdentifier, OCTET STRING(PKCS#1)
        return _parse_rsa_key(elems[2][1])
    # PKCS#1 RSAPrivateKey: version, n, e, d, p, q, ...
    ints = [int.from_bytes(v, "big") for t, v in elems if t == 0x02]
    if len(ints) < 4:
        raise ValueError("not an RSA private key")
    _version, n, _e, d = ints[:4]
    return n, d


def sign(private_key_pem: str, message: bytes) -> bytes:
    """RS256 signature of `message`."""
    n, d = _parse_rsa_key(_pem_to_der(private_key_pem))
    k = (n.bit_length() + 7) // 8
    digest = _SHA256_PREFIX + hashlib.sha256(message).digest()
    # EMSA-PKCS1-v1_5: 0x00 0x01 PS(0xff...) 0x00 DigestInfo
    ps_len = k - len(digest) - 3
    if ps_len < 8:
        raise ValueError("RSA key too small for SHA-256 DigestInfo")
    em = b"\x00\x01" + b"\xff" * ps_len + b"\x00" + digest
    sig = pow(int.from_bytes(em, "big"), d, n)
    return sig.to_bytes(k, "big")
