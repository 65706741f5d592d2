"""Chunk encryption: AES-256-GCM with a random per-chunk key; the
counterpart of seaweedfs_tpu/utils/cipher.py over OpenSSL's libcrypto.

Equivalent of SeaweedFS weed/util/cipher.go — GenCipherKey / Encrypt /
Decrypt. Wire format matches the reference: the random nonce is
prepended to the GCM ciphertext (which carries its auth tag), so a
stored cipher-chunk is nonce || ciphertext || tag. Each chunk gets its
OWN random 256-bit key, stored in the filer entry's chunk record
(FileChunk.cipher_key) — the volume server only ever sees ciphertext,
and possession of the filer metadata is what grants decryption.

The reference calls the `cryptography` package; the port binds the EVP
AES-256-GCM interface of libcrypto (OpenSSL 1.1 or 3) through ctypes,
loaded at the first encrypt or decrypt. Without the library those
calls raise OSError naming it: nothing falls back to another cipher
or to plaintext.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading

KEY_SIZE = 32  # AES-256
NONCE_SIZE = 12  # GCM standard nonce
TAG_SIZE = 16

# EVP_CIPHER_CTX_ctrl commands (openssl/evp.h)
_CTRL_GCM_SET_IVLEN = 0x9
_CTRL_GCM_GET_TAG = 0x10
_CTRL_GCM_SET_TAG = 0x11

_LIB_NAMES = ("libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so")
_lib = None
_lib_lock = threading.Lock()


def _libcrypto():
    """libcrypto with the EVP prototypes this module calls, loaded once."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        names = [n for n in (ctypes.util.find_library("crypto"),) if n]
        names += [n for n in _LIB_NAMES if n not in names]
        lib, errors = None, []
        for name in names:
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError as e:
                errors.append(f"{name}: {e}")
        if lib is None:
            raise OSError("AES-256-GCM needs OpenSSL's libcrypto "
                          "(libcrypto.so.3), which did not load: "
                          + "; ".join(errors))
        vp, ip, cp = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        pint = ctypes.POINTER(ctypes.c_int)
        lib.EVP_CIPHER_CTX_new.restype = vp
        lib.EVP_CIPHER_CTX_new.argtypes = []
        lib.EVP_CIPHER_CTX_free.restype = None
        lib.EVP_CIPHER_CTX_free.argtypes = [vp]
        lib.EVP_aes_256_gcm.restype = vp
        lib.EVP_aes_256_gcm.argtypes = []
        lib.EVP_CIPHER_CTX_ctrl.restype = ip
        lib.EVP_CIPHER_CTX_ctrl.argtypes = [vp, ip, ip, vp]
        for fn in ("EVP_EncryptInit_ex", "EVP_DecryptInit_ex"):
            getattr(lib, fn).restype = ip
            getattr(lib, fn).argtypes = [vp, vp, vp, cp, cp]
        for fn in ("EVP_EncryptUpdate", "EVP_DecryptUpdate"):
            getattr(lib, fn).restype = ip
            getattr(lib, fn).argtypes = [vp, vp, pint, cp, ip]
        for fn in ("EVP_EncryptFinal_ex", "EVP_DecryptFinal_ex"):
            getattr(lib, fn).restype = ip
            getattr(lib, fn).argtypes = [vp, vp, pint]
        _lib = lib
        return lib


def gen_cipher_key() -> bytes:
    """Random per-chunk key (GenCipherKey, cipher.go:15)."""
    return os.urandom(KEY_SIZE)


def _check_key(key: bytes) -> None:
    if len(key) != KEY_SIZE:
        raise ValueError(f"cipher key must be {KEY_SIZE} bytes")


def _gcm(encrypting: bool, key: bytes, nonce: bytes, data: bytes,
         tag: bytes = b"") -> tuple[bytes, bytes]:
    """One AES-256-GCM pass over `data` with no additional data ->
    (output, tag); decrypting checks `tag` and raises ValueError when
    it does not authenticate."""
    lib = _libcrypto()
    mode = "Encrypt" if encrypting else "Decrypt"
    init = getattr(lib, f"EVP_{mode}Init_ex")
    update = getattr(lib, f"EVP_{mode}Update")
    final = getattr(lib, f"EVP_{mode}Final_ex")
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise MemoryError("EVP_CIPHER_CTX_new failed")
    try:
        if init(ctx, lib.EVP_aes_256_gcm(), None, None, None) != 1 or \
                lib.EVP_CIPHER_CTX_ctrl(ctx, _CTRL_GCM_SET_IVLEN,
                                        len(nonce), None) != 1 or \
                init(ctx, None, None, key, nonce) != 1:
            raise ValueError("AES-256-GCM setup failed")
        out = bytearray(len(data) + 16)
        buf = (ctypes.c_char * len(out)).from_buffer(out)
        n = ctypes.c_int(0)
        if data and update(ctx, buf, ctypes.byref(n), data,
                           len(data)) != 1:
            raise ValueError("AES-256-GCM update failed")
        total = n.value
        if not encrypting:
            tag_buf = ctypes.create_string_buffer(tag, TAG_SIZE)
            lib.EVP_CIPHER_CTX_ctrl(ctx, _CTRL_GCM_SET_TAG, TAG_SIZE,
                                    tag_buf)
        tail = (ctypes.c_char * 16).from_buffer(out, total)
        if final(ctx, tail, ctypes.byref(n)) != 1:
            raise ValueError("cipher chunk failed authentication")
        total += n.value
        del buf, tail  # release the exports before resizing
        del out[total:]
        if not encrypting:
            return bytes(out), tag
        tag_out = ctypes.create_string_buffer(TAG_SIZE)
        if lib.EVP_CIPHER_CTX_ctrl(ctx, _CTRL_GCM_GET_TAG, TAG_SIZE,
                                   tag_out) != 1:
            raise ValueError("AES-256-GCM tag read failed")
        return bytes(out), tag_out.raw
    finally:
        lib.EVP_CIPHER_CTX_free(ctx)


def _encrypt_with_nonce(plaintext: bytes, key: bytes,
                        nonce: bytes) -> bytes:
    """encrypt() under a given nonce (known-answer tests only: a nonce
    must never repeat under one key)."""
    _check_key(key)
    ct, tag = _gcm(True, key, nonce, bytes(plaintext))
    return nonce + ct + tag


def encrypt(plaintext: bytes, key: bytes) -> bytes:
    """nonce || AES-256-GCM(plaintext) (Encrypt, cipher.go:23)."""
    return _encrypt_with_nonce(plaintext, key, os.urandom(NONCE_SIZE))


def decrypt(ciphertext: bytes, key: bytes) -> bytes:
    """Inverse of encrypt; raises ValueError on tamper/short input
    (Decrypt, cipher.go:41)."""
    if len(ciphertext) < NONCE_SIZE:
        raise ValueError("ciphertext too short")
    _check_key(key)
    if len(ciphertext) < NONCE_SIZE + TAG_SIZE:
        raise ValueError("cipher chunk failed authentication")
    ciphertext = bytes(ciphertext)
    nonce = ciphertext[:NONCE_SIZE]
    body, tag = ciphertext[NONCE_SIZE:-TAG_SIZE], ciphertext[-TAG_SIZE:]
    return _gcm(False, key, nonce, body, tag)[0]
