"""Model artifact encryption (paddle_tpu/framework/crypto.py, the port's
own copy of the pure-Python module).

Analog of reference framework/io/crypto/ (cipher.h CipherFactory,
aes_cipher.cc over cryptopp) + pybind/crypto.cc: inference models shipped
to untrusted hosts are encrypted at rest. Here AES-256-GCM via the
`cryptography` package — authenticated encryption (tamper = loud failure),
fresh 96-bit nonce per file, key from CipherUtils.gen_key or a
user-provided 32-byte secret.
"""
from __future__ import annotations

import os

__all__ = ["Cipher", "CipherFactory", "CipherUtils"]

_MAGIC = b"PTPUENC1"


class Cipher:
    """AES-256-GCM cipher (reference cipher.h Cipher interface)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("key must be 32 bytes (AES-256)")
        self._key = key

    def encrypt(self, plaintext: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        nonce = os.urandom(12)
        ct = AESGCM(self._key).encrypt(nonce, plaintext, _MAGIC)
        return _MAGIC + nonce + ct

    def decrypt(self, blob: bytes) -> bytes:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
        if not blob.startswith(_MAGIC):
            raise ValueError("not a paddle_tpu encrypted artifact")
        nonce, ct = blob[len(_MAGIC):len(_MAGIC) + 12], blob[len(_MAGIC) + 12:]
        return AESGCM(self._key).decrypt(nonce, ct, _MAGIC)

    # reference cipher.h file API
    def encrypt_to_file(self, plaintext: bytes, path: str):
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext))

    def decrypt_from_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read())

    def encrypt_file(self, src: str, dst: str):
        with open(src, "rb") as f:
            self.encrypt_to_file(f.read(), dst)

    def decrypt_file(self, src: str, dst: str):
        with open(dst, "wb") as f:
            f.write(self.decrypt_from_file(src))


class CipherFactory:
    """reference CipherFactory::CreateCipher."""

    @staticmethod
    def create_cipher(key: bytes = None):
        return Cipher(key or CipherUtils.gen_key())


class CipherUtils:
    @staticmethod
    def gen_key() -> bytes:
        return os.urandom(32)

    @staticmethod
    def gen_key_to_file(path: str) -> bytes:
        key = CipherUtils.gen_key()
        with open(path, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()
