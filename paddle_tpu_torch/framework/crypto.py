"""Encrypted model save / load (counterpart of
paddle_tpu/framework/crypto.py, copied: importing any paddle_tpu module
loads jax). Reference: framework/io/crypto/cipher.cc, the AES cipher over
cryptopp with cipher_utils key files, used by inference loads.

AES-256-GCM is driven through OpenSSL's libcrypto with ctypes. When
libcrypto is missing the fallback is an HMAC-SHA256 counter-mode stream
cipher with an HMAC authentication tag, a standard PRF construction with
no dependency. The container records which scheme wrote it, and its bytes
are the JAX package's: a container either package writes decrypts under
the other.

Format: b'PTCRYPT1' | scheme(1) | nonce(12) | tag(16) | ciphertext.
"""
import ctypes
import ctypes.util
import hashlib
import hmac as hmac_mod
import os
import struct

__all__ = ['Cipher', 'CipherFactory', 'encrypt', 'decrypt',
           'encrypt_file', 'decrypt_file', 'generate_key']

_MAGIC = b'PTCRYPT1'
_SCHEME_GCM = 1
_SCHEME_HMAC_CTR = 2


def generate_key(path=None):
    """32-byte random key, hex-encoded (cipher_utils GenKey parity)."""
    key = os.urandom(32).hex()
    if path:
        with open(path, 'w') as f:
            f.write(key)
    return key


def _norm_key(key):
    if isinstance(key, str):
        try:
            b = bytes.fromhex(key)
            if len(b) in (16, 24, 32):
                key = b
            else:
                key = key.encode()
        except ValueError:
            key = key.encode()
    return hashlib.sha256(key).digest()  # always 32 bytes


# -- OpenSSL AES-256-GCM ------------------------------------------------------

_libcrypto = None


def _crypto():
    global _libcrypto
    if _libcrypto is None:
        name = ctypes.util.find_library('crypto') or 'libcrypto.so.3'
        lib = ctypes.CDLL(name)
        lib.EVP_CIPHER_CTX_new.restype = ctypes.c_void_p
        lib.EVP_aes_256_gcm.restype = ctypes.c_void_p
        for fn in (lib.EVP_EncryptInit_ex, lib.EVP_DecryptInit_ex,
                   lib.EVP_EncryptUpdate, lib.EVP_DecryptUpdate,
                   lib.EVP_EncryptFinal_ex, lib.EVP_DecryptFinal_ex,
                   lib.EVP_CIPHER_CTX_ctrl):
            fn.restype = ctypes.c_int
        _libcrypto = lib
    return _libcrypto


def _gcm(encrypting, key, nonce, data, tag=None):
    lib = _crypto()
    ctx = lib.EVP_CIPHER_CTX_new()
    if not ctx:
        raise RuntimeError('EVP_CIPHER_CTX_new failed')
    try:
        init = lib.EVP_EncryptInit_ex if encrypting else \
            lib.EVP_DecryptInit_ex
        upd = lib.EVP_EncryptUpdate if encrypting else \
            lib.EVP_DecryptUpdate
        fin = lib.EVP_EncryptFinal_ex if encrypting else \
            lib.EVP_DecryptFinal_ex
        if init(ctypes.c_void_p(ctx), ctypes.c_void_p(
                lib.EVP_aes_256_gcm()), None, key, nonce) != 1:
            raise RuntimeError('GCM init failed')
        out = ctypes.create_string_buffer(len(data) + 16)
        outl = ctypes.c_int(0)
        if upd(ctypes.c_void_p(ctx), out, ctypes.byref(outl), data,
               len(data)) != 1:
            raise RuntimeError('GCM update failed')
        n = outl.value
        if not encrypting:
            # set expected tag before final
            if lib.EVP_CIPHER_CTX_ctrl(ctypes.c_void_p(ctx), 0x11, 16,
                                       tag) != 1:  # EVP_CTRL_GCM_SET_TAG
                raise RuntimeError('GCM set-tag failed')
        fl = ctypes.c_int(0)
        if fin(ctypes.c_void_p(ctx), ctypes.byref(
                ctypes.create_string_buffer(16)), ctypes.byref(fl)) != 1:
            raise ValueError('decryption failed: wrong key or corrupted '
                             'data (GCM tag mismatch)')
        if encrypting:
            tag_buf = ctypes.create_string_buffer(16)
            if lib.EVP_CIPHER_CTX_ctrl(ctypes.c_void_p(ctx), 0x10, 16,
                                       tag_buf) != 1:  # EVP_CTRL_GCM_GET_TAG
                raise RuntimeError('GCM get-tag failed')
            return out.raw[:n], tag_buf.raw
        return out.raw[:n]
    finally:
        lib.EVP_CIPHER_CTX_free(ctypes.c_void_p(ctx))


def _gcm_available():
    try:
        _crypto()
        return True
    except Exception:
        return False


# -- HMAC-SHA256 CTR fallback -------------------------------------------------

def _hmac_ctr_keystream(key, nonce, n):
    out = b''
    counter = 0
    while len(out) < n:
        out += hmac_mod.new(key, nonce + struct.pack('<Q', counter),
                            hashlib.sha256).digest()
        counter += 1
    return out[:n]


def _hmac_ctr(key, nonce, data):
    ks = _hmac_ctr_keystream(key, nonce, len(data))
    return bytes(a ^ b for a, b in zip(data, ks))


def _hmac_tag(key, nonce, ct):
    return hmac_mod.new(key, b'tag' + nonce + ct, hashlib.sha256).digest()[:16]


# -- public API ---------------------------------------------------------------

def encrypt(data, key):
    """bytes -> PTCRYPT1 container."""
    k = _norm_key(key)
    nonce = os.urandom(12)
    if _gcm_available():
        ct, tag = _gcm(True, k, nonce, data)
        scheme = _SCHEME_GCM
    else:
        ct = _hmac_ctr(k, nonce, data)
        tag = _hmac_tag(k, nonce, ct)
        scheme = _SCHEME_HMAC_CTR
    return _MAGIC + bytes([scheme]) + nonce + tag + ct


def decrypt(blob, key):
    if not blob.startswith(_MAGIC):
        raise ValueError('not a paddle_tpu encrypted container')
    scheme = blob[len(_MAGIC)]
    nonce = blob[9:21]
    tag = blob[21:37]
    ct = blob[37:]
    k = _norm_key(key)
    if scheme == _SCHEME_GCM:
        return _gcm(False, k, nonce, ct, tag)
    if scheme == _SCHEME_HMAC_CTR:
        if not hmac_mod.compare_digest(tag, _hmac_tag(k, nonce, ct)):
            raise ValueError('decryption failed: wrong key or corrupted '
                             'data (HMAC mismatch)')
        return _hmac_ctr(k, nonce, ct)
    raise ValueError('unknown cipher scheme %d' % scheme)


def is_encrypted(path):
    try:
        with open(path, 'rb') as f:
            return f.read(len(_MAGIC)) == _MAGIC
    except OSError:
        return False


def encrypt_file(src, dst, key):
    with open(src, 'rb') as f:
        data = f.read()
    with open(dst, 'wb') as f:
        f.write(encrypt(data, key))


def decrypt_file(src, dst, key):
    with open(src, 'rb') as f:
        blob = f.read()
    with open(dst, 'wb') as f:
        f.write(decrypt(blob, key))


class Cipher:
    """Reference cipher.h parity surface."""

    def __init__(self, key=None):
        self._key = key

    def encrypt(self, plaintext, key=None):
        return encrypt(plaintext if isinstance(plaintext, bytes)
                       else plaintext.encode(), key or self._key)

    def decrypt(self, ciphertext, key=None):
        return decrypt(ciphertext, key or self._key)

    def encrypt_to_file(self, plaintext, key, filename):
        with open(filename, 'wb') as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key, filename):
        with open(filename, 'rb') as f:
            return self.decrypt(f.read(), key)


class CipherFactory:
    @staticmethod
    def create_cipher(config_file=None):
        return Cipher()
