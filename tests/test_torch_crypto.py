"""The port's encrypted save / load (paddle_tpu_torch/framework/crypto.py
and io_save's encryption_key=) against the JAX package's.

- Both schemes round-trip: AES-256-GCM through libcrypto, and the
  HMAC-SHA256 counter-mode fallback, forced through the module's own
  `_gcm_available`.
- A container either package writes decrypts under the other, in both
  schemes, and both refuse a wrong key.
- io_save with a key: the round trip, a missing key, a wrong key, and the
  file's bytes hiding the pickle.
- generate_key, Cipher and CipherFactory as the JAX package's tests use
  them.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import numpy as np
import pytest
import torch

from paddle_tpu.framework import crypto as jcrypto
from paddle_tpu_torch.framework import crypto, io_save

SCHEMES = ['gcm', 'hmac_ctr']
PAYLOAD = bytes(range(256)) * 37 + b'tail'


@pytest.fixture(params=SCHEMES)
def scheme(request, monkeypatch):
    """The scheme both packages write: the fallback is forced by making
    each module's _gcm_available answer False."""
    if request.param == 'gcm':
        assert crypto._gcm_available() and jcrypto._gcm_available()
    else:
        monkeypatch.setattr(crypto, '_gcm_available', lambda: False)
        monkeypatch.setattr(jcrypto, '_gcm_available', lambda: False)
    return {'gcm': crypto._SCHEME_GCM,
            'hmac_ctr': crypto._SCHEME_HMAC_CTR}[request.param]


@pytest.mark.parametrize('key', ['a-passphrase', 'ab' * 32, b'raw-bytes'])
def test_round_trip(scheme, key):
    blob = crypto.encrypt(PAYLOAD, key)
    assert blob[:8] == b'PTCRYPT1' and blob[8] == scheme
    assert len(blob) == 8 + 1 + 12 + 16 + len(PAYLOAD)
    assert PAYLOAD[:64] not in blob
    assert crypto.decrypt(blob, key) == PAYLOAD
    # a fresh nonce a call: the same plaintext never encrypts alike
    assert crypto.encrypt(PAYLOAD, key)[9:] != blob[9:]


@pytest.mark.parametrize('direction', ['port_to_jax', 'jax_to_port'])
def test_cross_package(scheme, direction):
    enc, dec = (crypto, jcrypto) if direction == 'port_to_jax' \
        else (jcrypto, crypto)
    key = crypto.generate_key()
    blob = enc.encrypt(PAYLOAD, key)
    assert blob[8] == scheme
    assert dec.decrypt(blob, key) == PAYLOAD
    with pytest.raises(ValueError, match='wrong key'):
        dec.decrypt(blob, 'not-the-key')


def test_tampered_and_foreign_blobs_refused(scheme):
    blob = bytearray(crypto.encrypt(PAYLOAD, 'k'))
    blob[-1] ^= 1
    with pytest.raises(ValueError, match='wrong key or corrupted'):
        crypto.decrypt(bytes(blob), 'k')
    with pytest.raises(ValueError, match='not a paddle_tpu encrypted'):
        crypto.decrypt(b'PK\x03\x04' + PAYLOAD, 'k')
    bad = bytes(blob[:8]) + b'\x07' + bytes(blob[9:])
    with pytest.raises(ValueError, match='unknown cipher scheme 7'):
        crypto.decrypt(bad, 'k')


def test_keys_normalised_as_the_jax_package_does():
    for key in ('k', 'ab' * 16, 'ab' * 32, 'zz' * 16, b'\x00' * 5):
        assert crypto._norm_key(key) == jcrypto._norm_key(key)
        assert len(crypto._norm_key(key)) == 32


def test_files(scheme, tmp_path):
    src, enc, out = (str(tmp_path / n) for n in ('src', 'enc', 'out'))
    with open(src, 'wb') as f:
        f.write(PAYLOAD)
    crypto.encrypt_file(src, enc, 'k')
    assert crypto.is_encrypted(enc) and jcrypto.is_encrypted(enc)
    assert not crypto.is_encrypted(src)
    assert not crypto.is_encrypted(str(tmp_path / 'missing'))
    jcrypto.decrypt_file(enc, out, 'k')
    with open(out, 'rb') as f:
        assert f.read() == PAYLOAD


def test_io_save_with_key(scheme, tmp_path):
    key = crypto.generate_key()
    state = {'w': torch.arange(6, dtype=torch.float32),
             'h': torch.randn(3, 4, dtype=torch.float64),
             'b': torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
             'step': 7}
    path = str(tmp_path / 'enc.pdparams')
    io_save.save(state, path, encryption_key=key)
    with open(path, 'rb') as f:
        raw = f.read()
    assert raw[:8] == b'PTCRYPT1' and raw[8] == scheme
    assert b'numpy' not in raw  # the pickle is not in the clear
    assert io_save.verify_checkpoint(path, require_manifest=True)
    loaded = io_save.load(path, encryption_key=key)
    for k in ('w', 'h', 'b'):
        assert loaded[k].dtype == state[k].dtype
        assert torch.equal(loaded[k], state[k])
    assert loaded['step'] == 7
    np.testing.assert_array_equal(
        io_save.load(path, encryption_key=key, return_numpy=True)['w'],
        np.arange(6, dtype=np.float32))
    with pytest.raises(ValueError, match='encrypted'):
        io_save.load(path)
    with pytest.raises(ValueError, match='wrong key|corrupted'):
        io_save.load(path, encryption_key='not-the-key')
    # the container decrypts under the JAX package's crypto too; its
    # pickle is the port's own payload format
    assert jcrypto.decrypt(raw, key)[:2] == b'\x80\x04'


def test_generate_key_cipher_and_factory(tmp_path):
    key = crypto.generate_key()
    assert len(key) == 64 and bytes.fromhex(key)
    kpath = str(tmp_path / 'key')
    written = crypto.generate_key(kpath)
    with open(kpath) as f:
        assert f.read() == written
    c = crypto.CipherFactory.create_cipher()
    blob = c.encrypt(b'secret weights', 'k1')
    assert c.decrypt(blob, 'k1') == b'secret weights'
    assert jcrypto.CipherFactory.create_cipher().decrypt(blob, 'k1') == \
        b'secret weights'
    assert crypto.Cipher('k3').decrypt(crypto.Cipher('k3').encrypt(
        'text')) == b'text'
    fname = str(tmp_path / 'c.bin')
    c.encrypt_to_file(b'on disk', 'k4', fname)
    assert c.decrypt_from_file('k4', fname) == b'on disk'
    # the HMAC-CTR stream decrypts its own output, as the JAX test has it
    k = crypto._norm_key('k2')
    nonce = b'\x00' * 12
    ct = crypto._hmac_ctr(k, nonce, b'payload')
    assert crypto._hmac_ctr(k, nonce, ct) == b'payload'
    assert ct == jcrypto._hmac_ctr(k, nonce, b'payload')
