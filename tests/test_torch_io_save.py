"""The port's checkpoint writer (paddle_tpu_torch/framework/io_save.py) on
the CPU, with the JAX package's io_save as the reference where the two
share a format.

- bf16 / fp16 / f32 / integer / bool tensors round-trip bit for bit (16-bit
  floats as raw uint16 with a dtype tag), nested in dicts, lists and tuples
  beside numpy arrays and plain values.
- The manifest sidecar is the JAX package's format: a file either package
  writes verifies under the other's verify_checkpoint.
- A truncated file or a flipped manifest raises CheckpointCorruptError; a
  writer killed at 'pre_rename' or 'pre_manifest' (chaos.crash_io_save)
  leaves the previous snapshot readable and its own torn state refused.
- encryption_key= writes a PTCRYPT1 container; a missing or wrong key
  raises (tests/test_torch_crypto.py holds the container to the JAX one).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.framework import io_save as jio_save
from paddle_tpu_torch.framework import io_save
from paddle_tpu_torch.testing import chaos

DTYPES = [torch.bfloat16, torch.float16, torch.float32, torch.float64,
          torch.int64, torch.int32, torch.int8, torch.uint8, torch.bool]


def _sample(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(4, 7, generator=gen) * 50
    if dtype == torch.bool:
        return x > 0
    if not dtype.is_floating_point:
        return x.to(dtype)
    x = x.to(dtype)
    # the extremes of the type: inf, -0.0, the smallest subnormal
    flat = x.view(-1)
    flat[0] = float('inf')
    flat[1] = -0.0
    flat[2] = torch.finfo(dtype).tiny / 2
    return x


def _bits(t):
    return t.view(torch.int16) if t.dtype in (torch.bfloat16,
                                              torch.float16) else t


@pytest.mark.parametrize('dtype', DTYPES, ids=lambda d: str(d)[6:])
def test_tensor_round_trip_is_bit_exact(tmp_path, dtype):
    x = _sample(dtype)
    path = str(tmp_path / 'x.pdparams')
    io_save.save({'x': x, 'p': torch.nn.Parameter(x.clone(),
                                                  requires_grad=False)},
                 path)
    back = io_save.load(path)
    assert back['x'].dtype == dtype and back['x'].shape == x.shape
    assert torch.equal(_bits(back['x']), _bits(x))
    assert isinstance(back['p'], torch.nn.Parameter)
    assert torch.equal(_bits(back['p'].data), _bits(x))
    assert io_save.verify_checkpoint(path, require_manifest=True)


def test_nested_structures_and_return_numpy(tmp_path):
    w = torch.randn(3, 5)
    obj = {'layers': [w, (w.bfloat16(), 3)], 'step': 7, 'name': 'gpt',
           'np': np.arange(6, dtype=np.int32), 'grad': w.requires_grad_()}
    path = str(tmp_path / 'nested.pd')
    io_save.save(obj, path)
    back = io_save.load(path)
    assert torch.equal(back['layers'][0], w.detach())
    assert isinstance(back['layers'][1], tuple)
    assert torch.equal(back['layers'][1][0].view(torch.int16),
                       w.detach().bfloat16().view(torch.int16))
    assert back['step'] == 7 and back['name'] == 'gpt'
    assert back['grad'].requires_grad
    assert np.array_equal(back['np'], obj['np'])
    arrays = io_save.load(path, return_numpy=True)
    assert isinstance(arrays['layers'][0], np.ndarray)
    # bf16 comes back widened to f32 (exact: numpy has no bf16)
    assert arrays['layers'][1][0].dtype == np.float32
    assert np.array_equal(arrays['layers'][1][0],
                          w.detach().bfloat16().float().numpy())


def test_state_dict_round_trip_into_a_model(tmp_path):
    from paddle_tpu_torch.text.models import gpt as tgpt
    cfg = tgpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                         num_heads=2, max_position_embeddings=32,
                         dropout=0.0)
    src = tgpt.GPTForCausalLM(cfg, device='cpu', seed=3).bfloat16()
    path = str(tmp_path / 'gpt.pdparams')
    io_save.save(src.state_dict(), path)
    dst = tgpt.GPTForCausalLM(cfg, device='cpu', seed=4).bfloat16()
    dst.load_state_dict(io_save.load(path))
    for k, v in src.state_dict().items():
        assert torch.equal(_bits(dst.state_dict()[k]), _bits(v)), k


def test_manifest_format_is_the_jax_packages(tmp_path):
    plain = {'w': [1.5] * 32, 'step': 3}
    tpath, jpath = str(tmp_path / 't.pd'), str(tmp_path / 'j.pd')
    io_save.save(plain, tpath)
    jio_save.save(plain, jpath)
    with open(tpath, 'rb') as f, open(jpath, 'rb') as g:
        assert f.read() == g.read()     # plain values: the same pickle
    with open(io_save.manifest_path(tpath)) as f, \
            open(jio_save.manifest_path(jpath)) as g:
        assert json.load(f) == json.load(g)
    # each package verifies the other's manifest
    assert jio_save.verify_checkpoint(tpath, require_manifest=True)
    assert io_save.verify_checkpoint(jpath, require_manifest=True)
    assert io_save.load(jpath) == plain


@pytest.mark.parametrize('damage', ['truncate', 'flip_payload',
                                    'flip_manifest'])
def test_damaged_checkpoint_raises_corrupt(tmp_path, damage):
    path = str(tmp_path / 'x.pd')
    io_save.save({'w': torch.randn(64).bfloat16()}, path)
    if damage == 'truncate':
        kept = chaos.truncate_file(path, drop_bytes=16)
        assert os.path.getsize(path) == kept
    else:
        target = path if damage == 'flip_payload' \
            else io_save.manifest_path(path)
        with open(target, 'rb') as f:
            blob = bytearray(f.read())
        # flip a digit of the manifest's size (still valid JSON), or a
        # payload byte
        at = blob.index(b'"size": ') + 8 if damage == 'flip_manifest' \
            else len(blob) // 2
        blob[at] = ord('9') if blob[at] != ord('9') else ord('1')
        with open(target, 'wb') as f:
            f.write(bytes(blob))
    assert not io_save.verify_checkpoint(path)
    with pytest.raises(io_save.CheckpointCorruptError):
        io_save.load(path)


@pytest.mark.parametrize('point', ['pre_rename', 'pre_manifest'])
def test_writer_killed_mid_save_leaves_the_old_snapshot(tmp_path, point):
    old = {'w': torch.full((8,), 1.0).bfloat16()}
    new = {'w': torch.full((8,), 2.0).bfloat16()}
    prev = str(tmp_path / 'step_1.pd')
    io_save.save(old, prev)
    # a new snapshot dies mid-commit ...
    path = str(tmp_path / 'step_2.pd')
    with chaos.crash_io_save(point, path_substr='step_2') as fault:
        with pytest.raises(chaos.WriterKilled):
            io_save.save(new, path)
    assert fault.fired == 1
    assert os.path.exists(path) == (point == 'pre_manifest')
    assert not os.path.exists(io_save.manifest_path(path))
    assert not io_save.verify_checkpoint(path, require_manifest=True)
    # ... and the previous one still reads back whole
    assert io_save.verify_checkpoint(prev, require_manifest=True)
    assert torch.equal(io_save.load(prev)['w'], old['w'])
    # overwriting in place: a kill before the rename leaves the old bytes
    # and their manifest; after it, the stale manifest refuses the file
    with chaos.crash_io_save(point, path_substr='step_1'):
        with pytest.raises(chaos.WriterKilled):
            io_save.save(new, prev)
    if point == 'pre_rename':
        assert torch.equal(io_save.load(prev)['w'], old['w'])
    else:
        with pytest.raises(io_save.CheckpointCorruptError):
            io_save.load(prev)
    # the fault is gone with its scope: the next save commits
    io_save.save(new, path)
    assert torch.equal(io_save.load(path)['w'], new['w'])


def test_write_bytes_atomic_and_encryption_not_ported(tmp_path):
    """write_bytes_atomic, and encrypted save / load (the name predates
    the port of framework/crypto.py): the round trip, the missing key and
    the wrong key."""
    side = str(tmp_path / 'deep' / 'dir' / 'index.json')
    io_save.write_bytes_atomic(side, b'{"n": 1}')
    with open(side, 'rb') as f:
        assert f.read() == b'{"n": 1}'
    assert os.listdir(os.path.dirname(side)) == ['index.json']
    enc = str(tmp_path / 'e.pd')
    w = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    io_save.save({'w': w}, enc, encryption_key=b'k')
    with open(enc, 'rb') as f:
        assert f.read(8) == b'PTCRYPT1'
    assert io_save.verify_checkpoint(enc, require_manifest=True)
    got = io_save.load(enc, encryption_key=b'k')['w']
    assert got.dtype == torch.bfloat16 and torch.equal(got, w)
    with pytest.raises(ValueError, match='is encrypted'):
        io_save.load(enc)
    with pytest.raises(ValueError, match='wrong key'):
        io_save.load(enc, encryption_key=b'other')
