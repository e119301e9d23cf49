"""Host-side preconditions of the flash kernels' TMA-fed 16-bit paths
(paddle_tpu_torch/csrc/sm90_async.cuh, flash_fwd.cu, flash_bwd.cu).

A TMA tensor map needs a 16-byte-aligned base and strides that are
multiples of 16 bytes; `_rows_aligned` guarantees both before any launch,
without copying the q/k/v views of a packed projection. The kernels
themselves run only on the card (chip_smoke.py holds them against their
plain versions); here the CPU checks what the host side promises them and
that the sources keep the contract the build and the wrappers rely on."""
import os
import re
import shutil

import pytest
import torch

from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as tfa

CSRC = _build.CSRC


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


@pytest.mark.parametrize('d', [64, 128])
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('which', [0, 1, 2])
def test_packed_projection_views_go_to_the_kernel_uncopied(which, dtype, d):
    # q, k, v sliced out of one [b, n, 3, h, d] projection, as the GPT
    # attention hands them over: (batch, head, row) strides of
    # (n * 3hd, d, 3hd) elements, every one a multiple of 16 bytes
    qkv = torch.zeros(2, 7, 3, 4, d, dtype=dtype)
    view = qkv[:, :, which].transpose(1, 2)
    assert view.stride() == (7 * 3 * 4 * d, d, 3 * 4 * d, 1)
    assert tfa._rows_aligned(view) is view


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_output_layout_views_go_to_the_kernel_uncopied(dtype):
    # the [b, n, h, d] memory layout the wrappers allocate o and the
    # gradients in, seen as [b, h, n, d]
    t = torch.zeros(2, 9, 3, 64, dtype=dtype).transpose(1, 2)
    assert tfa._rows_aligned(t) is t


def _check_copied(view):
    fixed = tfa._rows_aligned(view)
    assert fixed is not view
    assert fixed.is_contiguous()
    assert fixed.data_ptr() % 16 == 0
    assert torch.equal(fixed, view)


def test_base_off_by_one_element_is_copied():
    buf = torch.arange(2 * 4 * 5 * 64 + 1, dtype=torch.float32).to(
        torch.bfloat16)
    view = buf[1:].view(2, 4, 5, 64)
    assert view.data_ptr() % 16 == 2
    _check_copied(view)


def test_row_stride_off_sixteen_bytes_is_copied():
    # rows 68 elements (136 bytes) apart
    view = torch.randn(2, 4, 5, 68).to(torch.bfloat16)[..., :64]
    assert view.stride(2) * 2 % 16 == 8
    _check_copied(view)


def test_head_stride_off_sixteen_bytes_is_copied():
    # heads 324 elements (648 bytes) apart, rows and batches aligned
    buf = torch.randn(2 * 4 * 324 + 8).to(torch.float16)
    view = torch.as_strided(buf, (2, 4, 5, 64), (4 * 324 + 8, 324, 64, 1))
    assert view.stride(1) * 2 % 16 == 8
    _check_copied(view)


def test_batch_stride_off_sixteen_bytes_is_copied():
    buf = torch.randn(2 * 4 * 5 * 64 + 4).to(torch.bfloat16)
    view = torch.as_strided(buf, (2, 4, 5, 64), (4 * 5 * 64 + 4, 5 * 64, 64,
                                                 1))
    assert view.stride(0) * 2 % 16 == 8
    _check_copied(view)


def test_non_contiguous_last_dimension_is_copied():
    view = torch.randn(2, 4, 64, 5).to(torch.bfloat16).transpose(-1, -2)
    assert view.stride(-1) != 1
    _check_copied(view)


@pytest.mark.parametrize('source', ['flash_fwd.cu', 'flash_bwd.cu'])
def test_sources_include_the_shared_hopper_header(source):
    assert '#include "sm90_async.cuh"' in _read(source)


@pytest.mark.parametrize('primitive', [
    'wgmma.mma_async.sync.aligned.m64n',
    'wgmma.fence.sync.aligned',
    'wgmma.commit_group.sync.aligned',
    'wgmma.wait_group.sync.aligned',
    'cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx',
    'mbarrier.try_wait.parity.shared::cta.b64',
    'mbarrier.arrive.expect_tx.shared::cta.b64',
    'setmaxnreg.dec.sync.aligned.u32',
    'setmaxnreg.inc.sync.aligned.u32',
    'CU_TENSOR_MAP_SWIZZLE_128B',
    'cuTensorMapEncodeTiled',
])
def test_hopper_header_holds_the_primitives(primitive):
    assert primitive in _read('sm90_async.cuh')


def test_tensor_maps_need_no_lcuda_link():
    # the encoder is looked up through the CUDA runtime, so the build adds
    # no -lcuda
    text = _read('sm90_async.cuh')
    assert 'cudaGetDriverEntryPoint' in text
    assert not any(flag.startswith('-lcuda') for flag in _build.NVCC_FLAGS)


@pytest.mark.parametrize('source, gone, kept', [
    ('flash_fwd.cu', 'flash_fwd_mma_kernel', 'flash_fwd_tma_kernel'),
    ('flash_bwd.cu', 'flash_bwd_kv_mma_kernel', 'flash_bwd_kv_tma_kernel'),
    ('flash_bwd.cu', 'flash_bwd_dq_mma_kernel', 'flash_bwd_dq_tma_kernel'),
])
def test_redesigned_kernels_replace_their_mma_sync_bodies(source, gone,
                                                          kept):
    text = _read(source)
    assert gone not in text
    assert kept in text


@pytest.mark.parametrize('entry', ['flash_fwd', 'flash_fwd_long'])
def test_forward_c_entries_keep_their_arguments(entry):
    text = _read('flash_fwd.cu')
    m = re.search(r'extern "C" int %s\(([^)]*)\)' % entry, text)
    assert m is not None
    args = [a.strip() for a in m.group(1).split(',')]
    # q, k, v, o, lse; dtype, b, h, n, m, d; 12 strides; scale, causal, stream
    assert len(args) == 26
    assert args[5] == 'int dtype' and args[-1] == 'void* stream'


def test_backward_c_entries_keep_their_arguments():
    text = _read('flash_bwd.cu')
    m = re.search(r'#define FLASH_BWD_ENTRY\(name, pass\)\s*\\\s*'
                  r'extern "C" int name\(([^)]*)\)', text)
    assert m is not None
    args = [a.strip(' \\\n') for a in m.group(1).split(',')]
    assert len(args) == 20
    assert args[10] == 'int dtype' and args[16] == 'const long long* strides'


def test_build_hash_covers_the_shared_hopper_header(tmp_path, monkeypatch):
    for name in os.listdir(CSRC):
        if name.endswith(('.cu', '.cuh')):
            shutil.copy(os.path.join(CSRC, name), tmp_path)
    monkeypatch.setattr(_build, 'CSRC', str(tmp_path))
    before = [_build._target(n)[1] for n in ('flash_fwd', 'flash_bwd')]
    with open(tmp_path / 'sm90_async.cuh', 'a') as f:
        f.write('\n// edited\n')
    after = [_build._target(n)[1] for n in ('flash_fwd', 'flash_bwd')]
    assert all(a != b for a, b in zip(after, before))
