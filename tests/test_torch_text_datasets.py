"""The port's text datasets, legacy dataset readers and `batch`
(paddle_tpu_torch/text/datasets, dataset/, batch.py) against the JAX
package's, on the miniature archives of tests/test_text_datasets.py in
the reference's on-disk layouts. Both packages parse the same files, and
every sample must be equal, array for array (np.testing.assert_array_equal)
and dict for dict.
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import gzip
import io
import os
import pickle
import struct
import tarfile

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.text.datasets as JD
from paddle_tpu import dataset as jlegacy

import paddle_tpu_torch as tpt
import paddle_tpu_torch.text.datasets as TD
from paddle_tpu_torch import dataset as tlegacy

from test_text_datasets import (_add_text, conll_tgz, imdb_tgz,  # noqa: F401
                                ml_zip, wmt14_tgz, wmt16_tgz)


def _same(a, b):
    """Equal samples: arrays equal in value and dtype, lists and tuples
    element by element, anything else by ==."""
    if isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _same_dataset(t, j):
    assert len(t) == len(j)
    for i in range(len(j)):
        _same(t[i], j[i])


@pytest.mark.parametrize('mode', ['train', 'test'])
@pytest.mark.parametrize('cutoff', [0, 2])
def test_imdb_matches_jax(imdb_tgz, mode, cutoff):  # noqa: F811
    t = TD.Imdb(data_file=imdb_tgz, mode=mode, cutoff=cutoff)
    j = JD.Imdb(data_file=imdb_tgz, mode=mode, cutoff=cutoff)
    assert t.word_idx == j.word_idx
    _same_dataset(t, j)


@pytest.fixture
def housing(tmp_path):
    rng = np.random.RandomState(0)
    raw = np.hstack([rng.standard_normal((50, 13)),
                     rng.uniform(10, 50, (50, 1))])
    f = tmp_path / 'housing.data'
    np.savetxt(f, raw)
    return str(f)


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_uci_housing_matches_jax(housing, mode):
    _same_dataset(TD.UCIHousing(data_file=housing, mode=mode),
                  JD.UCIHousing(data_file=housing, mode=mode))


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_movielens_matches_jax(ml_zip, mode):  # noqa: F811
    t = TD.Movielens(data_file=ml_zip, mode=mode, test_ratio=0.25,
                     rand_seed=1)
    j = JD.Movielens(data_file=ml_zip, mode=mode, test_ratio=0.25,
                     rand_seed=1)
    assert t.categories_dict == j.categories_dict
    assert t.title_dict == j.title_dict
    assert {k: v.value() for k, v in t.user_info.items()} == \
        {k: v.value() for k, v in j.user_info.items()}
    assert repr(t.movie_info[1]) == repr(j.movie_info[1])
    _same_dataset(t, j)


@pytest.mark.parametrize('mode', ['train', 'test'])
def test_wmt14_matches_jax(wmt14_tgz, mode):  # noqa: F811
    t = TD.WMT14(data_file=wmt14_tgz, mode=mode, dict_size=5)
    j = JD.WMT14(data_file=wmt14_tgz, mode=mode, dict_size=5)
    assert t.src_dict == j.src_dict and t.trg_dict == j.trg_dict
    _same_dataset(t, j)


@pytest.mark.parametrize('lang', ['en', 'de'])
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_wmt16_matches_jax(wmt16_tgz, mode, lang):  # noqa: F811
    t = TD.WMT16(data_file=wmt16_tgz, mode=mode, lang=lang, src_dict_size=6)
    j = JD.WMT16(data_file=wmt16_tgz, mode=mode, lang=lang, src_dict_size=6)
    assert t.src_dict == j.src_dict and t.trg_dict == j.trg_dict
    _same_dataset(t, j)


@pytest.mark.parametrize('dicts', [True, False])
def test_conll05_matches_jax(conll_tgz, tmp_path, dicts):  # noqa: F811
    kw = {}
    if dicts:
        for key, text in (('word_dict_file', 'the\ncat\nsat\n<unk>\n'),
                          ('verb_dict_file', 'sat\n'),
                          ('target_dict_file', 'O\nB-V\nI-V\n')):
            path = tmp_path / key
            path.write_text(text)
            kw[key] = str(path)
    _same_dataset(TD.Conll05st(data_file=conll_tgz, **kw),
                  JD.Conll05st(data_file=conll_tgz, **kw))


@pytest.fixture(scope='module')
def ptb_tgz(tmp_path_factory):
    d = tmp_path_factory.mktemp('ptb')
    path = d / 'simple-examples.tgz'
    rng = np.random.RandomState(3)
    words = ['the', 'cat', 'sat', 'on', 'a', 'mat', 'dog', '<unk>', 'ran']

    def text(n):
        return '\n'.join(' '.join(rng.choice(words, rng.randint(1, 9)))
                         for _ in range(n)) + '\n'
    with tarfile.open(path, 'w:gz') as tf:
        _add_text(tf, './simple-examples/data/ptb.train.txt', text(30))
        _add_text(tf, './simple-examples/data/ptb.valid.txt', text(8))
    return str(path)


@pytest.mark.parametrize('data_type', ['NGRAM', 'SEQ'])
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_imikolov_matches_jax(ptb_tgz, data_type, mode):
    kw = dict(data_file=ptb_tgz, data_type=data_type, window_size=3,
              mode=mode, min_word_freq=3)
    t, j = TD.Imikolov(**kw), JD.Imikolov(**kw)
    assert t.word_idx == j.word_idx
    assert len(j) > 0
    _same_dataset(t, j)


def test_fake_datasets_bit_equal():
    _same_dataset(TD.FakeTextDataset(num_samples=6, seq_len=9, seed=4),
                  JD.FakeTextDataset(num_samples=6, seq_len=9, seed=4))
    _same_dataset(TD.FakeLMDataset(num_samples=5, seq_len=7, seed=2),
                  JD.FakeLMDataset(num_samples=5, seq_len=7, seed=2))


def test_missing_archive_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_DATA_HOME', str(tmp_path))
    for cls in ('Imdb', 'UCIHousing', 'Movielens', 'WMT14', 'WMT16',
                'Conll05st', 'Imikolov'):
        with pytest.raises(FileNotFoundError) as te:
            getattr(TD, cls)()
        with pytest.raises(FileNotFoundError) as je:
            getattr(JD, cls)()
        assert str(te.value) == str(je.value)
        assert str(tmp_path) in str(te.value)
    assert sorted(TD.__all__) == sorted(JD.__all__)
    assert tpt.text.Imdb is TD.Imdb


def _rows(reader):
    return list(reader())


def test_legacy_text_readers_match_jax(housing, imdb_tgz,  # noqa: F811
                                       ml_zip):  # noqa: F811
    for split in ('train', 'test'):
        _same(_rows(getattr(tlegacy.uci_housing, split)(data_file=housing)),
              _rows(getattr(jlegacy.uci_housing, split)(data_file=housing)))
        _same(_rows(getattr(tlegacy.movielens, split)(data_file=ml_zip)),
              _rows(getattr(jlegacy.movielens, split)(data_file=ml_zip)))
    wd = tlegacy.imdb.word_dict(data_file=imdb_tgz, cutoff=1)
    assert wd == jlegacy.imdb.word_dict(data_file=imdb_tgz, cutoff=1)
    for split in ('train', 'test'):
        _same(_rows(getattr(tlegacy.imdb, split)(wd, data_file=imdb_tgz)),
              _rows(getattr(jlegacy.imdb, split)(wd, data_file=imdb_tgz)))
    assert tlegacy.__all__ == jlegacy.__all__


def test_legacy_vision_readers_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    root = str(tmp_path)
    images = rng.randint(0, 256, (4, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 4).astype(np.uint8)
    paths = []
    for name, magic, arr in (('images-idx3', 2051, images),
                             ('labels-idx1', 2049, labels)):
        path = os.path.join(root, 't10k-%s-ubyte.gz' % name)
        with gzip.open(path, 'wb') as f:
            f.write(struct.pack('>I', magic) +
                    struct.pack('>' + 'I' * arr.ndim, *arr.shape))
            f.write(arr.tobytes())
        paths.append(path)
    _same(_rows(tlegacy.mnist.test(*paths)), _rows(jlegacy.mnist.test(*paths)))

    cifar = os.path.join(root, 'cifar-10-python.tar.gz')
    with tarfile.open(cifar, 'w:gz') as tf:
        for name in ('data_batch_1', 'test_batch'):
            blob = pickle.dumps({b'data': rng.randint(
                0, 256, (3, 3072)).astype(np.uint8),
                b'labels': list(rng.randint(0, 10, 3))})
            info = tarfile.TarInfo('cifar-10-batches-py/' + name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    for fn in ('train10', 'test10'):
        _same(_rows(getattr(tlegacy.cifar, fn)(data_file=cifar)),
              _rows(getattr(jlegacy.cifar, fn)(data_file=cifar)))

    for i in range(3):
        with open(os.path.join(root, 'part-%d.txt' % i), 'w') as f:
            f.write('line %d a\nline %d b\n' % (i, i))
    pattern = os.path.join(root, 'part-*.txt')
    for tid in (0, 1):
        assert _rows(tlegacy.common.cluster_files_reader(pattern, 2, tid)) \
            == _rows(jlegacy.common.cluster_files_reader(pattern, 2, tid))


@pytest.mark.parametrize('drop_last', [False, True])
def test_batch_matches_jax(housing, drop_last):
    tb = tpt.batch(tlegacy.uci_housing.train(data_file=housing), 7,
                   drop_last=drop_last)
    jb = paddle.batch(jlegacy.uci_housing.train(data_file=housing), 7,
                      drop_last=drop_last)
    got, want = _rows(tb), _rows(jb)
    assert [len(b) for b in got] == [len(b) for b in want]
    assert len(got) == (5 if drop_last else 6)
    _same(got, want)
