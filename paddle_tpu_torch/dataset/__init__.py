"""Legacy reader-generator dataset API (reference: python/paddle/dataset/
— uci_housing.train(), imdb.word_dict(), mnist.train(), ... each returning
a no-arg callable yielding samples). Thin adapters over the class-based
datasets in paddle_tpu_torch.vision.datasets / .text.datasets (the port's
copy of paddle_tpu/dataset/__init__.py).
"""
import types as _types

__all__ = ['uci_housing', 'imdb', 'movielens', 'mnist', 'cifar', 'common']


def _reader_from(dataset_factory):
    def reader():
        ds = dataset_factory()
        for i in range(len(ds)):
            yield tuple(ds[i]) if isinstance(ds[i], (tuple, list)) \
                else (ds[i],)
    return reader


def _module(name, **fns):
    m = _types.ModuleType(__name__ + '.' + name)
    for k, v in fns.items():
        setattr(m, k, v)
    return m


def _uci_train(data_file=None):
    from ..text.datasets import UCIHousing
    return _reader_from(lambda: UCIHousing(data_file=data_file,
                                           mode='train'))


def _uci_test(data_file=None):
    from ..text.datasets import UCIHousing
    return _reader_from(lambda: UCIHousing(data_file=data_file,
                                           mode='test'))


uci_housing = _module('uci_housing', train=_uci_train, test=_uci_test)


def _imdb_word_dict(data_file=None, cutoff=150):
    from ..text.datasets import Imdb
    return Imdb(data_file=data_file, mode='train', cutoff=cutoff).word_idx


def _imdb_train(word_idx=None, data_file=None):
    from ..text.datasets import Imdb
    return _reader_from(lambda: Imdb(data_file=data_file, mode='train',
                                     word_idx=word_idx))


def _imdb_test(word_idx=None, data_file=None):
    from ..text.datasets import Imdb
    return _reader_from(lambda: Imdb(data_file=data_file, mode='test',
                                     word_idx=word_idx))


imdb = _module('imdb', word_dict=_imdb_word_dict, train=_imdb_train,
               test=_imdb_test)


def _ml_train(data_file=None):
    from ..text.datasets import Movielens
    return _reader_from(lambda: Movielens(data_file=data_file,
                                          mode='train'))


def _ml_test(data_file=None):
    from ..text.datasets import Movielens
    return _reader_from(lambda: Movielens(data_file=data_file, mode='test'))


movielens = _module('movielens', train=_ml_train, test=_ml_test)


def _mnist_reader(mode):
    def factory(image_path=None, label_path=None):
        from ..vision.datasets import MNIST
        return _reader_from(lambda: MNIST(image_path=image_path,
                                          label_path=label_path, mode=mode))
    return factory


mnist = _module('mnist', train=_mnist_reader('train'),
                test=_mnist_reader('test'))


def _cifar_reader(cls_name, mode):
    def factory(data_file=None):
        from ..vision import datasets as vd
        cls = getattr(vd, cls_name)
        return _reader_from(lambda: cls(data_file=data_file, mode=mode))
    return factory


cifar = _module('cifar',
                train10=_cifar_reader('Cifar10', 'train'),
                test10=_cifar_reader('Cifar10', 'test'),
                train100=_cifar_reader('Cifar100', 'train'),
                test100=_cifar_reader('Cifar100', 'test'))


def _cluster_files_reader(files_pattern, trainer_count, trainer_id):
    """reference dataset/common.py cluster_files_reader parity."""
    import glob

    def reader():
        files = sorted(glob.glob(files_pattern))
        my = files[trainer_id::trainer_count]
        for fn in my:
            with open(fn) as f:
                for line in f:
                    yield line.rstrip('\n')
    return reader


common = _module('common', cluster_files_reader=_cluster_files_reader)
