"""NLP datasets (reference: python/paddle/text/datasets/ — imdb.py,
conll05.py, movielens.py, uci_housing.py, wmt14.py, wmt16.py; the port's
copy of paddle_tpu/text/datasets/__init__.py, on the port's
io.dataset.Dataset). Samples are numpy arrays; a DataLoader moves them.

Local files only: every loader parses the reference's standard
archive layout from a LOCAL file (`data_file=`, or
$PADDLE_TPU_DATA_HOME/<name>/); there is no downloader. `FakeTextDataset` /
`FakeLMDataset` provide deterministic synthetic data for tests/benches.
"""
import gzip
import io
import os
import re
import tarfile
import zipfile

import numpy as np

from ...io.dataset import Dataset

__all__ = [
    'Imikolov','Imdb', 'Conll05st', 'Movielens', 'UCIHousing', 'WMT14', 'WMT16',
           'FakeTextDataset', 'FakeLMDataset', 'MovieInfo', 'UserInfo']


def _data_home():
    return os.environ.get('PADDLE_TPU_DATA_HOME',
                          os.path.expanduser('~/.cache/paddle_tpu'))


def _resolve(data_file, *default_parts):
    path = data_file or os.path.join(_data_home(), *default_parts)
    if not os.path.exists(path):
        raise FileNotFoundError(
            '%s not found (zero-egress env: place the standard archive '
            'there or pass data_file=)' % path)
    return path


class FakeTextDataset(Dataset):
    """Deterministic synthetic token-classification data."""

    def __init__(self, num_samples=1024, seq_len=128, vocab_size=30522,
                 num_classes=2, seed=0):
        rng = np.random.RandomState(seed)
        self.tokens = rng.randint(0, vocab_size, size=(num_samples, seq_len))
        self.labels = rng.randint(0, num_classes, size=num_samples)

    def __getitem__(self, idx):
        return (self.tokens[idx].astype(np.int64),
                np.asarray(self.labels[idx], np.int64))

    def __len__(self):
        return len(self.labels)


class FakeLMDataset(Dataset):
    """Synthetic causal-LM data: input ids + shifted labels."""

    def __init__(self, num_samples=1024, seq_len=512, vocab_size=50304,
                 seed=0):
        self.num_samples = num_samples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self._seeds = np.random.RandomState(seed).randint(
            0, 2 ** 31 - 1, size=num_samples)

    def __getitem__(self, idx):
        rng = np.random.RandomState(self._seeds[idx])
        ids = rng.randint(0, self.vocab_size, size=self.seq_len + 1)
        return ids[:-1].astype(np.int64), ids[1:].astype(np.int64)

    def __len__(self):
        return self.num_samples


class UCIHousing(Dataset):
    """Boston housing regression (reference text/datasets/uci_housing.py:
    14 columns, feature normalization, 80/20 train split)."""

    def __init__(self, data_file=None, mode='train', download=False):
        path = _resolve(data_file, 'uci_housing', 'housing.data')
        raw = np.loadtxt(path).astype(np.float32)
        feats = raw[:, :-1]
        feats = (feats - feats.mean(0)) / (feats.std(0) + 1e-8)
        n_train = int(0.8 * len(raw))
        if mode == 'train':
            self.x, self.y = feats[:n_train], raw[:n_train, -1:]
        else:
            self.x, self.y = feats[n_train:], raw[n_train:, -1:]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


_IMDB_TOKEN = re.compile(r"[a-z0-9']+")


class Imdb(Dataset):
    """IMDB sentiment (reference text/datasets/imdb.py): parses the
    aclImdb_v1.tar.gz layout (aclImdb/<mode>/{pos,neg}/*.txt). The
    frequency-cutoff word dict is built over train AND test docs
    (reference imdb.py word-dict pattern covers both splits); pass
    word_idx= to reuse an external dict. Yields (ids, label), label
    0=pos 1=neg (reference convention)."""

    def __init__(self, data_file=None, mode='train', cutoff=150,
                 word_idx=None, download=False):
        path = _resolve(data_file, 'imdb', 'aclImdb_v1.tar.gz')
        # ONE decompression pass: gzip has no random access, so cache the
        # token lists of all needed members up front
        pat = re.compile(r'aclImdb/(train|test)/(pos|neg)/.*\.txt$')
        by_member = {}
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if m.isfile() and pat.match(m.name):
                    text = tf.extractfile(m).read().decode(
                        'utf-8', 'ignore').lower()
                    by_member[m.name] = _IMDB_TOKEN.findall(text)
        self.word_idx = word_idx if word_idx is not None \
            else self._build_word_dict(by_member.values(), cutoff)
        self.docs, self.labels = [], []
        # reference order: pos first (label 0), then neg (label 1)
        unk = self.word_idx['<unk>']
        for label, sub in enumerate(('pos', 'neg')):
            prefix = 'aclImdb/%s/%s/' % (mode, sub)
            for name in sorted(by_member):
                if name.startswith(prefix):
                    self.docs.append(np.asarray(
                        [self.word_idx.get(t, unk)
                         for t in by_member[name]], np.int64))
                    self.labels.append(label)

    @staticmethod
    def _build_word_dict(token_lists, cutoff):
        freq = {}
        for tokens in token_lists:
            for t in tokens:
                freq[t] = freq.get(t, 0) + 1
        words = [w for w, c in freq.items() if c > cutoff]
        # deterministic: sort by (-freq, word), ids from 0; <unk> last
        words.sort(key=lambda w: (-freq[w], w))
        word_idx = {w: i for i, w in enumerate(words)}
        word_idx['<unk>'] = len(words)
        return word_idx

    def __getitem__(self, idx):
        return self.docs[idx], np.asarray(self.labels[idx], np.int64)

    def __len__(self):
        return len(self.labels)


class Conll05st(Dataset):
    """CoNLL-2005 SRL (reference text/datasets/conll05.py): parses the
    conll05st-tests tarball (words/props files gzipped inside), emitting
    per-verb samples (word_ids, ctx_n2/n1/0/p1/p2, verb_id, mark, labels)
    keyed by user-supplied word/verb/target dict files."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None,
                 download=False):
        path = _resolve(data_file, 'conll05st', 'conll05st-tests.tar.gz')
        self.word_dict = self._load_dict(word_dict_file)
        self.verb_dict = self._load_dict(verb_dict_file)
        self.label_dict = self._load_dict(target_dict_file)
        self._auto_dicts = {}
        words_name = 'conll05st-release/test.wsj/words/test.wsj.words.gz'
        props_name = 'conll05st-release/test.wsj/props/test.wsj.props.gz'
        with tarfile.open(path) as tf:
            words_txt = gzip.decompress(
                tf.extractfile(words_name).read()).decode()
            props_txt = gzip.decompress(
                tf.extractfile(props_name).read()).decode()
        self.samples = list(self._parse(words_txt, props_txt))

    @staticmethod
    def _load_dict(f):
        if f is None:
            return None
        with open(f) as fh:
            return {line.strip(): i for i, line in enumerate(fh)
                    if line.strip()}

    @staticmethod
    def _sentences(words_txt, props_txt):
        sent_w, sent_p = [], []
        wlines = words_txt.splitlines()
        plines = props_txt.splitlines()
        for wl, pl in zip(wlines, plines):
            if not wl.strip():
                if sent_w:
                    yield sent_w, sent_p
                sent_w, sent_p = [], []
                continue
            sent_w.append(wl.split()[0])
            sent_p.append(pl.split())
        if sent_w:
            yield sent_w, sent_p

    def _parse(self, words_txt, props_txt):
        for words, props in self._sentences(words_txt, props_txt):
            if not props or len(props[0]) < 2:
                continue
            n_verbs = len(props[0]) - 1
            verbs = [p[0] for p in props if p[0] != '-']
            for v in range(n_verbs):
                # column v+1 holds this predicate's bracketed SRL tags
                labels = self._col_to_bio([p[v + 1] for p in props])
                verb_word = verbs[v] if v < len(verbs) else '-'
                yield self._featurize(words, verb_word, labels)

    # dicts built deterministically from the data when no dict files are
    # given (first-seen order) — never from hash(), which varies per
    # process under PYTHONHASHSEED randomization
    def _auto_id(self, kind, w):
        d = self._auto_dicts.setdefault(kind, {})
        if w not in d:
            d[w] = len(d)
        return d[w]

    @staticmethod
    def _col_to_bio(col):
        out, cur = [], None
        for tag in col:
            m = re.match(r'\(([^*()]+)\*', tag)
            if m:
                cur = m.group(1)
                out.append('B-' + cur)
            elif cur is not None:
                out.append('I-' + cur)
            else:
                out.append('O')
            if ')' in tag:
                cur = None
        return out

    def _featurize(self, words, verb, labels):
        lower = [w.lower() for w in words]
        # the predicate position comes from the LABEL column (B-V), not a
        # surface-word match: props column 0 holds lemmas which often
        # differ from the surface form (reference uses the label column)
        try:
            v_pos = labels.index('B-V')
        except ValueError:
            v_pos = 0
        n = len(words)

        def ctx(off):
            i = min(max(v_pos + off, 0), n - 1)
            return lower[i]

        def wid(w, d, kind):
            if d is None:
                return self._auto_id(kind, w)
            return d.get(w, d.get('<unk>', len(d)))

        word_ids = np.asarray([wid(w, self.word_dict, 'word')
                               for w in lower], np.int64)
        ctx_ids = [np.asarray([wid(ctx(off), self.word_dict, 'word')] * n,
                              np.int64)
                   for off in (-2, -1, 0, 1, 2)]
        verb_id = np.asarray([wid(verb.lower(), self.verb_dict, 'verb')] * n,
                             np.int64)
        mark = np.zeros(n, np.int64)
        mark[v_pos] = 1
        label_ids = np.asarray([wid(l, self.label_dict, 'label')
                                for l in labels], np.int64)
        return (word_ids, *ctx_ids, verb_id, mark, label_ids)

    def __getitem__(self, idx):
        return self.samples[idx]

    def __len__(self):
        return len(self.samples)


class MovieInfo:
    def __init__(self, index, categories, title):
        self.index = int(index)
        self.categories = categories
        self.title = title

    def value(self, categories_dict, movie_title_dict):
        return [self.index,
                [categories_dict[c] for c in self.categories],
                [movie_title_dict[w.lower()] for w in self.title.split()]]

    def __repr__(self):
        return '<MovieInfo id(%d), title(%s), categories(%s)>' % (
            self.index, self.title, self.categories)


class UserInfo:
    def __init__(self, index, gender, age, job_id):
        self.index = int(index)
        self.is_male = gender == 'M'
        self.age = int(age)
        self.job_id = int(job_id)

    def value(self):
        return [self.index, 0 if self.is_male else 1, self.age, self.job_id]

    def __repr__(self):
        return '<UserInfo id(%d), gender(%s), age(%d), job(%d)>' % (
            self.index, 'M' if self.is_male else 'F', self.age, self.job_id)


class Movielens(Dataset):
    """MovieLens-1M ratings (reference text/datasets/movielens.py): parses
    ml-1m.zip ({movies,users,ratings}.dat with :: separators), yields
    [user features..., movie features..., rating]."""

    def __init__(self, data_file=None, mode='train', test_ratio=0.1,
                 rand_seed=0, download=False):
        path = _resolve(data_file, 'movielens', 'ml-1m.zip')
        self.movie_info, self.categories_dict, self.title_dict = \
            self._load_movies(path)
        self.user_info = self._load_users(path)
        rng = np.random.RandomState(rand_seed)
        self.data = []
        with zipfile.ZipFile(path) as zf:
            name = [n for n in zf.namelist()
                    if n.endswith('ratings.dat')][0]
            with io.TextIOWrapper(zf.open(name),
                                  encoding='latin-1') as f:
                for line in f:
                    uid, mid, rating, _ = line.strip().split('::')
                    uid, mid = int(uid), int(mid)
                    if uid not in self.user_info or \
                            mid not in self.movie_info:
                        continue
                    is_test = rng.rand() < test_ratio
                    if (mode == 'test') == is_test:
                        usr = self.user_info[uid].value()
                        mov = self.movie_info[mid].value(
                            self.categories_dict, self.title_dict)
                        self.data.append(usr + mov + [float(rating)])

    @staticmethod
    def _load_movies(path):
        movie_info, categories, titles = {}, {}, {}
        with zipfile.ZipFile(path) as zf:
            name = [n for n in zf.namelist() if n.endswith('movies.dat')][0]
            with io.TextIOWrapper(zf.open(name), encoding='latin-1') as f:
                for line in f:
                    mid, title, cats = line.strip().split('::')
                    cats = cats.split('|')
                    title = re.sub(r'\(\d{4}\)$', '', title).strip()
                    for c in cats:
                        categories.setdefault(c, len(categories))
                    for w in title.split():
                        titles.setdefault(w.lower(), len(titles))
                    movie_info[int(mid)] = MovieInfo(mid, cats, title)
        return movie_info, categories, titles

    @staticmethod
    def _load_users(path):
        users = {}
        with zipfile.ZipFile(path) as zf:
            name = [n for n in zf.namelist() if n.endswith('users.dat')][0]
            with io.TextIOWrapper(zf.open(name), encoding='latin-1') as f:
                for line in f:
                    uid, gender, age, job, _ = line.strip().split('::')
                    users[int(uid)] = UserInfo(uid, gender, age, job)
        return users

    def __getitem__(self, idx):
        return self.data[idx]

    def __len__(self):
        return len(self.data)


class _WMTBase(Dataset):
    START = '<s>'
    END = '<e>'
    UNK = '<unk>'

    def _build_ids(self, src_lines, trg_lines, src_dict, trg_dict):
        unk_s = src_dict[self.UNK]
        unk_t = trg_dict[self.UNK]
        self.src_ids, self.trg_ids, self.trg_ids_next = [], [], []
        for s, t in zip(src_lines, trg_lines):
            src = [src_dict.get(w, unk_s) for w in s.split()]
            trg_words = t.split()
            trg = [trg_dict[self.START]] + \
                [trg_dict.get(w, unk_t) for w in trg_words]
            trg_next = [trg_dict.get(w, unk_t) for w in trg_words] + \
                [trg_dict[self.END]]
            self.src_ids.append(np.asarray(src, np.int64))
            self.trg_ids.append(np.asarray(trg, np.int64))
            self.trg_ids_next.append(np.asarray(trg_next, np.int64))

    def __getitem__(self, idx):
        return (self.src_ids[idx], self.trg_ids[idx],
                self.trg_ids_next[idx])

    def __len__(self):
        return len(self.src_ids)


class WMT14(_WMTBase):
    """WMT14 en→fr (reference text/datasets/wmt14.py): parses the
    wmt14.tgz layout (<mode>/<name>.src|.trg parallel files + dict files
    train.dict.src/trg of the top dict_size words)."""

    def __init__(self, data_file=None, mode='train', dict_size=30000,
                 download=False):
        path = _resolve(data_file, 'wmt14', 'wmt14.tgz')
        with tarfile.open(path) as tf:
            names = tf.getnames()
            self.src_dict = self._read_dict(tf, names, 'src', dict_size)
            self.trg_dict = self._read_dict(tf, names, 'trg', dict_size)
            src_lines, trg_lines = [], []
            for n in sorted(names):
                if ('/%s/' % mode) in n and n.endswith('.src'):
                    src_lines += tf.extractfile(n).read().decode(
                        'utf-8', 'ignore').splitlines()
                    trg = n[:-4] + '.trg'
                    trg_lines += tf.extractfile(trg).read().decode(
                        'utf-8', 'ignore').splitlines()
        self._build_ids(src_lines, trg_lines, self.src_dict, self.trg_dict)

    def _read_dict(self, tf, names, side, dict_size):
        dict_name = [n for n in names
                     if n.endswith('train.dict.%s' % side)]
        d = {self.START: 0, self.END: 1, self.UNK: 2}
        if dict_name:
            words = tf.extractfile(dict_name[0]).read().decode(
                'utf-8', 'ignore').splitlines()
            for w in words:
                w = w.strip()
                if w and w not in d and len(d) < dict_size:
                    d[w] = len(d)
        return d


class WMT16(_WMTBase):
    """WMT16 en↔de (reference text/datasets/wmt16.py): parses wmt16.tar.gz
    (wmt16/{train,test,val}.{src_lang}-{trg_lang} pair files +
    vocab_{lang}.txt), building dicts of size src/trg_dict_size."""

    def __init__(self, data_file=None, mode='train', src_dict_size=-1,
                 trg_dict_size=-1, lang='en', download=False):
        path = _resolve(data_file, 'wmt16', 'wmt16.tar.gz')
        trg_lang = 'de' if lang == 'en' else 'en'
        with tarfile.open(path) as tf:
            names = tf.getnames()
            self.src_dict = self._read_vocab(tf, names, lang, src_dict_size)
            self.trg_dict = self._read_vocab(tf, names, trg_lang,
                                             trg_dict_size)
            pair = [n for n in names
                    if n.endswith('wmt16/%s' % mode)
                    or n.endswith('wmt16/%s.%s-%s' % (mode, lang, trg_lang))]
            src_lines, trg_lines = [], []
            # pair files are 'en<TAB>de': column 0 is English, so for
            # lang='de' the source is column 1 (reference wmt16 src_col
            # swap)
            src_col = 0 if lang == 'en' else 1
            if pair:
                for line in tf.extractfile(pair[0]).read().decode(
                        'utf-8', 'ignore').splitlines():
                    parts = line.split('\t')
                    if len(parts) == 2:
                        src_lines.append(parts[src_col])
                        trg_lines.append(parts[1 - src_col])
        self._build_ids(src_lines, trg_lines, self.src_dict, self.trg_dict)

    def _read_vocab(self, tf, names, lang, size):
        d = {self.START: 0, self.END: 1, self.UNK: 2}
        vocab = [n for n in names if n.endswith('vocab_%s.txt' % lang)]
        if vocab:
            for w in tf.extractfile(vocab[0]).read().decode(
                    'utf-8', 'ignore').splitlines():
                w = w.strip()
                if w and w not in d and (size < 0 or len(d) < size):
                    d[w] = len(d)
        return d


class Imikolov(Dataset):
    """PTB n-gram dataset (reference text/datasets/imikolov.py over
    simple-examples.tgz ./data/ptb.{train,valid}.txt): builds the word
    dict from train+valid, yields n-grams ('NGRAM' type) or (src, trg)
    sequence pairs ('SEQ')."""

    def __init__(self, data_file=None, data_type='NGRAM', window_size=5,
                 mode='train', min_word_freq=50, download=False):
        assert data_type in ('NGRAM', 'SEQ')
        path = _resolve(data_file, 'imikolov', 'simple-examples.tgz')
        member = 'ptb.%s.txt' % ('train' if mode == 'train' else 'valid')
        texts = {}
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if m.name.endswith(('ptb.train.txt', 'ptb.valid.txt')):
                    texts[m.name] = tf.extractfile(m).read().decode(
                        'utf-8', 'ignore')
        freq = {}
        for body in texts.values():
            for w in body.split():
                freq[w] = freq.get(w, 0) + 1
        words = sorted((w for w, c in freq.items()
                        if c >= min_word_freq and w != '<unk>'),
                       key=lambda w: (-freq[w], w))
        self.word_idx = {w: i for i, w in enumerate(words)}
        self.word_idx['<unk>'] = len(self.word_idx)
        self.word_idx.setdefault('<s>', len(self.word_idx))
        self.word_idx.setdefault('<e>', len(self.word_idx))
        unk = self.word_idx['<unk>']

        body = next((t for n, t in texts.items() if n.endswith(member)),
                    '')
        self.data = []
        for line in body.splitlines():
            toks = ['<s>'] + line.split() + ['<e>']
            ids = [self.word_idx.get(w, unk) for w in toks]
            if data_type == 'NGRAM':
                if len(ids) >= window_size:
                    for i in range(window_size, len(ids) + 1):
                        self.data.append(
                            np.asarray(ids[i - window_size:i], np.int64))
            else:
                if len(ids) > 2:
                    self.data.append((np.asarray(ids[:-1], np.int64),
                                      np.asarray(ids[1:], np.int64)))

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]
