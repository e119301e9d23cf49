"""Dataset for PS training (counterpart of paddle_tpu/distributed/ps/
dataset.py, the same code; reference: framework/data_set.h:43 DatasetImpl,
data_feed.h:208 MultiSlotDataFeed, python paddle.distributed.fleet Dataset).

File-sharded MultiSlot ingestion: files are parsed (native datafeed.cc
parser when available) by loader threads into an in-memory instance pool,
then batches flow through a bounded channel (framework/channel.h analog)
that trainer worker threads drain — the RunFromDataset feeding model.
"""
import glob as _glob
import queue
import threading

import numpy as np

from ...native.datafeed import parse_multislot

__all__ = ['MultiSlotDataset', 'BoxPSDataset']


class MultiSlotDataset:
    """use_var order defines the slot layout: [(name, 'int64'|'float'), ...]
    with by convention the LAST float slot being the label (the reference
    encodes this in trainer_desc; here it is explicit via label_slot)."""

    def __init__(self):
        self._filelist = []
        self._batch_size = 32
        self._n_load_threads = 1
        self._slots = []
        self._pool = []
        self._lock = threading.Lock()
        self._channel = None
        self._drop_last = False

    # -- reference Dataset API ------------------------------------------------
    def set_filelist(self, files):
        out = []
        for f in files:
            hits = sorted(_glob.glob(f))
            out.extend(hits if hits else [f])
        self._filelist = out

    def set_batch_size(self, b):
        self._batch_size = int(b)

    def set_thread(self, n):
        self._n_load_threads = max(int(n), 1)

    def set_use_var(self, slots):
        """slots: [(name, 'int64'|'float'), ...]."""
        self._slots = [(n, 'float' if t.startswith('float') else 'int64')
                       for n, t in slots]

    def load_into_memory(self):
        """Parse every file into the instance pool (InMemoryDataFeed)."""
        types = [t if t == 'float' else 'int' for _, t in self._slots]
        files = list(self._filelist)
        idx = {'i': 0}

        def loader():
            while True:
                with self._lock:
                    if idx['i'] >= len(files):
                        return
                    fn = files[idx['i']]
                    idx['i'] += 1
                with open(fn) as f:
                    text = f.read()
                slots, n_inst = parse_multislot(text, types)
                insts = []
                for i in range(n_inst):
                    inst = []
                    for (vals, offs) in slots:
                        inst.append(vals[offs[i]:offs[i + 1]])
                    insts.append(inst)
                with self._lock:
                    self._pool.extend(insts)

        threads = [threading.Thread(target=loader)
                   for _ in range(self._n_load_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def local_shuffle(self, seed=0):
        rng = np.random.RandomState(seed)
        with self._lock:
            rng.shuffle(self._pool)

    global_shuffle = local_shuffle  # single-node analog

    def get_memory_data_size(self):
        return len(self._pool)

    # -- channel --------------------------------------------------------------
    def start_channel(self, epochs=1):
        """Fill a bounded channel with batches; returns the channel.
        A batch is {slot_name: (values, offsets)} CSR per sparse slot and
        a dense np array per float slot, plus '__size__'."""
        self._channel = queue.Queue(maxsize=64)

        def feeder():
            for _ in range(epochs):
                b = self._batch_size
                n = len(self._pool)
                end = (n // b) * b if self._drop_last else n
                for lo in range(0, end, b):
                    chunk = self._pool[lo:lo + b]
                    if not chunk:
                        continue
                    self._channel.put(self._make_batch(chunk))
            self._channel.put(None)

        threading.Thread(target=feeder, daemon=True).start()
        return self._channel

    def _make_batch(self, chunk):
        batch = {'__size__': len(chunk)}
        for s, (name, t) in enumerate(self._slots):
            vals = [inst[s] for inst in chunk]
            if t == 'float':
                batch[name] = np.asarray(
                    [v[0] if len(v) else 0.0 for v in vals], np.float32)
            else:
                flat = np.concatenate(vals) if vals else \
                    np.zeros(0, np.int64)
                offs = np.zeros(len(vals) + 1, np.int64)
                np.cumsum([len(v) for v in vals], out=offs[1:])
                batch[name] = (flat.astype(np.int64), offs)
        return batch


class BoxPSDataset(MultiSlotDataset):
    """BoxPS-style pass-oriented dataset (reference framework/fleet/
    box_wrapper.h BeginPass/EndPass): begin_pass()/end_pass() bracket a
    training pass — pair with ps.heter.PassCachedEmbedding, whose
    begin_pass pulls the pass working set into HBM and end_pass flushes
    deltas. wait_preload_done/preload_into_memory map onto the in-memory
    loader."""

    def begin_pass(self):
        return True

    def end_pass(self, need_save_delta=False):
        return True

    def preload_into_memory(self):
        self.load_into_memory()

    def wait_preload_done(self):
        return True
