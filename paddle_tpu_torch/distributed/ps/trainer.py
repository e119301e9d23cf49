"""Dataset-driven PS trainer (counterpart of
paddle_tpu/distributed/ps/trainer.py; reference: framework/executor.cc:152
Executor::RunFromDataset -> trainer.h:102 MultiTrainer ->
device_worker.h:244 HogwildWorker / :275 DownpourWorker TrainFiles).

Division of labor: worker threads drain the dataset channel; per batch
they PULL the unique sparse ids' rows from the embedding service (host),
copy the rows to the card, pool and run the dense half there, PUSH the
sparse grads (copied back to the host) through the communicator
(async/half_async/sync/geo), and update the shared dense params
Hogwild-style (lock-free, as HogwildWorker does). The model is a
pooled-embedding CTR net: per-slot mean-pooled embeddings -> MLP ->
sigmoid logloss (the reference's ctr_dnn fleet example shape).

On the card a batch is one gather of the pulled rows by position, one
segment sum (`index_add_` over the CSR offsets' segment ids) divided by
the counts, the MLP's forward and backward (`torch.autograd.grad`), and
the pooled gradient spread back to the positions by one gather. The JAX
trainer pools and spreads per instance in numpy and runs the MLP in one
jitted program: the same function, with the f32 sums in another order.

The Hogwild dense parameters live on the card, updated in place under no
lock. Each step first takes its own copy of them (the JAX trainer's
host-to-device copy at the step's start), so a sibling's update never
lands inside a step's forward and backward, and each worker's tensors
stay its own.
"""
import threading

import numpy as np
import torch

from ...framework import device as device_mod

__all__ = ['DownpourTrainer', 'AsyncExecutor']


def _logloss(logit, labels):
    """Sigmoid cross-entropy, written as the JAX trainer writes it."""
    return torch.mean(torch.clamp(logit, min=0) - logit * labels +
                      torch.log1p(torch.exp(-torch.abs(logit))))


class DownpourTrainer:
    """CTR trainer over sparse PS slots + a dense MLP on the card.

    client: EmbeddingClient (rows live host-side, maybe SSD-backed)
    communicator: ps.communicator.Communicator (push mode semantics)
    slots: sparse slot names (each has a table on the PS)
    tables: {slot_name: table_id}
    device: where the dense half runs (the current device when None)
    """

    def __init__(self, client, communicator, slots, tables, emb_dim,
                 hidden=32, lr=0.05, n_threads=2, seed=0,
                 label_slot='label', device=None):
        self.client = client
        self.comm = communicator
        self.slots = list(slots)
        self.tables = dict(tables)
        self.emb_dim = emb_dim
        self.lr = lr
        self.n_threads = max(int(n_threads), 1)
        self.label_slot = label_slot
        self.device = device_mod.resolve(device)
        rng = np.random.RandomState(seed)
        d_in = emb_dim * len(self.slots)
        # the JAX trainer's draws, in its order
        init = {
            'w1': rng.randn(d_in, hidden).astype(np.float32) * 0.1,
            'b1': np.zeros(hidden, np.float32),
            'w2': rng.randn(hidden, 1).astype(np.float32) * 0.1,
            'b2': np.zeros(1, np.float32),
        }
        # shared Hogwild dense params, on the card
        self.dense = {k: torch.tensor(v, device=self.device)
                      for k, v in init.items()}
        self._losses = []
        self._loss_lock = threading.Lock()

    def _dense_step(self, dense, pooled, labels):
        """The dense half: pooled [B, n_slots, dim] -> (loss, d_pooled,
        d_dense), the JAX trainer's `step`."""
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in dense.items()}
        pooled = pooled.detach().requires_grad_(True)
        x = pooled.reshape(pooled.shape[0], -1)
        h = torch.tanh(x @ params['w1'] + params['b1'])
        logit = (h @ params['w2'] + params['b2'])[:, 0]
        loss = _logloss(logit, labels)
        keys = list(params)
        grads = torch.autograd.grad(loss, [pooled] + [params[k]
                                                      for k in keys])
        return loss.detach(), grads[0], dict(zip(keys, grads[1:]))

    def _pull(self, batch):
        """Host side: per slot, pull the unique ids' rows (the JAX order,
        so a Python table mints rows in the same sequence). Returns the
        rows of every slot stacked, each position's row index into them,
        its segment id (instance * n_slots + slot) and the per-slot
        (ids, offsets)."""
        bsz = batch['__size__']
        n_slots = len(self.slots)
        rows, index, segment, slot_ctx = [], [], [], []
        base = 0
        for s, name in enumerate(self.slots):
            ids, offs = batch[name]
            uniq, inv = np.unique(ids, return_inverse=True)
            rows.append(self.client.pull(self.tables[name], uniq))
            index.append(inv.reshape(-1) + base)
            counts = np.diff(offs)
            segment.append(np.repeat(np.arange(bsz, dtype=np.int64)
                                     * n_slots + s, counts))
            slot_ctx.append((ids, offs))
            base += len(uniq)
        return (np.concatenate(rows), np.concatenate(index),
                np.concatenate(segment), slot_ctx)

    def _pool(self, bsz, rows, index, segment, device):
        """One gather of the pulled rows by position and one segment mean
        over the CSR segments, on `device`: returns pooled [bsz, n_slots,
        dim], each segment's count (at least 1) and the segment ids."""
        n_slots = len(self.slots)
        rows_d = torch.from_numpy(rows).to(device)
        index_d = torch.from_numpy(index).to(device)
        segment_d = torch.from_numpy(segment).to(device)
        counts = torch.zeros(bsz * n_slots, device=device).index_add_(
            0, segment_d, torch.ones(len(segment), device=device))
        denom = counts.clamp(min=1.0)[:, None]
        pooled = torch.zeros(bsz * n_slots, self.emb_dim, device=device)
        pooled.index_add_(0, segment_d, rows_d[index_d])
        pooled = (pooled / denom).reshape(bsz, n_slots, self.emb_dim)
        return pooled, denom, segment_d

    def _device_step(self, batch, rows, index, segment):
        """The card's part of a batch: returns (loss, the per-position
        sparse grads as a host array)."""
        bsz = batch['__size__']
        dev = self.device
        pooled, denom, segment_d = self._pool(bsz, rows, index, segment,
                                              dev)
        labels = torch.from_numpy(
            np.asarray(batch[self.label_slot], np.float32)).to(dev)
        loss, d_pooled, d_dense = self._dense_step(self.dense, pooled,
                                                   labels)
        # the spread: each position takes its instance's pooled grad over
        # the instance's count in that slot
        pos_grads = (d_pooled.reshape(-1, self.emb_dim) / denom)[
            segment_d].cpu().numpy()
        # Hogwild dense update (lock-free, HogwildWorker semantics)
        with torch.no_grad():
            for k, g in d_dense.items():
                self.dense[k].sub_(self.lr * g)
        return float(loss), pos_grads

    def _push(self, slot_ctx, pos_grads):
        """Sparse push, per slot as the JAX trainer pushes."""
        lo = 0
        for s, name in enumerate(self.slots):
            pos_ids, offs = slot_ctx[s]
            n_pos = int(offs[-1])
            if n_pos == 0:
                continue
            grads = pos_grads[lo:lo + n_pos]
            lo += n_pos
            if self.comm.mode == 'geo':
                self.comm.push_sparse_param(self.tables[name], pos_ids,
                                            -self.lr * grads)
            else:
                self.comm.push_sparse_grad(self.tables[name], pos_ids,
                                           grads)

    def _train_one_batch(self, batch):
        rows, index, segment, slot_ctx = self._pull(batch)
        loss, pos_grads = self._device_step(batch, rows, index, segment)
        self._push(slot_ctx, pos_grads)
        return loss

    def train_from_dataset(self, dataset, epochs=1, debug=False):
        """The Executor::RunFromDataset analog: drain the dataset channel
        with n_threads workers; returns per-batch losses (in completion
        order)."""
        channel = dataset.start_channel(epochs=epochs)
        self._losses = []
        errors = []

        def worker():
            while True:
                item = channel.get()
                if item is None:
                    channel.put(None)  # wake siblings
                    return
                try:
                    loss = self._train_one_batch(item)
                except BaseException as e:  # surfaced after the join
                    errors.append(e)
                    channel.put(None)
                    return
                with self._loss_lock:
                    self._losses.append(loss)

        threads = [threading.Thread(target=worker)
                   for _ in range(self.n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        self.comm.flush()
        return list(self._losses)


class AsyncExecutor:
    """Legacy async-executor API (reference: framework/async_executor.cc,
    deprecated there in favor of the TrainerBase runtime). Kept as a thin
    facade over DownpourTrainer so old run-from-dataset scripts port:
    construct, then run(trainer, dataset) or run_from_files(...)."""

    def __init__(self, place=None, run_mode=''):
        self.place = place

    def run(self, trainer, dataset, debug=False, epochs=1):
        """trainer: a DownpourTrainer (the modern runtime)."""
        return trainer.train_from_dataset(dataset, epochs=epochs,
                                          debug=debug)

    def run_from_files(self, trainer, filelist, slots, batch_size=32,
                       epochs=1, shuffle_seed=None):
        from .dataset import MultiSlotDataset
        ds = MultiSlotDataset()
        ds.set_use_var(slots)
        ds.set_filelist(filelist)
        ds.set_batch_size(batch_size)
        ds.load_into_memory()
        if shuffle_seed is not None:
            ds.local_shuffle(seed=shuffle_seed)
        return self.run(trainer, ds, epochs=epochs)
