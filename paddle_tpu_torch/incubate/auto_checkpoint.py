"""Auto-checkpoint / epoch-level resume (counterpart of
paddle_tpu/incubate/auto_checkpoint.py; reference:
fluid/incubate/checkpoint/auto_checkpoint.py — TrainEpochRange (:265)
wraps the epoch loop, periodically snapshots training state keyed by job
id, and on restart resumes at the last saved epoch; configured via
PADDLE_* env).

One snapshot a saved epoch through the port's framework io_save (atomic,
with a CRC32 manifest) holds {epoch, model state_dict, optimizer state,
extra}. A restore loads a torch module's state with `load_state_dict`
and anything else's (an optimizer, hapi's Model) with `set_state_dict`.
"""
import os
import re

import torch

from ..framework import io_save

__all__ = ['TrainEpochRange', 'train_epoch_range']

_CKPT_RE = re.compile(r'^epoch_(\d+)\.ckpt$')


def _restore_state(obj, state):
    if isinstance(obj, torch.nn.Module):
        obj.load_state_dict(state)
    else:
        obj.set_state_dict(state)


class TrainEpochRange:
    """for epoch in TrainEpochRange(20, 'job1', model=m, optimizer=opt):
    — resumes from the newest snapshot in checkpoint_dir and saves one
    every `save_checkpoint_inter` epochs (after the epoch body ran)."""

    def __init__(self, max_epoch_num, name=None, checkpoint_dir=None,
                 save_checkpoint_inter=1, model=None, optimizer=None,
                 extra_state=None, keep_last=3):
        self.max_epoch_num = int(max_epoch_num)
        self.name = name or os.environ.get('PADDLE_JOB_ID', 'acp_job')
        self.dir = checkpoint_dir or os.environ.get(
            'PADDLE_CHECKPOINT_DIR', './acp_checkpoints')
        self.dir = os.path.join(self.dir, self.name)
        self.inter = max(int(save_checkpoint_inter), 1)
        self.model = model
        self.optimizer = optimizer
        self.extra_state = extra_state if extra_state is not None else {}
        self.keep_last = int(keep_last)
        self.restored_epoch = -1
        self.skipped_corrupt = []   # epochs whose snapshot failed verify
        self._restore()

    # -- snapshot plumbing ---------------------------------------------------
    def _epochs_on_disk(self):
        try:
            names = os.listdir(self.dir)
        except OSError:
            return []
        out = []
        for n in names:
            m = _CKPT_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def _path(self, epoch):
        return os.path.join(self.dir, 'epoch_%d.ckpt' % epoch)

    def _restore(self):
        """Resume from the NEWEST VALID snapshot: a truncated/torn latest
        checkpoint (writer preempted mid-save) is detected via its CRC32
        manifest and skipped, falling back to the previous epoch — losing
        one save interval instead of the whole job."""
        for epoch in reversed(self._epochs_on_disk()):
            path = self._path(epoch)
            if not io_save.verify_checkpoint(path):
                self.skipped_corrupt.append(epoch)
                continue
            try:
                payload = io_save.load(path)
            except Exception:
                self.skipped_corrupt.append(epoch)
                continue
            if self.model is not None and 'model' in payload:
                _restore_state(self.model, payload['model'])
            if self.optimizer is not None and 'optimizer' in payload:
                _restore_state(self.optimizer, payload['optimizer'])
            self.extra_state.update(payload.get('extra', {}))
            self.restored_epoch = epoch
            return

    def save(self, epoch):
        payload = {'epoch': epoch, 'extra': dict(self.extra_state)}
        if self.model is not None:
            payload['model'] = self.model.state_dict()
        if self.optimizer is not None:
            payload['optimizer'] = self.optimizer.state_dict()
        # io_save writes atomically (temp + rename) with a manifest, so a
        # preemption mid-save can never tear an existing snapshot
        io_save.save(payload, self._path(epoch))
        for old in self._epochs_on_disk()[:-self.keep_last]:
            for p in (self._path(old),
                      io_save.manifest_path(self._path(old))):
                try:
                    os.remove(p)
                except OSError:
                    pass

    # -- the epoch loop ------------------------------------------------------
    def __iter__(self):
        start = self.restored_epoch + 1
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.inter == 0 or \
                    epoch == self.max_epoch_num - 1:
                self.save(epoch)


def train_epoch_range(max_epoch_num, save_checkpoint_inter=1, **kwargs):
    """Generator form (reference acp.train_epoch_range)."""
    return TrainEpochRange(max_epoch_num,
                           save_checkpoint_inter=save_checkpoint_inter,
                           **kwargs)
