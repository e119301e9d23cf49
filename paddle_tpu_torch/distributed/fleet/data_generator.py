"""fleet data generator (counterpart of
paddle_tpu/distributed/fleet/data_generator.py, the same code; reference:
python/paddle/distributed/fleet/
data_generator/data_generator.py — the writer side of the MultiSlot
pipeline: user code yields (slot_name, values) tuples per sample and the
generator renders MultiSlotDataFeed text lines, usually under a hadoop
streaming job feeding the PS trainer).

Round-trips with native/datafeed.cc's parser and ps/dataset.py's
MultiSlotDataset.
"""
import sys

__all__ = ['DataGenerator', 'MultiSlotDataGenerator',
           'MultiSlotStringDataGenerator']


class DataGenerator:
    """Subclass and override generate_sample(line) to return a no-arg
    generator yielding one or more samples; each sample is a list of
    (slot_name, [values]) tuples in slot order."""

    def __init__(self):
        self._batch = 1
        self._line_proc = None

    def set_batch(self, batch_size):
        self._batch = int(batch_size)

    def generate_sample(self, line):
        raise NotImplementedError(
            'override generate_sample(line) to yield samples')

    def generate_batch(self, samples):
        """Optional batch-level hook (reference parity): receives the
        accumulated `samples` list, yields samples to emit."""
        def gen():
            for s in samples:
                yield s
        return gen

    def _gen_str(self, sample):
        raise NotImplementedError

    def run_from_stdin(self):
        self._run(sys.stdin, sys.stdout)

    def run_from_memory(self, lines=None):
        """Returns the rendered lines (test/runtime hook)."""
        out = []

        class _Sink:
            def write(self, s):
                out.append(s)
        self._run(lines if lines is not None else [None], _Sink())
        return ''.join(out)

    def _run(self, lines, sink):
        batch = []
        for line in lines:
            gen = self.generate_sample(line)
            for sample in gen():
                batch.append(sample)
                if len(batch) >= self._batch:
                    self._flush(batch, sink)
                    batch = []
        if batch:
            self._flush(batch, sink)

    def _flush(self, batch, sink):
        for sample in self.generate_batch(batch)():
            sink.write(self._gen_str(sample))


class MultiSlotDataGenerator(DataGenerator):
    """Renders [(name, values), ...] as MultiSlotDataFeed text:
    'n v1 .. vn' per slot, space-joined (data_feed.h:208 format)."""

    def _gen_str(self, sample):
        parts = []
        for _name, values in sample:
            parts.append(str(len(values)))
            parts.extend(str(v) for v in values)
        return ' '.join(parts) + '\n'


class MultiSlotStringDataGenerator(DataGenerator):
    """Values are pre-stringified by the user (string variant)."""

    def _gen_str(self, sample):
        parts = []
        for _name, values in sample:
            parts.append(str(len(values)))
            parts.extend(values)
        return ' '.join(parts) + '\n'
