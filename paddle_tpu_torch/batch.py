"""paddle.batch (reference: python/paddle/batch.py legacy reader batching;
the port's copy of paddle_tpu/batch.py)."""


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader
