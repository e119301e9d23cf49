"""1F1B pipeline schedule (counterpart of paddle_tpu/distributed/
pipeline_1f1b.py; reference: framework/section_worker.cc:104-143
micro-batch loop RunForward / RunBackward / RunUpdate;
fleet/meta_parallel/pipeline_parallel.py:109 train_batch).

The same stage pieces as the GPipe loop (pipeline.py), with forwards and
backwards interleaved, on rank r of pp stages over n_micro microbatches:

  forward  of microbatch i at tick r + i
  backward of microbatch i at tick 2(pp - 1) - r + i
  => rank r warms up with pp - 1 - r forwards, then alternates one
     forward and one backward, then drains the last backwards; at most
     pp - r microbatches are in flight on it.

The loss of each microbatch is taken inside the last stage (post of the
model's pp_decompose()), so its backward starts at the tick after its
forward. In the steady state a stage sends its activation forward and
receives a gradient from the next stage in one batch_isend_irecv, and
sends its gradient back while receiving the next activation in another:
blocking sends there would deadlock on NCCL.

The JAX schedule stashes each in-flight microbatch's stage INPUT and
recomputes the stage's forward at its backward tick (one scan carries a
fixed-size stash). The port keeps each in-flight microbatch's autograd
graph instead: the same function, no second forward, and a peak of pp - r
stage graphs on rank r (with remat, only each layer's input and output).
On the card this is measured by chip_smoke's phase 25 (a), beside GPipe,
which holds all n_micro graphs.

The JAX package's one_f_one_b_loss (the step's loss under this order) is
pipeline.run_schedule with the state's schedule '1f1b'.
"""

__all__ = ['one_f_one_b', 'supports_1f1b']


def supports_1f1b(model):
    return hasattr(model, 'pp_decompose')


def one_f_one_b(run, n_micro, line):
    """Drive `run` (pipeline._Run) through the 1F1B order on this rank."""
    pp, r = line.n_stages, line.stage
    warm = min(pp - 1 - r, n_micro)
    steady = n_micro - warm
    for i in range(warm):
        run.send_forward(run.forward(i, run.recv_forward()))
    x = run.recv_forward() if steady > 0 else None
    for k in range(steady):
        y = run.forward(warm + k, x)
        grad = None
        if y is not None:
            # (a non-last stage sent microbatch 0, and its header, while
            # warming up)
            _, grad = run.wire.exchange(send_next=y,
                                        recv_next=run.grad_meta(k))
        dx = run.backward(k, grad)
        last = k == steady - 1
        if run.stage.first:
            x = None
        elif last:
            run.wire.exchange(send_prev=dx)
        else:
            x, _ = run.wire.exchange(send_prev=dx, recv_prev=True)
            x.requires_grad_()
    for j in range(steady, n_micro):
        grad = None
        if not run.stage.last:
            _, grad = run.wire.exchange(recv_next=run.grad_meta(j))
        dx = run.backward(j, grad)
        if not run.stage.first:
            run.wire.exchange(send_prev=dx)

