"""paddle.distributed.spawn (counterpart of paddle_tpu/distributed/spawn.py;
reference: distributed/spawn.py:333 + fleet/launch_utils.py env contract).

nprocs <= 1 calls func inline; more start one process per rank through
torch.multiprocessing's spawn context with the reference's env contract
(PADDLE_TRAINER_ID, PADDLE_TRAINERS_NUM, PADDLE_CURRENT_ENDPOINT,
PADDLE_TRAINER_ENDPOINTS on free local ports; PADDLE_TRAINER_TRACE_DIR
gets a rank_<i> directory each), which init_parallel_env reads. A rank's
failure propagates with its traceback text (launch_utils' TrainerProc
watch loop).

The JAX package forces its children onto the CPU backend, since one
process drives every TPU chip. Here each rank owns a card: a child runs on
card FLAGS_selected_gpus = its rank unless options say
`backend='gloo'` (or `device='cpu'`), which puts the ranks on the CPU.
A spawn child imports the module that defines `func` again, so define it
where nothing imports jax. When func returns, a rank's NCCL groups are
ended together (env.end_nccl_groups) before the process exits.
"""
import os
import traceback

import torch.multiprocessing as mp

__all__ = ['spawn', 'SpawnContext']


class SpawnContext:
    def __init__(self, procs, error_queue):
        self.processes = procs
        self._errors = error_queue

    def join(self, timeout=None):
        for p in self.processes:
            p.join(timeout)
        failures = []
        while not self._errors.empty():
            failures.append(self._errors.get())
        for p in self.processes:
            if p.exitcode not in (0, None):
                rank_tb = next((tb for r, tb in failures), None)
                raise RuntimeError(
                    'spawned rank failed (exitcode %s)%s'
                    % (p.exitcode,
                       (':\n' + rank_tb) if rank_tb else ''))
        return True


def _free_ports(n):
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(('127.0.0.1', 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def _rank_env(rank, nprocs, ports, options):
    endpoints = ','.join('127.0.0.1:%d' % p for p in ports)
    env = {'PADDLE_TRAINER_ID': str(rank),
           'PADDLE_TRAINERS_NUM': str(nprocs),
           'PADDLE_CURRENT_ENDPOINT': '127.0.0.1:%d' % ports[rank],
           'PADDLE_TRAINER_ENDPOINTS': endpoints}
    trace_base = os.environ.get('PADDLE_TRAINER_TRACE_DIR')
    if trace_base:
        # per-rank trace dirs, merge_traces-ready (profiler)
        env['PADDLE_TRAINER_TRACE_DIR'] = os.path.join(trace_base,
                                                       'rank_%d' % rank)
    cpu = options.get('backend') == 'gloo' or \
        str(options.get('device', '')).startswith('cpu')
    if cpu:
        env.update(PADDLE_DISTRI_BACKEND='gloo', PADDLE_DISTRI_DEVICE='cpu')
    else:
        gpus = options.get('gpus')
        card = gpus.split(',')[rank] if gpus else str(rank)
        env.update(PADDLE_DISTRI_BACKEND='nccl', FLAGS_selected_gpus=card,
                   PADDLE_LOCAL_RANK=str(rank))
    env.update(options.get('env') or {})
    return env


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run func(*args) in nprocs ranks; options: backend ('nccl' / 'gloo'),
    device ('gpu' / 'cpu'), gpus ('0,1,...'), env (extra variables for
    every rank)."""
    if nprocs in (-1, 0, 1, None):
        func(*args)
        return None
    ctx = mp.get_context('spawn')
    error_queue = ctx.SimpleQueue()
    ports = _free_ports(nprocs)
    procs = []
    for rank in range(nprocs):
        env = _rank_env(rank, nprocs, ports, options)
        p = ctx.Process(target=_wrap,
                        args=(func, args, env, rank, error_queue),
                        daemon=daemon)
        p.start()
        procs.append(p)
    context = SpawnContext(procs, error_queue)
    if join:
        context.join()
        return None
    return context


def _wrap(func, args, env, rank, error_queue):
    os.environ.update(env)
    try:
        func(*args)
        from .env import end_nccl_groups
        end_nccl_groups()
    except Exception:
        error_queue.put((rank, traceback.format_exc()))
        raise
