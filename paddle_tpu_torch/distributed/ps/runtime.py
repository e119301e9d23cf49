"""PS runtime wiring for fleet (counterpart of
paddle_tpu/distributed/ps/runtime.py, the same code; reference:
fleet/runtime/the_one_ps.py:434 TheOnePSRuntime: _init_worker builds
Communicator, _init_server hosts tables)."""
import os

from .embedding_service import EmbeddingServer, EmbeddingClient

_PS = {'servers': [], 'client': None, 'server': None}


def init_server(fleet_state, *args, **kwargs):
    srv = EmbeddingServer(
        host='0.0.0.0',
        port=int(os.environ.get('PADDLE_PORT', '0') or 0))
    _PS['server'] = srv
    return srv


def run_server(fleet_state):
    if _PS['server'] is None:
        init_server(fleet_state)
    _PS['server'].start(block=True)


def init_worker(fleet_state):
    eps = os.environ.get('PADDLE_PSERVERS_IP_PORT_LIST', '')
    if eps:
        _PS['client'] = EmbeddingClient(endpoints=eps.split(','))
    return _PS['client']


def stop_worker(fleet_state):
    if _PS['client'] is not None:
        _PS['client'] = None


def get_client():
    return _PS['client']


def local_cluster(num_servers=2, dim=8, table_id=0, **table_kwargs):
    """Same-process PS cluster for tests (reference pattern:
    distributed/test/brpc_service_dense_sgd_test.cc spins server+client in
    one process)."""
    servers = [EmbeddingServer() for _ in range(num_servers)]
    for s in servers:
        s.create_table(table_id, dim, **table_kwargs)
        s.start(block=False)
    client = EmbeddingClient(servers=servers)
    return servers, client
