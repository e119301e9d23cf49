"""Model artifact distribution over the fabric wire protocol (counterpart
of paddle_tpu/serving/fabric/artifacts.py).

A worker process spawned with nothing but a (model, version) pair must
obtain the exact bytes the gateway's registry catalogs — copying
checkpoint paths around by hand is how fleets end up serving the wrong
weights. The flow:

    gateway side                         worker side
    ------------                         -----------
    ArtifactServer(registry)             ArtifactClient(endpoint, dir)
        op 'manifest' ------------------>  what files, what fingerprint
        op 'fetch'    ------------------>  base64 chunks (CHUNK raw
                                           bytes per frame, well under
                                           protocol.MAX_FRAME)
                                           write atomically, then
                                           VERIFY: CRC manifest check +
                                           content fingerprint match
                                           -> registry.register()

Verification is the contract: a corrupted transfer (or a corrupted
source) raises ArtifactVerifyError — a typed reject the worker can
report and survive, never weights-silently-wrong and never a crash.
The fingerprint is `registry.artifact_fingerprint` — a hash of the CRC
manifest, so matching it proves content identity, not just transfer
integrity. The port's artifacts are the port's io_save checkpoints; it
neither serves nor reads checkpoints written by the JAX package (their
pickled payload class is the JAX package's own).

The client rides ResilientChannel with the JSON codec: fetches are
pure reads (idempotent, retried) and inherit breaker/deadline/trace
behavior like every other fabric call.
"""
import base64
import os
import socketserver
import threading

from ...distributed.resilience import FrameError, ResilientChannel
from ...framework import io_save
from ...monitor import tracing as _tracing
from ..registry.registry import artifact_fingerprint
from .protocol import MAX_FRAME, recv_frame, send_frame

__all__ = ['ArtifactServer', 'ArtifactClient', 'ArtifactVerifyError',
           'CHUNK', 'OP_SEMANTICS']

# raw bytes per fetch reply; base64 inflates 4/3, comfortably < MAX_FRAME
CHUNK = 4 << 20


class ArtifactVerifyError(RuntimeError):
    """Pulled artifact failed verification (CRC manifest mismatch or
    content fingerprint != the cataloged fingerprint). The partial
    download is removed; the worker should report and keep serving
    what it has."""


# retry semantics per op, lint-enforced (tools/graftlint idempotency):
OP_SEMANTICS = {
    'manifest': 'idempotent',   # pure read of the catalog entry
    'fetch': 'idempotent',      # pure read at an explicit offset
    'ping': 'idempotent',       # liveness probe, pure read
    'stop': 'non_idempotent',   # second delivery hits a dead server
}


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        self.server.live_connections.add(self.request)

    def finish(self):
        self.server.live_connections.discard(self.request)

    def handle(self):
        art = self.server.artifact_server
        while True:
            try:
                msg = recv_frame(self.request)
            except FrameError as e:
                # typed reject, then close (framing may be out of sync)
                try:
                    send_frame(self.request,
                               {'error': repr(e),
                                'error_type': type(e).__name__})
                except OSError:
                    pass
                return
            except (ConnectionError, OSError):
                return
            if msg is None:
                return
            span = _tracing.default_tracer().server_span(
                msg, 'fabric.artifacts')
            try:
                op = msg.get('op')
                if op == 'manifest':
                    send_frame(self.request,
                               art.manifest(msg['model'], msg['version']))
                elif op == 'fetch':
                    send_frame(self.request,
                               art.fetch(msg['model'], msg['version'],
                                         msg['file'], msg['offset']))
                elif op == 'ping':
                    send_frame(self.request, {'ok': True})
                elif op == 'stop':
                    send_frame(self.request, {'ok': True})
                    self.server.shutdown()
                    return
                else:
                    send_frame(self.request,
                               {'error': 'unknown op %r' % op})
            except Exception as e:  # report instead of killing the server
                span.set_error(e)
                try:
                    send_frame(self.request, {'error': repr(e)})
                except OSError:
                    return
            finally:
                span.finish()


class _ArtifactTCPServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class ArtifactServer:
    """Serves a ModelRegistry's file artifacts (+ their CRC manifest
    sidecars) over the fabric wire protocol. Start next to the gateway;
    pass `.endpoint` to worker processes."""

    def __init__(self, registry, host='127.0.0.1', port=0):
        self.registry = registry
        self._srv = _ArtifactTCPServer((host, port), _Handler,
                                       bind_and_activate=True)
        self._srv.artifact_server = self
        self._srv.live_connections = set()
        self.port = self._srv.server_address[1]
        self.endpoint = '%s:%d' % (host, self.port)
        self._thread = None

    def manifest(self, model, version):
        entry = self.registry.entry(model, version)
        if not os.path.isfile(entry.path):
            raise ValueError('artifact (%r, %r) is not a file artifact — '
                             'fabric distribution serves file checkpoints'
                             % (model, version))
        files = [{'name': os.path.basename(entry.path),
                  'size': os.path.getsize(entry.path)}]
        side = io_save.manifest_path(entry.path)
        if os.path.exists(side):
            files.append({'name': os.path.basename(side),
                          'size': os.path.getsize(side)})
        return {'model': entry.model, 'version': entry.version,
                'fingerprint': entry.fingerprint, 'nbytes': entry.nbytes,
                'meta': entry.meta, 'artifact': files[0]['name'],
                'files': files}

    def fetch(self, model, version, name, offset):
        entry = self.registry.entry(model, version)
        root = os.path.dirname(entry.path)
        # the manifest names only basenames it advertised; refuse path
        # traversal rather than serve arbitrary files
        if os.path.basename(name) != name:
            raise ValueError('bad artifact file name %r' % name)
        path = os.path.join(root, name)
        with open(path, 'rb') as f:
            f.seek(int(offset))
            data = f.read(CHUNK)
            eof = f.tell() >= os.path.getsize(path)
        return {'data': base64.b64encode(data).decode('ascii'),
                'eof': bool(eof)}

    def start(self):
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()


class ArtifactClient:
    """Worker-side puller: fetch, verify, register."""

    def __init__(self, endpoint, cache_dir):
        from .protocol import JSON_CODEC
        self.endpoint = endpoint
        self.cache_dir = cache_dir
        self._channel = ResilientChannel(endpoint, codec=JSON_CODEC,
                                         max_frame=MAX_FRAME)

    def close(self):
        self._channel.close()

    def _checked(self, out):
        if isinstance(out, dict) and 'error' in out:
            raise RuntimeError('artifact server error: %s' % out['error'])
        return out

    def ensure(self, registry, model, version):
        """Make (model, version) available in the worker's local
        `registry`, pulling and verifying the artifact if absent.
        Returns the local RegistryEntry."""
        if (model, version) in registry:
            return registry.entry(model, version)
        info = self._checked(self._channel.call(
            {'op': 'manifest', 'model': model, 'version': version}))
        dest_dir = os.path.join(self.cache_dir, str(model))
        local = None
        for f in info['files']:
            data = bytearray()
            while True:
                out = self._checked(self._channel.call(
                    {'op': 'fetch', 'model': model, 'version': version,
                     'file': f['name'], 'offset': len(data)}))
                data.extend(base64.b64decode(out['data']))
                if out['eof']:
                    break
            path = os.path.join(dest_dir, f['name'])
            # atomic write: a torn local file can never masquerade as a
            # complete artifact even if the worker dies mid-pull
            io_save.write_bytes_atomic(path, bytes(data))
            if f['name'] == info['artifact']:
                local = path
        got = artifact_fingerprint(local)
        if got != info['fingerprint']:
            os.unlink(local)
            raise ArtifactVerifyError(
                'pulled artifact (%r, %r) fingerprint %s does not match '
                'cataloged %s — rejecting' % (model, version, got,
                                              info['fingerprint']))
        try:
            # register(verify=True) re-checks the CRC manifest sidecar
            return registry.register(model, version, local,
                                     meta=info.get('meta'), verify=True)
        except io_save.CheckpointCorruptError as e:
            os.unlink(local)
            raise ArtifactVerifyError(
                'pulled artifact (%r, %r) failed CRC manifest '
                'verification: %s' % (model, version, e))

    def stop_server(self):
        self._checked(self._channel.call({'op': 'stop'}, idempotent=False))
