"""Model registry: (model, version) → loadable artifact + serving pointer
(counterpart of paddle_tpu/serving/registry/registry.py).

The registry is a catalog, not a loader: it records where each version's
checkpoint lives, fingerprints the artifact by content, and owns the
per-model *serving pointer* — the version new submissions resolve to.
Weight residency is ModelHost's job (hosting.py); the atomic pointer
flip is what makes `ServingGateway.rollout()` zero-downtime, because
in-flight requests captured their entry at submission and keep it.

Artifacts are io_save checkpoints (CRC-manifest sidecar), so the
fingerprint is content-addressed for free: the manifest already commits
to the payload's size + CRC32, and hashing the manifest bytes gives a
stable identity without re-reading a multi-GB payload. Files without a
manifest (foreign artifacts) hash their own bytes instead; directories
hash the sorted per-file fingerprints. Two registrations of the same
bytes — on any host, any path — get the same fingerprint, which is what
lets the fingerprint key the persistent compile cache: same weights +
same config → same traced program → warm bring-up is a cache hit.

The port's checkpoints pickle its own tensor payload (framework/io_save.py),
so the same weights published by the port and by the JAX package have
different bytes and different fingerprints; neither registry serves the
other's artifacts.
"""
import hashlib
import os
import threading

from ...framework import io_save

__all__ = ['ModelRegistry', 'RegistryEntry', 'artifact_fingerprint']


def _file_fingerprint(path):
    h = hashlib.sha256()
    mf = io_save.manifest_path(path)
    src = mf if os.path.exists(mf) else path
    with open(src, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def artifact_fingerprint(path):
    """Content-addressed identity of an artifact file or directory
    (16-hex). For io_save checkpoints this hashes the CRC manifest —
    cheap and exactly as binding as hashing the payload."""
    if os.path.isdir(path):
        h = hashlib.sha256()
        for root, dirs, files in sorted(os.walk(path)):
            dirs.sort()
            for name in sorted(files):
                if name.endswith('.manifest'):
                    continue       # folded into its data file's print
                rel = os.path.relpath(os.path.join(root, name), path)
                h.update(rel.encode('utf-8'))
                h.update(_file_fingerprint(
                    os.path.join(root, name)).encode())
        return h.hexdigest()[:16]
    return _file_fingerprint(path)[:16]


def _artifact_nbytes(path):
    if os.path.isdir(path):
        total = 0
        for root, _, files in os.walk(path):
            for name in files:
                total += os.path.getsize(os.path.join(root, name))
        return total
    return os.path.getsize(path)


class RegistryEntry:
    """One registered (model, version): immutable after registration."""

    __slots__ = ('model', 'version', 'path', 'fingerprint', 'nbytes',
                 'meta')

    def __init__(self, model, version, path, fingerprint, nbytes,
                 meta=None):
        self.model = model
        self.version = version
        self.path = path
        self.fingerprint = fingerprint
        self.nbytes = int(nbytes)
        self.meta = dict(meta or {})

    @property
    def key(self):
        return (self.model, self.version)

    def __repr__(self):
        return ('RegistryEntry(%r, %r, fingerprint=%s, nbytes=%d)'
                % (self.model, self.version, self.fingerprint,
                   self.nbytes))


class ModelRegistry:
    """Thread-safe catalog of model versions + per-model serving pointer.

    `root` (optional) is where publish() writes checkpoints; register()
    accepts artifacts living anywhere. The first registered version of a
    model becomes its serving version; set_serving() flips the pointer
    atomically (one attribute write under the lock — readers via
    resolve() see either the old or the new version, never neither).
    """

    def __init__(self, root=None):
        self.root = root
        self._entries = {}        # (model, version) -> RegistryEntry
        self._serving = {}        # model -> version
        self._lock = threading.Lock()

    # ---- registration -------------------------------------------------

    def register(self, model, version, path, meta=None, verify=True):
        """Catalog an existing artifact; returns its RegistryEntry.
        `verify=True` checks a file artifact against its CRC manifest
        first — a torn checkpoint must fail at registration, not at the
        first load on a serving replica."""
        if not os.path.exists(path):
            raise FileNotFoundError('no artifact at %s' % path)
        if verify and os.path.isfile(path) and \
                not io_save.verify_checkpoint(path):
            raise io_save.CheckpointCorruptError(
                '%s does not verify against its manifest — refusing to '
                'register a torn artifact' % path)
        entry = RegistryEntry(model, version, path,
                              artifact_fingerprint(path),
                              _artifact_nbytes(path), meta=meta)
        with self._lock:
            self._entries[(model, version)] = entry
            self._serving.setdefault(model, version)
        return entry

    def publish(self, model, version, obj, meta=None):
        """Write `obj` through the snapshot transport (io_save: atomic
        rename + CRC manifest) under root/ and register it — the door
        rollout() uses to ship a new version."""
        if self.root is None:
            raise ValueError('publish() needs a registry root directory')
        path = os.path.join(self.root, str(model),
                            '%s.pdparams' % version)
        io_save.save(obj, path)
        return self.register(model, version, path, meta=meta)

    # ---- lookup -------------------------------------------------------

    def entry(self, model, version):
        try:
            return self._entries[(model, version)]
        except KeyError:
            raise KeyError('unknown model version (%r, %r); registered: '
                           '%s' % (model, version,
                                   sorted(self._entries))) from None

    def resolve(self, model, version=None):
        """The entry a new submission should use: the explicit version,
        or the model's current serving pointer."""
        if version is None:
            with self._lock:
                version = self._serving.get(model)
            if version is None:
                raise KeyError('model %r has no registered versions'
                               % (model,))
        return self.entry(model, version)

    def load(self, model, version=None, **configs):
        """io_save.load of the resolved artifact (CRC-checked)."""
        return io_save.load(self.resolve(model, version).path, **configs)

    # ---- serving pointer ----------------------------------------------

    def serving_version(self, model):
        with self._lock:
            return self._serving.get(model)

    def set_serving(self, model, version):
        """Atomically repoint `model` at `version`; returns the previous
        version. The version must already be registered — the pointer
        can never dangle."""
        if (model, version) not in self._entries:
            raise KeyError('cannot serve unregistered version (%r, %r)'
                           % (model, version))
        with self._lock:
            prev = self._serving.get(model)
            self._serving[model] = version
            return prev

    # ---- enumeration --------------------------------------------------

    def models(self):
        with self._lock:
            return sorted(self._serving)

    def versions(self, model):
        return sorted(v for (m, v) in self._entries if m == model)

    def __contains__(self, key):
        return key in self._entries

    def __len__(self):
        return len(self._entries)
