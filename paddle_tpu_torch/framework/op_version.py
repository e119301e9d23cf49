"""Per-op semantic version registry (a copy of
paddle_tpu/framework/op_version.py, which imports no JAX; reference:
paddle/fluid/framework/op_version_registry.h REGISTER_OP_VERSION +
compatible_checkers).

The artifact format version (jit/__init__.py _FORMAT_VERSION) covers the
CONTAINER; this registry covers OP SEMANTICS: when an op's behavior
changes incompatibly (new default attr, different broadcasting, changed
output), its version is bumped here, saved artifacts embed the snapshot,
and loads check the saved versions against the running registry — an op
saved at a NEWER version than the runtime knows is refused (the artifact
relies on semantics this build predates), while an older version warns.
"""
import warnings

__all__ = ['register_op_version', 'get_op_version', 'snapshot',
           'check_compatible', 'OpVersionError']

# ops whose semantics have been revised since the first release get an
# explicit entry; everything else is implicitly version 1
_REGISTRY = {
    # r4: attention gained the blockwise (pure-XLA online-softmax) path;
    # numerics of the default path unchanged, routing attr added
    'scaled_dot_product_attention': 2,
    # r3: flash_attention strict-mode contract (fallbacks raise)
    'flash_attention': 2,
    # r2 -> r3: generate_proposals pixel_offset arithmetic fixed
    'generate_proposals': 2,
    'distribute_fpn_proposals': 2,
    'box_coder': 2,
}
_DEFAULT_VERSION = 1


class OpVersionError(RuntimeError):
    pass


def register_op_version(name, version):
    """REGISTER_OP_VERSION analog: record that `name`'s semantics are at
    `version` in this build."""
    _REGISTRY[name] = int(version)


def get_op_version(name):
    return _REGISTRY.get(name, _DEFAULT_VERSION)


def snapshot():
    """The dict an artifact embeds at save time."""
    return dict(_REGISTRY)


def check_compatible(saved, artifact=''):
    """Check a loaded artifact's op-version snapshot against the runtime.

    saved > runtime  -> OpVersionError (artifact needs newer semantics)
    saved < runtime  -> warning (runtime will apply CURRENT semantics;
                        the reference's version_cmp pass-through case)
    """
    if not saved:
        return
    for name, ver in saved.items():
        cur = get_op_version(name)
        if ver > cur:
            raise OpVersionError(
                'artifact %s uses op %r at version %d but this build '
                'implements version %d — upgrade the framework to load it'
                % (artifact or '<unnamed>', name, ver, cur))
        if ver < cur:
            warnings.warn(
                'artifact %s saved op %r at version %d; this build runs '
                'version %d semantics' % (artifact or '<unnamed>', name,
                                          ver, cur))
