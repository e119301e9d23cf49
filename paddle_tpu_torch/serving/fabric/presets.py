"""Named predictor-zoo presets: known-good engine configs by name
(counterpart of paddle_tpu/serving/fabric/presets.py).

A ReplicaWorker process has to build an engine from nothing but argv.
Hand-assembling a config + seeded weights + engine kwargs in every
spawn site (tests, benches, ops runbooks) is exactly the drift the
model registry exists to prevent, so the zoo pins named presets:

    ReplicaWorker --preset gpt-nano          # seeded weights, no registry
    publish_preset(registry, 'gpt-nano')     # ship the weights as a
                                             # CRC-manifested artifact

`publish_preset` stamps `meta={'preset': name}` on the registry entry,
so a worker that pulls the artifact by fingerprint knows which config
to rebuild around the weights — the preset name IS the architecture
pointer, the artifact IS the weights. A variant of a preset (fewer
layers, say) is published with `model=` GPTConfig overrides, which the
meta carries beside the name. `host_factory()` closes the loop
for ModelHost: entry -> engine, loading the entry's state dict into
the preset's model skeleton.

Determinism contract: build_model(name) draws the weights from a torch
generator seeded with the preset's pinned seed, so two processes building
the same preset hold bit-identical weights — which is what lets the
fabric chaos tests compare a SIGKILL'd worker's re-generated tokens
against a single-engine reference without shipping weights at all. The
weights are torch's draws, not the JAX package's: to serve the JAX
preset's weights, carry them across (text.models.gpt.load_paddle_tpu_state)
and publish the port model's state dict.

Models build on the card unless the caller passes device='cpu'; `dtype`
casts the built model (e.g. 'bfloat16' for the card's throughput runs).

The zoo holds the JAX package's three presets verbatim and one more row,
'gpt-bench': the configuration the JAX package's serving-gateway rungs
run on the TPU (bench_extra.py, vocab 30528, 768 x 12 x 12, a slot engine
of 8 slots x 256, chunk 32, burst 8), which the port's card runs use.
"""
from ...framework import io_save

__all__ = ['PRESETS', 'preset', 'build_model', 'build_engine',
           'publish_preset', 'host_factory']

# model: GPTConfig kwargs. engine: 'slot' | 'paged'. engine_kwargs:
# engine constructor kwargs. seed: the model generator's pinned seed.
PRESETS = {
    # the test-suite workhorse: matches the serving test fixtures so a
    # worker process and an in-proc reference engine are token-identical
    'gpt-nano': {
        'model': dict(vocab_size=211, hidden_size=64, num_layers=2,
                      num_heads=4, max_position_embeddings=128,
                      dropout=0.0),
        'engine': 'slot',
        'engine_kwargs': dict(num_slots=2, max_len=32, prefill_chunk=8,
                              decode_block=2),
        'seed': 7,
    },
    # same weights, paged KV with the prefix cache on — the preset the
    # prefix-affinity routing bench runs, where directory hits matter
    'gpt-nano-paged': {
        'model': dict(vocab_size=211, hidden_size=64, num_layers=2,
                      num_heads=4, max_position_embeddings=128,
                      dropout=0.0),
        'engine': 'paged',
        'engine_kwargs': dict(num_seqs=4, max_len=64, page_size=8,
                              prefill_chunk=8, decode_block=2,
                              prefix_cache=True),
        'seed': 7,
    },
    # bench-sized: the CPU serving-bench config (bench_extra) with a
    # paged engine big enough for Poisson bursts over real sockets
    'gpt-micro': {
        'model': dict(vocab_size=512, hidden_size=128, num_layers=2,
                      num_heads=4, max_position_embeddings=256,
                      dropout=0.0),
        'engine': 'paged',
        'engine_kwargs': dict(num_seqs=8, max_len=128, page_size=16,
                              prefill_chunk=16, decode_block=4,
                              prefix_cache=True),
        'seed': 11,
    },
    # full width: the serving-gateway rungs' on-TPU configuration
    # (bench_extra.py:940-945), which the card runs of the fabric use
    'gpt-bench': {
        'model': dict(vocab_size=30528, hidden_size=768, num_layers=12,
                      num_heads=12, max_position_embeddings=1024,
                      dropout=0.0),
        'engine': 'slot',
        'engine_kwargs': dict(num_slots=8, max_len=256, prefill_chunk=32,
                              decode_block=8),
        'seed': 1234,
    },
}


def preset(name):
    """The named preset spec (a copy), KeyError listing the zoo."""
    try:
        spec = PRESETS[name]
    except KeyError:
        raise KeyError('unknown preset %r; available: %s'
                       % (name, sorted(PRESETS))) from None
    return {'model': dict(spec['model']),
            'engine': spec['engine'],
            'engine_kwargs': dict(spec['engine_kwargs']),
            'seed': spec['seed']}


def build_model(name, state_dict=None, device='cuda', dtype=None,
                model=None):
    """The preset's model, eval mode, on `device`, its GPTConfig patched
    by `model` (kwargs) when given. Its weights are drawn from a generator
    seeded with the preset's pin (every process building the same preset
    holds bit-identical weights), then replaced by `state_dict` (the
    port's state_dict() form) when one is given."""
    from ...framework.dtype import to_torch_dtype
    from ...text.models.gpt import GPTConfig, GPTForCausalLM
    spec = preset(name)
    m = GPTForCausalLM(GPTConfig(**dict(spec['model'], **(model or {}))),
                       device=device, seed=spec['seed'])
    if state_dict is not None:
        m.load_state_dict(state_dict)
    if dtype is not None:
        m.to(to_torch_dtype(dtype))
    m.eval()
    return m


def build_engine(name, model=None, state_dict=None, device='cuda',
                 dtype=None, **overrides):
    """The preset's engine around `model` (built fresh if omitted).
    `overrides` patch engine kwargs (e.g. spec_k for a spec-decode
    variant) without forking the preset."""
    from ..engine import ContinuousBatchingEngine
    from ..paged_engine import PagedContinuousBatchingEngine
    spec = preset(name)
    if model is None:
        model = build_model(name, state_dict=state_dict, device=device,
                            dtype=dtype)
    kwargs = spec['engine_kwargs']
    kwargs.update(overrides)
    cls = PagedContinuousBatchingEngine if spec['engine'] == 'paged' \
        else ContinuousBatchingEngine
    return cls(model, **kwargs)


def publish_preset(registry, name, version='v0', device='cuda',
                   model=None):
    """Ship the preset's seeded weights into `registry` as a
    CRC-manifested artifact under (name, version), meta-stamped with
    the preset name (and the `model` overrides of a variant) so pullers
    can rebuild the architecture."""
    state = build_model(name, device=device, model=model).state_dict()
    meta = {'preset': name}
    if model:
        meta['model'] = dict(model)
    return registry.publish(name, version, state, meta=meta)


def host_factory(default_preset=None, device='cuda', dtype=None):
    """entry -> engine factory for ModelHost: loads the entry's state
    dict (CRC-checked by io_save) into the preset named by the entry's
    meta — or `default_preset` for entries published outside the zoo —
    patched by the meta's `model` overrides, if any."""
    def _factory(entry):
        pname = entry.meta.get('preset', default_preset)
        if pname is None:
            raise KeyError(
                'registry entry (%r, %r) has no preset meta and no '
                'default_preset was given' % (entry.model, entry.version))
        model = build_model(pname, state_dict=io_save.load(entry.path),
                            device=device, dtype=dtype,
                            model=entry.meta.get('model'))
        return build_engine(pname, model=model)
    return _factory
