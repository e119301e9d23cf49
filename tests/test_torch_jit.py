"""The port's jit.to_static (paddle_tpu_torch/jit/) against the JAX
package's.

The slice as a whole: a 2-layer, hidden-64 GPT (one head of 64, seq 512,
so each layer's attention takes the flash route and reaches the custom
ops) built in JAX and carried across with load_paddle_tpu_state, its
forward put under to_static in both packages, then the fused loss and its
backward: the loss and every parameter's gradient within rtol / atol
1e-4 of the JAX package's (whose Pallas kernels run through the
interpreter under strict mode). One graph and no break, one compile per
signature (a new one for a new shape and for eval()), the route counters
read per call, more signatures than TorchDynamo's recompile limit each
compiled, ProgramTranslator.enable(False), auto_cast, buffers written
back, the dropout model's graph breaks, and the error framing of
tests/test_to_static_errors.py.

Inductor compiles here with one compile thread (no pool of compile
workers beside the test workers); the GPT programs take 5-30 s each to
compile cold on the CPU, and share one module-scoped model.
"""
import numpy as np
import pytest
import torch
import torch._inductor.config as inductor_config

import paddle_tpu as paddle
import paddle_tpu_torch as tpt
from paddle_tpu.text.models.gpt import GPTConfig as JConfig
from paddle_tpu.text.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.jit.error import ToStaticError
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.text.models import gpt as tgpt

CFG = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=1,
           max_position_embeddings=512, dropout=0.0, fused_loss=True)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')
    monkeypatch.setattr(inductor_config, 'compile_threads', 1)


def _batch(b, n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, CFG['vocab_size'], (b, n)).astype(np.int64),
            rng.randint(0, CFG['vocab_size'], (b, n)).astype(np.int64))


def _pair(seed=21, **cfg):
    cfg = dict(CFG, **cfg)
    paddle.seed(seed)
    jm = JGPT(JConfig(**cfg))
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(**cfg), device='cpu')
    tgpt.load_paddle_tpu_state(tm, {k: np.asarray(v.numpy())
                                    for k, v in jm.state_dict().items()})
    return jm, tm


def _route_deltas(before):
    return {k: tfa.counts[k] - before[k] for k in ('flash', 'bwd_fused')}


@pytest.fixture(scope='module')
def trained():
    """Both packages' GPT under to_static, one training step's loss and
    gradients on each side, and the port's counters for two more steps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
        mp.setenv('PADDLE_TPU_FLASH_STRICT', '1')
        mp.setattr(inductor_config, 'compile_threads', 1)
        return _train_both()


def _train_both():
    jm, tm = _pair()
    ids, labels = _batch(2, 512, 0)
    paddle.jit.to_static(jm)
    jloss = jm.loss(jm(paddle.to_tensor(ids.astype(np.int32))),
                    paddle.to_tensor(labels.astype(np.int32)))
    jloss.backward()
    jgrads = {k: np.asarray(p.grad.numpy())
              for k, p in jm.named_parameters()}
    tpt.jit.to_static(tm)
    tids, tlabels = torch.from_numpy(ids), torch.from_numpy(labels)
    deltas = []
    for _ in range(3):
        tm.zero_grad(set_to_none=True)
        before = dict(tfa.counts)
        tloss = tm.loss(tm(tids), tlabels)
        tloss.backward()
        deltas.append(_route_deltas(before))
    tgrads = {k: p.grad.numpy().copy() for k, p in tm.named_parameters()}
    # the forward and the loss as one program over the to_static Layer
    # (the main path's form)
    step = tpt.jit.to_static(lambda i, lab: tm.loss(tm(i), lab))
    tm.zero_grad(set_to_none=True)
    before = dict(tfa.counts)
    sloss = step(tids, tlabels)
    sloss.backward()
    deltas.append(_route_deltas(before))
    sgrads = {k: p.grad.numpy().copy() for k, p in tm.named_parameters()}
    tm.zero_grad(set_to_none=True)
    return dict(jm=jm, tm=tm, ids=tids, labels=tlabels, deltas=deltas,
                jloss=float(np.asarray(jloss.numpy())),
                tloss=tloss.item(), jgrads=jgrads, tgrads=tgrads,
                step=step, sloss=sloss.item(), sgrads=sgrads)


def test_layer_forward_and_grads_match_jax(trained):
    np.testing.assert_allclose(trained['tloss'], trained['jloss'], **TOL)
    assert set(trained['tgrads']) == set(trained['jgrads'])
    for name, want in trained['jgrads'].items():
        np.testing.assert_allclose(trained['tgrads'][name], want,
                                   err_msg=name, **TOL)


def test_forward_and_loss_as_one_program_match_jax(trained):
    """The fused loss's custom ops inside the compiled program: loss and
    gradients against the JAX package's, from one graph."""
    np.testing.assert_allclose(trained['sloss'], trained['jloss'], **TOL)
    for name, want in trained['jgrads'].items():
        np.testing.assert_allclose(trained['sgrads'][name], want,
                                   err_msg=name, **TOL)
    step = trained['step']
    assert step.program_count() == 1 and step.compile_count() == 1


def test_route_counts_read_per_call(trained):
    # every step of a compiled program: one flash forward and one fused
    # backward per layer, counted as the ops run
    layers = CFG['num_layers']
    assert trained['deltas'] == [{'flash': layers,
                                  'bwd_fused': layers}] * 4


def test_one_compile_per_signature(trained):
    tm, ids = trained['tm'], trained['ids']
    static = tm.forward
    assert isinstance(static, tpt.jit.StaticFunction)
    assert static.program_count() == 1 and static.compile_count() == 1
    tm.eval()
    try:
        with torch.no_grad():
            out = tm(ids)
            tm(ids)
            assert static.program_count() == 2
            assert static.compile_count() == 2
            tm(ids[:1])                              # a new shape
            assert static.program_count() == 3
            assert static.compile_count() == 3
        jm = trained['jm']
        jm.eval()
        want = jm(paddle.to_tensor(ids.numpy().astype(np.int32)))
        np.testing.assert_allclose(out.numpy(), np.asarray(want.numpy()),
                                   **TOL)
    finally:
        tm.train()
        trained['jm'].train()


def test_explain_one_graph_no_break(trained):
    tm, ids, labels = trained['tm'], trained['ids'], trained['labels']
    explained = torch._dynamo.explain(tm.forward._fn)(ids)
    assert (explained.graph_count, explained.graph_break_count) == (1, 0)
    # the forward and the loss traced together: still one graph

    def step(i, lab):
        return tm.loss(tm(i), lab)
    explained = torch._dynamo.explain(step)(ids, labels)
    assert (explained.graph_count, explained.graph_break_count) == (1, 0)


def test_plain_function_grads_match_jax():
    """to_static on a function over a closed-over Layer: the gradients
    reach its parameters, as the JAX package's tape op gives them."""
    paddle.seed(4)
    jlayer = paddle.nn.Linear(4, 2)
    tlayer = tpt.nn.Linear(4, 2, device='cpu')
    with torch.no_grad():
        tlayer.weight.copy_(torch.from_numpy(np.asarray(
            jlayer.weight.numpy())))
        tlayer.bias.copy_(torch.from_numpy(np.asarray(jlayer.bias.numpy())))

    @paddle.jit.to_static
    def jfwd(x):
        return paddle.tanh(jlayer(x))

    @tpt.jit.to_static
    def tfwd(x):
        return torch.tanh(tlayer(x))

    x = np.random.RandomState(4).randn(3, 4).astype(np.float32)
    for _ in range(2):    # the JAX package's first call runs eagerly
        jout = jfwd(paddle.to_tensor(x))
    (jout * jout).sum().backward()
    tout = tfwd(torch.from_numpy(x))
    (tout * tout).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.numpy()), **TOL)
    np.testing.assert_allclose(tlayer.weight.grad.numpy(),
                               np.asarray(jlayer.weight.grad.numpy()), **TOL)
    np.testing.assert_allclose(tlayer.bias.grad.numpy(),
                               np.asarray(jlayer.bias.grad.numpy()), **TOL)
    assert tfwd.compile_count() == 1


def test_more_signatures_than_the_recompile_limit_each_compile():
    import torch._dynamo.config as dynamo_config
    limit = getattr(dynamo_config, 'recompile_limit',
                    getattr(dynamo_config, 'cache_size_limit', 8))

    @tpt.jit.to_static
    def f(x):
        return torch.sin(x) * 2 + 1

    shapes = range(1, limit + 3)
    for n in shapes:
        x = torch.arange(n, dtype=torch.float32)
        assert torch.allclose(f(x), torch.sin(x) * 2 + 1)
    # a program for each signature, none run eagerly
    assert f.program_count() == len(shapes)
    assert f.compile_count() == len(shapes)
    assert all(c == 1 for c in f.compiles.values())


def test_enable_false_runs_eagerly():
    @tpt.jit.to_static
    def f(x):
        return x * 3

    translator = tpt.jit.ProgramTranslator.get_instance()
    translator.enable(False)
    try:
        assert torch.equal(f(torch.ones(2)), torch.full((2,), 3.0))
        assert f.compile_count() == 0
    finally:
        translator.enable(True)
    f(torch.ones(2))
    assert f.compile_count() == 1


def test_auto_cast_is_part_of_the_signature():
    """The auto_cast state is part of the signature: the program compiled
    under auto_cast casts as the eager functional does (linear is white-
    listed: bf16 inputs), and the f32 program stays f32."""
    paddle.seed(5)
    lin = tpt.nn.Linear(8, 8, device='cpu')

    @tpt.jit.to_static
    def f(x):
        return tpt.nn.functional.linear(x, lin.weight, lin.bias)

    x = torch.randn(4, 8)
    plain = f(x)
    with tpt.amp.auto_cast(dtype='bfloat16'):
        cast = f(x)
        eager = tpt.nn.functional.linear(x, lin.weight, lin.bias)
    assert plain.dtype == torch.float32 and cast.dtype == torch.bfloat16
    assert torch.allclose(cast.float(), eager.float(), rtol=1e-2, atol=1e-2)
    assert torch.allclose(f(x), plain)
    assert f.program_count() == 2 and f.compile_count() == 2


class _Counter(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = tpt.nn.Linear(3, 3, device='cpu')
        self.register_buffer('calls', torch.zeros(()))
        self.register_buffer('running', torch.zeros(3))

    def forward(self, x):
        self.calls.add_(1)
        self.running.mul_(0.5).add_(x.mean(0).detach() * 0.5)
        return self.lin(x)


def test_buffers_the_forward_updates_are_written_back():
    torch.manual_seed(3)
    eager, static = _Counter(), _Counter()
    static.load_state_dict(eager.state_dict())
    tpt.jit.to_static(static)
    for seed in range(3):
        x = torch.randn(4, 3, generator=torch.Generator().manual_seed(seed))
        assert torch.allclose(static(x), eager(x))
    assert static.calls.item() == eager.calls.item() == 3
    assert torch.allclose(static.running, eager.running)
    assert static.forward.compile_count() == 1


def test_dropout_model_breaks_the_graph_and_compiles_in_pieces():
    """With attention dropout the attention takes _sdpa_ref, whose dropout
    mask comes from a generator state that TorchDynamo cannot trace:
    full_graph (the default) raises, naming the port's line; with
    full_graph=False the model compiles in pieces. Its output is the eager
    model's when Inductor draws its random numbers as eager code does
    (fallback_random)."""
    _, eager = _pair(seed=23, dropout=0.1)
    _, full = _pair(seed=23, dropout=0.1)
    _, pieces = _pair(seed=23, dropout=0.1)
    ids = torch.from_numpy(_batch(2, 64, 5)[0])
    tpt.jit.to_static(full)
    with pytest.raises(ToStaticError, match='gpt.py'):
        full(ids)
    tpt.jit.to_static(pieces, full_graph=False)
    before = dict(tfa.counts)
    with inductor_config.patch(fallback_random=True):
        for seed in (5, 6):
            torch.manual_seed(seed)
            got = pieces(ids)
            torch.manual_seed(seed)
            want = eager(ids)
            np.testing.assert_allclose(got.detach().numpy(),
                                       want.detach().numpy(),
                                       rtol=1e-5, atol=1e-5)
    assert pieces.forward.compile_count() > 1       # it compiled in pieces
    assert tfa.counts['flash'] == before['flash']    # never on the flash route


def test_traced_layer_runs_the_compiled_forward():
    layer = tpt.nn.Linear(4, 2, device='cpu')
    x = torch.randn(3, 4)
    out, traced = tpt.jit.TracedLayer.trace(layer, [x])
    assert torch.allclose(out, layer(x))
    assert torch.allclose(traced(x), out)
    assert traced._fn.compile_count() == 1


# ---- error framing (tests/test_to_static_errors.py) ----------------------


def test_data_dependent_branch_points_at_user_line():
    @tpt.jit.to_static
    def bad(x):
        s = torch.sum(x)
        if s > 0:                      # <- a Tensor-valued branch
            return x + 1
        return x - 1

    with pytest.raises(ToStaticError) as ei:
        bad(torch.ones(3))
    msg = str(ei.value)
    assert __file__.rstrip('c') in msg          # user file
    assert 'if s > 0:' in msg                   # offending source line
    assert 'cond' in msg                        # the torch.cond hint
    assert ei.value.__cause__ is not None       # original chained


def test_layer_method_trace_error_points_at_user_line():
    # TorchDynamo captures int() of a Tensor as a scalar, so the method's
    # untraceable construct is a Tensor-valued branch
    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = tpt.nn.Linear(4, 4, device='cpu')

        @tpt.jit.to_static
        def forward(self, x):
            y = self.lin(x)
            while y.sum() > 0:         # <- a Tensor-valued loop
                y = y - 1
            return y

    with pytest.raises(ToStaticError) as ei:
        M()(torch.ones(2, 4))
    msg = str(ei.value)
    assert __file__.rstrip('c') in msg
    assert 'while y.sum() > 0:' in msg


def test_successful_to_static_unaffected():
    @tpt.jit.to_static
    def good(x):
        return torch.relu(x) * 2

    x = torch.tensor([-1.0, 2.0])
    np.testing.assert_allclose(good(x).numpy(), [0.0, 4.0])
    np.testing.assert_allclose(good(x).numpy(), [0.0, 4.0])  # cached
    assert good.compile_count() == 1


def test_user_errors_propagate_unwrapped():
    @tpt.jit.to_static
    def boom(x):
        raise KeyError('user bug')

    with pytest.raises(KeyError, match='user bug'):
        boom(torch.ones(2))
