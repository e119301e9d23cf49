"""The rest of the port's losses (paddle_tpu_torch/nn/functional/loss.py
beyond cross-entropy, nn/layer/loss.py) against the JAX package's on the
same seeded numpy inputs.

Each case runs the JAX functional or layer inside one jitted program that
also takes jax.grad of sum(out * cotangent) for a seeded cotangent, and
the port's through autograd: outputs and the grads of every floating
input within 1e-5 (f32 elementwise math and small sums on both sides).
CTC is the JAX package's own function (log-softmax first, -1e30 for minus
infinity, 'mean' over label lengths, norm_by_times on the gradient only),
held to the JAX scan at every reduction, with norm_by_times and with a
row whose label cannot fit its input length (a loss near 1e30, where
torch's F.ctc_loss gives inf).
"""
import torch_threads  # noqa: F401  (first: torch's threads under xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework.core import Tensor as JTensor

import paddle_tpu_torch.nn as tnn
import paddle_tpu_torch.nn.functional as TF

TOL = 1e-5


def _close(got, want, tol=TOL, msg=''):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=msg)


def jax_fwd_grad(fn, args, seed):
    """fn's output on `args` (numpy) and the grads of sum(out * cot) for a
    seeded normal cotangent, from one jitted program."""
    shape = jax.eval_shape(fn, *args).shape
    cot = np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)

    def both(*a):
        return fn(*a), jax.grad(lambda *p: jnp.sum(fn(*p) * cot),
                                argnums=tuple(range(len(a))))(*a)
    out, grads = jax.jit(both)(*args)
    return np.asarray(out), [np.asarray(g) for g in grads], cot


def _check(case, args, seed=0, tol=TOL):
    """case(F, nn, T) -> a function of the floating inputs; F, nn are the
    package's functional and layer namespaces, T makes its constants."""
    jfn = case(JF, jnn, JTensor)
    want, grads, cot = jax_fwd_grad(
        lambda *a: jfn(*[JTensor(v) for v in a])._data, args, seed)
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    out = case(TF, tnn, torch.tensor)(*targs)
    assert tuple(out.shape) == want.shape
    _close(out, want, tol, 'forward')
    (out * torch.tensor(cot)).sum().backward()
    for i, (t, g) in enumerate(zip(targs, grads)):
        _close(t.grad, g, tol, 'grad of input %d' % i)


def _f32(a):
    return np.asarray(a, np.float32)


R = np.random.RandomState(0)
X45 = _f32(R.randn(4, 5))
Y45 = _f32(R.randn(4, 5))
P45 = _f32(R.uniform(0.05, 0.95, (4, 5)))
Q45 = _f32(R.uniform(0.0, 1.0, (4, 5)))
W5 = _f32(R.uniform(0.5, 1.5, (5,)))
LAB4 = np.array([1, 4, -100, 0], np.int64)
LAB4_C = np.array([[1], [4], [2], [0]], np.int64)
SIGN4 = _f32([1, -1, 1, -1])
LOGP = _f32(np.log(R.dirichlet(np.ones(5), 4)))
KL_LAB = _f32(np.concatenate([R.dirichlet(np.ones(5), 3),
                              [[0.5, 0.5, 0, 0, 0]]]))
X453 = _f32(R.randn(4, 5, 3))
LAB43 = R.randint(0, 5, (4, 3)).astype(np.int64)
LAB43[0, 1] = -100
A63, P63, N63 = (_f32(R.randn(6, 3)) for _ in range(3))
NPAIR_LAB = np.array([0, 1, 0, 2, 1, 3], np.int64)
DICE_X = _f32(R.dirichlet(np.ones(4), (3, 5)))          # [3, 5, 4]
DICE_LAB = R.randint(0, 4, (3, 5, 1)).astype(np.int64)
ML_LAB = _f32(R.randint(0, 2, (4, 5)))

# CTC: T 12, B 4, C 6, labels of up to 4; row 3's label (4 tokens, two
# repeats) needs 6 frames but has 5: infeasible
CTC_LOGITS = _f32(np.random.RandomState(3).randn(12, 4, 6))
CTC_LABELS = np.array([[1, 2, 3, 0], [2, 2, 0, 0], [5, 0, 0, 0],
                       [1, 1, 4, 4]], np.int64)
CTC_IL = np.array([12, 9, 7, 5], np.int64)
CTC_LL = np.array([3, 2, 1, 4], np.int64)


# (id, case, inputs): every functional of loss.py beyond cross_entropy,
# the options each takes, and 14 of the 15 layers over them (HSigmoidLoss
# is in test_torch_extension.py)
CASES = [
    ('swce-hard', lambda F, nn, T: lambda x: F.softmax_with_cross_entropy(
        x, T(LAB4_C)), [X45]),
    ('swce-soft', lambda F, nn, T: lambda x, y: F.softmax_with_cross_entropy(
        x, y, soft_label=True), [X45, Q45]),
    ('swce-softmax', lambda F, nn, T: lambda x: F.softmax_with_cross_entropy(
        x, T(LAB4_C), return_softmax=True)[1], [X45]),
    ('bce', lambda F, nn, T: lambda x, y: F.binary_cross_entropy(x, y),
     [P45, Q45]),
    ('bce-clip-weight-sum', lambda F, nn, T: lambda x, y:
     F.binary_cross_entropy(x, y, T(W5), 'sum'),
     [_f32(np.clip(P45 * 1.2 - 0.1, 0, 1)), Q45]),
    ('bce-logits', lambda F, nn, T: lambda x, y:
     F.binary_cross_entropy_with_logits(x, y), [X45, Q45]),
    ('bce-logits-pos-weight', lambda F, nn, T: lambda x, y:
     F.binary_cross_entropy_with_logits(x, y, T(W5), 'none', T(W5 * 2)),
     [X45, Q45]),
    ('nll', lambda F, nn, T: lambda x: F.nll_loss(x, T(LAB4)), [LOGP]),
    ('nll-weight', lambda F, nn, T: lambda x: F.nll_loss(x, T(LAB4),
                                                         T(W5)), [LOGP]),
    ('nll-weight-sum', lambda F, nn, T: lambda x: F.nll_loss(
        x, T(LAB4), T(W5), reduction='sum'), [LOGP]),
    ('nll-3d-none', lambda F, nn, T: lambda x: F.nll_loss(
        x, T(LAB43), reduction='none'), [X453]),
    ('mse', lambda F, nn, T: lambda x, y: F.mse_loss(x, y), [X45, Y45]),
    ('square-error', lambda F, nn, T: lambda x, y: F.square_error_cost(x, y),
     [X45, Y45]),
    ('l1-sum', lambda F, nn, T: lambda x, y: F.l1_loss(x, y, 'sum'),
     [X45, Y45]),
    ('smooth-l1', lambda F, nn, T: lambda x, y: F.smooth_l1_loss(
        x, y, 'none', 0.5), [X45, Y45]),
    ('kl-mean', lambda F, nn, T: lambda x, y: F.kl_div(x, y), [LOGP, KL_LAB]),
    ('kl-batchmean', lambda F, nn, T: lambda x, y: F.kl_div(
        x, y, 'batchmean'), [LOGP, KL_LAB]),
    ('margin-ranking', lambda F, nn, T: lambda x, y: F.margin_ranking_loss(
        x, y, T(SIGN4), 0.3), [X45[:, 0], Y45[:, 0]]),
    ('hinge-embedding', lambda F, nn, T: lambda x: F.hinge_embedding_loss(
        x, T(SIGN4), 0.5, 'none'), [X45[:, 0]]),
    ('cosine-embedding', lambda F, nn, T: lambda x, y:
     F.cosine_embedding_loss(x, y, T(SIGN4), 0.1), [X45, Y45]),
    ('log-loss', lambda F, nn, T: lambda x: F.log_loss(x, T(Q45)), [P45]),
    ('focal', lambda F, nn, T: lambda x: F.sigmoid_focal_loss(
        x, T(ML_LAB)), [X45]),
    ('focal-normalizer-mean', lambda F, nn, T: lambda x:
     F.sigmoid_focal_loss(x, T(ML_LAB), T(_f32([3.0])), 0.4, 1.5, 'mean'),
     [X45]),
    ('dice', lambda F, nn, T: lambda x: F.dice_loss(x, T(DICE_LAB)),
     [DICE_X]),
    ('npair', lambda F, nn, T: lambda a, p: F.npair_loss(a, p, T(NPAIR_LAB)),
     [A63, P63]),
    ('triplet', lambda F, nn, T: lambda a, p, n: F.triplet_margin_loss(
        a, p, n), [A63, P63, N63]),
    ('triplet-p3-swap', lambda F, nn, T: lambda a, p, n:
     F.triplet_margin_loss(a, p, n, 0.5, 3.0, 1e-6, True, 'none'),
     [A63, P63, N63]),
    ('ml-soft-margin', lambda F, nn, T: lambda x:
     F.multi_label_soft_margin_loss(x, T(ML_LAB), T(W5)), [X45]),
    ('soft-margin', lambda F, nn, T: lambda x: F.soft_margin_loss(
        x, T(2 * ML_LAB - 1), 'sum'), [X45]),
    # the layers
    ('MSELoss', lambda F, nn, T: lambda x, y: nn.MSELoss('sum')(x, y),
     [X45, Y45]),
    ('L1Loss', lambda F, nn, T: lambda x, y: nn.L1Loss()(x, y), [X45, Y45]),
    ('NLLLoss', lambda F, nn, T: lambda x: nn.NLLLoss(T(W5))(x, T(LAB4)),
     [LOGP]),
    ('BCELoss', lambda F, nn, T: lambda x, y: nn.BCELoss(T(W5))(x, y),
     [P45, Q45]),
    ('BCEWithLogitsLoss', lambda F, nn, T: lambda x, y: nn.BCEWithLogitsLoss(
        pos_weight=T(W5))(x, y), [X45, Q45]),
    ('KLDivLoss', lambda F, nn, T: lambda x, y: nn.KLDivLoss('sum')(x, y),
     [LOGP, KL_LAB]),
    ('SmoothL1Loss', lambda F, nn, T: lambda x, y: nn.SmoothL1Loss(
        delta=0.7)(x, y), [X45, Y45]),
    ('MarginRankingLoss', lambda F, nn, T: lambda x, y:
     nn.MarginRankingLoss(0.2)(x, y, T(SIGN4)), [X45[:, 1], Y45[:, 1]]),
    ('HingeEmbeddingLoss', lambda F, nn, T: lambda x:
     nn.HingeEmbeddingLoss(0.8)(x, T(SIGN4)), [X45[:, 2]]),
    ('CosineEmbeddingLoss', lambda F, nn, T: lambda x, y:
     nn.CosineEmbeddingLoss(0.2, 'sum')(x, y, T(SIGN4)), [X45, Y45]),
    ('TripletMarginLoss', lambda F, nn, T: lambda a, p, n:
     nn.TripletMarginLoss(margin=0.8, swap=True)(a, p, n), [A63, P63, N63]),
    ('SoftMarginLoss', lambda F, nn, T: lambda x: nn.SoftMarginLoss()(
        x, T(2 * ML_LAB - 1)), [X45]),
    ('MultiLabelSoftMarginLoss', lambda F, nn, T: lambda x:
     nn.MultiLabelSoftMarginLoss(reduction='none')(x, T(ML_LAB)), [X45]),
    ('CTCLoss', lambda F, nn, T: lambda x: nn.CTCLoss(0, 'sum')(
        x, T(CTC_LABELS), T(CTC_IL), T(CTC_LL), norm_by_times=True),
     [CTC_LOGITS]),
]


@pytest.mark.parametrize('case,args', [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_loss_matches_jax_forward_and_grads(case, args):
    _check(case, args)


@pytest.mark.parametrize('reduction,norm', [('mean', False), ('sum', False),
                                            ('none', False), ('mean', True),
                                            ('none', True)])
def test_ctc_matches_jax(reduction, norm):
    def case(F, nn, T):
        return lambda x: F.ctc_loss(x, T(CTC_LABELS), T(CTC_IL), T(CTC_LL),
                                    blank=0, reduction=reduction,
                                    norm_by_times=norm)
    _check(case, [CTC_LOGITS])


def test_ctc_infeasible_row_and_layer():
    x = torch.tensor(CTC_LOGITS, requires_grad=True)
    per_row = TF.ctc_loss(x, torch.tensor(CTC_LABELS), torch.tensor(CTC_IL),
                          torch.tensor(CTC_LL), reduction='none')
    assert 9e29 < per_row[3].item() < 1.1e30
    assert (per_row[:3] < 1e3).all()
    # the feasible rows agree with torch's CTC on the log-softmaxed input
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1), torch.tensor(CTC_LABELS),
        torch.tensor(CTC_IL), torch.tensor(CTC_LL), reduction='none')
    assert torch.isinf(ref[3])
    _close(per_row[:3], ref[:3].detach())
    layer = tnn.CTCLoss(blank=0, reduction='sum')
    _close(layer(x, torch.tensor(CTC_LABELS), torch.tensor(CTC_IL),
                 torch.tensor(CTC_LL)), per_row.sum().detach())


def test_loss_layers_keep_their_arguments():
    assert set(tnn.layer.loss.__all__) == set(jnn.layer.loss.__all__)
    assert set(TF.loss.__all__) == set(JF.loss.__all__)
