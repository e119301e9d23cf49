"""The port's BERT (paddle_tpu_torch/text/models/bert.py) against the JAX
package's: a small BertForPretraining built in JAX, carried across with
load_bert_state and trained through TrainStep on both sides, with the fused
MLM loss and without; the sequence classifier's logits; ERNIE 1.0's
configuration; the pad mask each model builds; and the bf16 promotion of
the scores against the f32 mask."""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import functional as jfm
from paddle_tpu.text.models import bert as jbert
from paddle_tpu_torch.framework.functional import TrainStep
from paddle_tpu_torch.nn.functional import attention as tattn
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.text.models import bert as tbert

# tests/test_fused_ce.py's BERT size: 85% of the MLM labels ignored
VOCAB, BATCH, SEQ = 211, 4, 16
CFG = dict(vocab_size=VOCAB, hidden_size=32, num_hidden_layers=2,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=SEQ, hidden_dropout_prob=0.0,
           attention_probs_dropout_prob=0.0)
LR = 1e-3
# the update's distance from the JAX step's (over the model, the worst
# parameter); sound f32 runs read ~1e-4 or less
UPDATE_TOL = (2e-3, 2e-3)


@pytest.fixture(autouse=True)
def _interpret_strict(monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_FLASH_INTERPRET', '1')
    monkeypatch.setenv('PADDLE_TPU_FLASH_STRICT', '1')


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mlm = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mlm[rng.rand(BATCH, SEQ) > 0.15] = -100
    nsp = rng.randint(0, 2, (BATCH,)).astype(np.int64)
    return ids, mlm, nsp


def _carry(jm, tm):
    tbert.load_bert_state(tm, {k: np.asarray(v.numpy())
                               for k, v in jm.state_dict().items()})
    return tm


def _state(m):
    return {k: np.asarray(v.numpy()) if hasattr(v, '_data')
            else v.detach().float().numpy().astype(np.float64)
            for k, v in m.state_dict().items()}


def _update_errors(init, want, got):
    """||d_port - d_jax|| / ||d_jax|| over the model, and the worst such
    ratio of one parameter, without each self-attention key bias: its
    exact gradient is 0 (a bias on the keys shifts a query's scores
    alike), so Adam moves it by ~lr in whatever direction rounding
    gives."""
    num = den = worst = 0.0
    for name, start in init.items():
        d_jax = want[name].astype(np.float64) - start
        d_port = got[name] - start
        if name.endswith('self_attn.k_proj.bias'):
            continue
        assert np.any(d_jax != 0), ('the JAX step did not move', name)
        num += np.sum((d_port - d_jax) ** 2)
        den += np.sum(d_jax ** 2)
        worst = max(worst, np.linalg.norm(d_port - d_jax) /
                    np.linalg.norm(d_jax))
    return np.sqrt(num / den), worst


@pytest.mark.parametrize('fused', [False, True])
def test_pretraining_steps_match_jax(fused):
    ids, mlm, nsp = _batch()
    paddle.seed(0)
    jm = jbert.BertForPretraining(fused_mlm=fused, **CFG)
    tm = _carry(jm, tbert.BertForPretraining(fused_mlm=fused, device='cpu',
                                             **CFG))
    init = _state(tm)
    jstep = jfm.TrainStep(jm, lambda mo, no, ml, nl: jm.loss(mo, no, ml, nl),
                          paddle.optimizer.AdamW(learning_rate=LR,
                                                 parameters=jm.parameters()))
    tstep = TrainStep(tm, tm.loss, AdamW(learning_rate=LR,
                                         parameters=tm.parameters()))
    before = dict(tfa.counts)
    losses = []
    for _ in range(3):
        want = float(np.asarray(jstep(
            (paddle.to_tensor(ids),),
            (paddle.to_tensor(mlm), paddle.to_tensor(nsp))).numpy()))
        got = tstep((torch.from_numpy(ids).long(),),
                    (torch.from_numpy(mlm).long(),
                     torch.from_numpy(nsp))).item()
        losses.append((got, want))
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert losses[2][0] < losses[0][0]
    # BERT's own pad mask keeps every call off flash
    assert tfa.counts == before
    model, worst = _update_errors(init, _state(jm), _state(tm))
    assert model <= UPDATE_TOL[0] and worst <= UPDATE_TOL[1], (model, worst)


def test_fused_mlm_forward_and_refusal():
    tm = tbert.BertForPretraining(fused_mlm=True, device='cpu', **CFG)
    ids = torch.from_numpy(_batch()[0]).long()
    h, nsp = tm(ids)
    assert h.shape == (BATCH, SEQ, CFG['hidden_size'])
    tm.eval()
    logits, _ = tm(ids)
    assert logits.shape == (BATCH, SEQ, VOCAB) and nsp.shape == (BATCH, 2)
    with pytest.raises(ValueError, match='vocab_size != hidden_size'):
        tbert.BertForPretraining(fused_mlm=True, device='cpu',
                                 **dict(CFG, vocab_size=32))


def test_sequence_classification_logits_match_jax():
    ids = _batch(1)[0]
    ids[:, -3:] = 0  # pad positions: the mask hides them
    paddle.seed(1)
    jm = jbert.BertForSequenceClassification(num_classes=3, **CFG)
    tm = _carry(jm, tbert.BertForSequenceClassification(
        num_classes=3, device='cpu', **CFG))
    jm.eval()
    tm.eval()
    want = np.asarray(jm(paddle.to_tensor(ids)).numpy())
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (BATCH, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pad_mask_is_the_jax_models():
    """f32 [B, 1, 1, N], 0 at tokens and -1e9 at pads, built even when no
    token is a pad."""
    seen = []
    real = tattn._sdpa_ref

    def spy(q, k, v, mask, *args, **kw):
        seen.append(mask)
        return real(q, k, v, mask, *args, **kw)

    tm = tbert.BertModel(device='cpu', **CFG).eval()
    ids = _batch(2)[0]
    ids[0, -2:] = 0
    ids[1:] = np.maximum(ids[1:], 1)
    try:
        tattn._sdpa_ref = spy
        with torch.no_grad():
            tm(torch.from_numpy(ids).long())
    finally:
        tattn._sdpa_ref = real
    assert len(seen) == CFG['num_hidden_layers']
    mask = seen[0]
    assert mask.dtype == torch.float32 and mask.shape == (BATCH, 1, 1, SEQ)
    want = np.where(ids != 0, 0.0, -1e9)[:, None, None, :]
    np.testing.assert_array_equal(mask.numpy(), want.astype(np.float32))


def test_bf16_scores_meet_the_f32_mask_as_in_jax():
    """bf16 q, k, v and an f32 additive mask: both packages add the mask
    to the bf16 scores in f32 and take the softmax in f32."""
    from paddle_tpu.nn.functional import attention as jattn
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, 16, 4, 8).astype(np.float32) for _ in range(3))
    mask = np.where(rng.rand(2, 1, 1, 16) > 0.2, 0.0,
                    -1e9).astype(np.float32)
    bf = jax.numpy.bfloat16
    want = np.asarray(jattn.scaled_dot_product_attention(
        paddle.to_tensor(jax.numpy.asarray(q, bf)),
        paddle.to_tensor(jax.numpy.asarray(k, bf)),
        paddle.to_tensor(jax.numpy.asarray(v, bf)),
        attn_mask=paddle.to_tensor(mask))._data.astype(np.float32))
    got = tattn.scaled_dot_product_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
        attn_mask=torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of |o| < 4
    np.testing.assert_allclose(got.float().numpy(), want, atol=2 ** -6)


def test_ernie_1_0_configuration():
    paddle.seed(0)
    jm = jbert.ernie_1_0(num_hidden_layers=1, num_attention_heads=4,
                         intermediate_size=64, hidden_size=32)
    tm = tbert.ernie_1_0(num_hidden_layers=1, num_attention_heads=4,
                         intermediate_size=64, hidden_size=32,
                         device='cpu')
    assert isinstance(tm, tbert.ErnieModel) and \
        tbert.ErnieModel is tbert.BertModel
    shapes = {k: tuple(v.shape) for k, v in jm.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert shapes['embeddings.word_embeddings.weight'] == (18000, 32)


def test_load_bert_state_refuses_a_mismatch():
    tm = tbert.BertModel(device='cpu', **CFG)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    with pytest.raises(KeyError, match='missing'):
        tbert.load_bert_state(tm, dict(list(state.items())[1:]))
    state['pooler.dense.weight'] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match='pooler.dense.weight'):
        tbert.load_bert_state(tm, state)


def test_flops_per_token_counts_every_matmul():
    tm = tbert.BertForPretraining(device='cpu', **CFG)
    h, inter, L = 32, 64, 2
    want = 6 * (L * (4 * h * h + 2 * h * inter) + h * h + h * VOCAB) + \
        6 * L * 2 * h * SEQ
    assert tm.flops_per_token(SEQ) == want
