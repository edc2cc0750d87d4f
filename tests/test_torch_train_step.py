"""PyTorch port: losses, schedule, optimizer, train step, dropout and the
differentiable flash attention (hriemo_torch/train, hriemo_torch/parallel,
hriemo_torch/nn, hriemo_torch/ops/flash_attention.py) against the JAX
package's training path (CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.models import FusionWithEmotionDecoder, MoseiFusionWithEmotionDecoder
from hriemo.ops import flash_attention_pallas as JP
from hriemo.parallel import train_step as JS
from hriemo.train import losses as JL
import hriemo_torch.models as TM
from hriemo_torch.nn import attention as TA
from hriemo_torch.nn.layers import dropout
from hriemo_torch.ops import flash_attention as TF
from hriemo_torch.parallel import train_step as TS
from hriemo_torch.train import losses as TL

from torch_port_helpers import flat, np32, one_torch_thread, port  # noqa: F401

# The trainers' default learning rate. Adam moves every element by about lr
# a step, however small its gradient: an element whose gradient is 1e-9 of
# its leaf's largest (rounding noise) moves by ~lr in either sign, so the
# parameters' agreement after three steps scales with lr (4.3e-6 here,
# 4.3e-5 at lr 1e-3).
LR = 1e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- losses


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = np.clip(rng.standard_normal((16, 6)) * 12, -30, 30).astype(np.float32)
    logits[0, :2] = [30.0, -30.0]
    soft = rng.uniform(0, 1, (16, 6)).astype(np.float32)
    pw = rng.uniform(0.3, 3.0, 6).astype(np.float32)
    raw = rng.uniform(-1, 4, (16, 6)).astype(np.float32)
    labels = rng.integers(0, 6, 16)
    beta = np.concatenate([rng.uniform(0, 1, 14), [0.0, 1.0]]).astype(np.float32)[:, None]
    cases = [
        (TL.bce_with_logits(_t(logits), _t(soft)), JL.bce_with_logits(logits, soft)),
        (TL.bce_with_logits(_t(logits), _t(soft), _t(pw)),
         JL.bce_with_logits(logits, soft, jnp.asarray(pw))),
        (TL.softmax_cross_entropy(_t(logits), _t(labels)),
         JL.softmax_cross_entropy(logits, jnp.asarray(labels))),
        (TL.beta_entropy_loss(_t(beta)), JL.beta_entropy_loss(beta)),
        (TL.beta_degeneracy_reward(_t(beta)), JL.beta_degeneracy_reward(beta)),
    ]
    for got, ref in cases:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(TL.normalize_mosei_emotions(_t(raw)).numpy(),
                               np.asarray(JL.normalize_mosei_emotions(raw)), rtol=1e-6)


# -------------------------------------------------------------- schedule


@pytest.mark.parametrize("kw", [dict(schedule="warmup_cosine", warmup_steps=7, total_steps=40),
                                dict(schedule="warmup_cosine", warmup_steps=0, total_steps=9),
                                dict(schedule="constant", total_steps=12)])
def test_schedule_matches_optax_at_every_step(kw):
    jsched = JS.make_schedule(JS.TrainConfig(lr=3e-4, **kw))
    tsched = TS.make_schedule(TS.TrainConfig(lr=3e-4, **kw))
    steps = np.arange(kw["total_steps"] + 3, dtype=np.int32)
    ref = np.asarray([float(jsched(jnp.int32(s))) for s in steps])
    got = tsched(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-7 * 3e-4)


# ------------------------------------------------------------- optimizer


class _Params(torch.nn.Module):
    def __init__(self, arrays):
        super().__init__()
        self.ps = torch.nn.ParameterList(torch.nn.Parameter(_t(a).clone()) for a in arrays)


@pytest.mark.parametrize("chunk", [TS.UPDATE_CHUNK, 16])   # one chunk of leaves; two
def test_five_optimizer_updates_match_optax(monkeypatch, chunk):
    """Gradient norms above and below the clip, and a non-finite step that
    changes nothing and does not advance the schedule."""
    monkeypatch.setattr(TS, "UPDATE_CHUNK", chunk)
    cfg_kw = dict(lr=LR, grad_clip=1.0, warmup_steps=2, total_steps=8, weight_decay=0.05)
    jcfg, tcfg = JS.TrainConfig(**cfg_kw), TS.TrainConfig(**cfg_kw)
    rng = np.random.default_rng(1)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (3,), (4,))]
    scales = [3.0, 0.05, 1.0, float("nan"), 0.2]   # |g| ~ 8.6, 0.14, 2.9, NaN, 0.57
    tx, jsched = JS.make_optimizer(jcfg)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = tx.init(jp)
    state = TS.create_train_state(_Params(params), tcfg)
    sched = TS.make_schedule(tcfg)
    for step, s in enumerate(scales):
        grads = [(rng.standard_normal(p.shape) * s).astype(np.float32) for p in params]
        if np.isnan(s):
            grads = [np.where(np.arange(g.size).reshape(g.shape) == 1, np.nan, 0.1)
                     .astype(np.float32) for g in grads]
        ref_lr = float(jsched(step - int(jstate.total_notfinite)))
        upd, jstate = tx.update({str(i): jnp.asarray(g) for i, g in enumerate(grads)},
                                jstate, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)
        norm, lr = TS.apply_update(state, [_t(g) for g in grads], tcfg, sched)
        np.testing.assert_allclose(float(lr), ref_lr, rtol=1e-6)
        for i, p in enumerate(state.model.ps):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[str(i)]),
                                       rtol=1e-6, atol=1e-7, err_msg=f"step {step} leaf {i}")
    assert int(state.total_notfinite) == int(jstate.total_notfinite) == 1
    assert int(state.step) == 5 and int(state.count) == 4


# ------------------------------------------------------------ train step

SETTINGS = {
    # the MOSEI recipe: multi-label, pos_weight, beta entropy, normalized
    # labels, accum 2, warmup-cosine
    "mosei": dict(loss_type="multi_label", beta_entropy=1e-3, normalize_labels=True,
                  grad_accum=2, warmup_steps=1, total_steps=6, schedule="warmup_cosine"),
    # the IEMOCAP decoder recipe: single label, beta degeneracy, constant lr
    "iemocap": dict(loss_type="single_label", beta_degeneracy=0.01, schedule="constant",
                    total_steps=6),
}
TINY = dict(d_model=32, n_heads=4, num_layers_fusion=1, num_layers_decoder=1, beta_hidden=16,
            dropout=0.0)


def _models(setting):
    if setting == "mosei":
        kw = dict(d_audio=10, d_text=12, num_emotions=6, **TINY)
        jm = MoseiFusionWithEmotionDecoder(**kw)
        return jm, port(jm, TM.MoseiFusionWithEmotionDecoder(**kw))
    kw = dict(num_emotions=4, **TINY)
    jm = FusionWithEmotionDecoder(**kw)
    return jm, port(jm, TM.FusionWithEmotionDecoder(**kw))


def _batch(setting, rng, b=3, la=11, lt=7):
    accum = SETTINGS[setting]["grad_accum"] if setting == "mosei" else 1
    lead = (accum, b) if accum > 1 else (b,)
    da, dt = (10, 12) if setting == "mosei" else (32, 32)
    lens = lambda l: rng.integers(2, l + 1, size=lead)  # noqa: E731
    batch = {"h_a": rng.standard_normal(lead + (la, da)).astype(np.float32),
             "h_t": rng.standard_normal(lead + (lt, dt)).astype(np.float32),
             "mask_a": np.arange(la) >= lens(la)[..., None],
             "mask_t": np.arange(lt) >= lens(lt)[..., None]}
    batch["y"] = (rng.uniform(-1, 4, lead + (6,)).astype(np.float32) if setting == "mosei"
                  else rng.integers(0, 4, lead).astype(np.int32))
    return batch


def _cfgs(setting, dtype):
    kw = dict(SETTINGS[setting], lr=LR, weight_decay=0.05)
    if setting == "mosei":
        kw["pos_weight"] = np.asarray([0.5, 1.0, 2.0, 1.5, 0.8, 3.0], np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return JS.TrainConfig(compute_dtype=jdt, **kw), TS.TrainConfig(compute_dtype=dtype, **kw)


def _jax_grads(jm, cfg, params, batch):
    """The JAX step's averaged gradients, loss and mean beta."""
    @jax.jit
    def one(micro):
        (loss, (_, beta)), g = jax.value_and_grad(
            lambda p: JS._compute_loss(jm, cfg, p, micro, jax.random.key(0), train=True),
            has_aux=True)(params)
        return loss, g, jnp.mean(beta)
    if cfg.grad_accum == 1:
        return one(batch)
    outs = [one({k: v[i] for k, v in batch.items()}) for i in range(cfg.grad_accum)]
    inv = 1.0 / cfg.grad_accum
    grads = jax.tree_util.tree_map(lambda *g: sum(g) * inv, *(o[1] for o in outs))
    return sum(o[0] for o in outs) * inv, grads, sum(o[2] for o in outs) * inv


def _vanishing(name, tm, setting) -> bool:
    """Leaves whose whole gradient is 0 in exact arithmetic, by the shift
    invariance of softmax over the E logits of the single-label loss: the
    last decoder layer's norm3 bias and the out_proj bias move every logit
    of a row alike. Their computed gradients are rounding noise."""
    if setting != "iemocap":
        return False
    last = f"emotion_decoder.layers.{len(tm.emotion_decoder.layers) - 1}.norm3.bias"
    return name in (last, "emotion_decoder.out_proj.bias")


def _check_grads(tm, grads, ref, tol, setting):
    """fp32: each leaf within ``tol`` times its own max |g|; a vanishing leaf
    within ``tol`` times the largest |g| of all leaves."""
    ref = flat(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for (name, _), g in zip(tm.named_parameters(), grads):
        r = ref[name]
        scale = top if _vanishing(name, tm, setting) else np.abs(r).max()
        np.testing.assert_allclose(np32(g), r, rtol=0, atol=tol * scale, err_msg=name)


def _check_grads_bf16(tm, grads, ref, tol, setting):
    """bf16 compute: each leaf within ``tol`` in relative norm, ``|g - r| <=
    tol |r|``. Element by element bf16 gradients are not comparable at that
    tolerance, not even JAX's own: a ReLU unit whose pre-activation lies
    within a bf16 step of zero is on in one run and off in the other, and
    JAX's bf16 gradient of the decoder's linear1 misses its own fp32 one by
    13% of max |g|. In norm, no leaf of JAX's bf16 gradients is more than
    4.2% from its fp32 one."""
    ref = flat(ref)
    for (name, _), g in zip(tm.named_parameters(), grads):
        if _vanishing(name, tm, setting):
            continue
        r = ref[name]
        err = np.linalg.norm(np32(g) - r) / np.linalg.norm(r)
        assert err <= tol, (name, err)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_three_train_steps_match_jax_fp32(setting):
    jm, tm = _models(setting)
    jcfg, tcfg = _cfgs(setting, torch.float32)
    rng = np.random.default_rng(2)
    batches = [_batch(setting, rng) for _ in range(3)]
    tb = [{k: _t(v) for k, v in b.items()} for b in batches]

    loss, grads, _ = TS.compute_grads(tm, tcfg, tb[0])
    jloss, jgrads, _ = _jax_grads(jm, jcfg, jm.params, {k: jnp.asarray(v)
                                                         for k, v in batches[0].items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _check_grads(tm, grads, jgrads, 1e-5, setting)

    jstate = JS.create_train_state(jm, jcfg, params=jm.params)
    jstep = JS.make_train_step(jm, jcfg, donate=False)
    state = TS.create_train_state(tm, tcfg)
    step = TS.make_train_step(tm, tcfg)
    for i, b in enumerate(batches):
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                             jax.random.key(i))
        state, met = step(state, tb[i])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
        for key in ("lr", "mean_beta"):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5)
    ref = flat(jstate.params)
    for name, p in tm.named_parameters():
        got, r = np32(p), ref[name]
        if _vanishing(name, tm, setting):  # Adam's steps of the noise: either sign
            np.testing.assert_allclose(got, r, rtol=0, atol=3 * LR, err_msg=name)
            continue
        if name.endswith("in_proj_bias"):
            # the k-slice's gradient is 0 in exact arithmetic (softmax is
            # shift-invariant): Adam turns its rounding noise into steps of
            # either sign
            d = got.shape[0] // 3
            np.testing.assert_allclose(got[d:2 * d], r[d:2 * d], rtol=0, atol=3 * LR)
            got, r = np.delete(got, np.s_[d:2 * d]), np.delete(r, np.s_[d:2 * d])
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_train_step_bf16_compute_matches_jax(setting):
    """bf16 compute over fp32 masters: one step's loss and gradients."""
    jm, tm = _models(setting)
    jcfg, tcfg = _cfgs(setting, torch.bfloat16)
    batch = _batch(setting, np.random.default_rng(3))
    loss, grads, _ = TS.compute_grads(tm, tcfg, {k: _t(v) for k, v in batch.items()})
    assert all(g.dtype == torch.float32 for g in grads)
    jloss, jgrads, _ = _jax_grads(jm, jcfg, jm.params, {k: jnp.asarray(v)
                                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-2, atol=1e-2)
    _check_grads_bf16(tm, grads, jgrads, 5e-2, setting)


def test_eval_step_is_deterministic_and_matches_jax():
    jm, tm = _models("iemocap")
    jcfg, tcfg = _cfgs("iemocap", torch.float32)
    batch = _batch("iemocap", np.random.default_rng(4))
    loss, logits, beta = TS.make_eval_step(tm, tcfg)({k: _t(v) for k, v in batch.items()})
    jloss, jlogits, jbeta = JS.make_eval_step(jm, jcfg)(jm.params, {k: jnp.asarray(v)
                                                                    for k, v in batch.items()})
    assert not tm.training
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), atol=1e-5, rtol=1e-5)


def test_remat_gives_the_same_gradients_with_dropout():
    """remat recomputes the forward; the dropout masks come from generators
    made from the step generator's seed, so the recompute draws them again."""
    _, tm = _models("iemocap")
    for m in tm.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.3
    batch = {k: _t(v) for k, v in _batch("iemocap", np.random.default_rng(5)).items()}
    out = []
    for remat in (False, True):
        cfg = TS.TrainConfig(**dict(SETTINGS["iemocap"], remat=remat))
        gen = torch.Generator().manual_seed(11)
        out.append(TS.compute_grads(tm, cfg, batch, gen))
    np.testing.assert_array_equal(float(out[0][0]), float(out[1][0]))
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


# ------------------------------------------------- flash attention backward


def test_flash_mha_backward_matches_jax_streaming_reference():
    """Two 512-key blocks, the second partial, with padding; fp32."""
    rng = np.random.default_rng(6)
    b, h, l, hd = 1, 2, 600, 32
    q, k, v, g = (rng.standard_normal((b, h, l, hd)).astype(np.float32) for _ in range(4))
    mask = np.zeros((b, l), bool)
    mask[:, 570:] = True
    bias = np.where(mask, JP.NEG_INF, 0.0).astype(np.float32)
    _, vjp = jax.vjp(JP._streaming_reference, *(jnp.asarray(a) for a in (q, k, v, bias)))
    ref = vjp(jnp.asarray(g))[:3]
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = TF.flash_mha(tq, tk, tv, _t(mask))
    out.backward(_t(g))
    for got, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    # the forward is the kernel route (the plain one-pass version on the CPU)
    np.testing.assert_allclose(out.detach().numpy(),
                               TF.flash_mha_plain(*(_t(a) for a in (q, k, v)),
                                                  _t(mask)).numpy(), rtol=0, atol=0)


# ---------------------------------------------------------------- dropout


def test_dropout_keep_rate_scale_and_determinism():
    p, n = 0.3, 100_000
    x = torch.full((n,), 2.0)
    out = dropout(x, p, torch.Generator().manual_seed(5), True)
    kept = out != 0
    sigma = (n * p * (1 - p)) ** 0.5
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sigma
    torch.testing.assert_close(out[kept], x[kept] / (1 - p), rtol=0, atol=0)
    again = dropout(x, p, torch.Generator().manual_seed(5), True)
    assert torch.equal(again, out)
    other = dropout(x, p, torch.Generator().manual_seed(6), True)
    assert not torch.equal(other, out)
    xb = x.to(torch.bfloat16)
    assert dropout(xb, p, torch.Generator().manual_seed(5), True).dtype == torch.bfloat16


def test_dropout_identity_in_eval_and_at_zero_and_needs_a_generator():
    x = torch.randn(7, 5)
    assert dropout(x, 0.4, None, False) is x
    assert dropout(x, 0.0, None, True) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.4, None, True)
    _, tm = _models("iemocap")
    for m in tm.modules():
        if hasattr(m, "dropout") and isinstance(m.dropout, float):
            m.dropout = 0.2
    batch = {k: _t(v) for k, v in _batch("iemocap", np.random.default_rng(7)).items()}
    args = (batch["h_a"], batch["h_t"], batch["mask_a"], batch["mask_t"])
    with pytest.raises(ValueError, match="Generator"):
        tm.train()(*args)
    with torch.no_grad():
        a = tm.eval()(*args)[0]
        b = tm(*args, generator=torch.Generator().manual_seed(1))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_flash_mha_while_attention_dropout_is_active(monkeypatch):
    """JAX's routing exclusion: the fused core never holds the
    probabilities, so attention dropout keeps the per-op path."""
    calls = []
    real = TA.flash_mha
    monkeypatch.setattr(TA, "flash_mha", lambda *a: calls.append(1) or real(*a))
    mha = TA.MultiheadAttention(16, 2, dropout=0.1)
    torch.nn.init.normal_(mha.in_proj_weight, std=0.2)
    torch.nn.init.normal_(mha.out_proj.weight, std=0.2)
    x = torch.randn(1, 1024, 16)
    with torch.no_grad():
        mha.train()(x, x, x, None, torch.Generator().manual_seed(0))
        assert calls == []
        mha.dropout = 0.0
        mha(x, x, x)
        assert calls == [1]
        mha.dropout = 0.1
        mha.eval()(x, x, x)
        assert calls == [1, 1]
