"""PyTorch port: the fusion model (cross-modal transformer, vector beta
gate, emotion decoder; hriemo_torch/models) against the JAX package (CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hriemo.models import FusionWithEmotionDecoder
from hriemo.ops.quant import quantize_tree_for_serving
import hriemo_torch.models as TM
from hriemo_torch.ops.quant import quantize_for_serving

from torch_port_helpers import assert_kernel_close, np32, one_torch_thread, port  # noqa: F401


def _inputs(rng, b, la, lt, d):
    """Sequences with ragged key-padding masks (True = PAD); element 0 is
    full length. ``la``/``lt`` None gives a 2-D (pooled) input."""
    def seq(l):
        if l is None:
            return rng.standard_normal((b, d)).astype(np.float32), None
        lens = np.concatenate([[l], rng.integers(1, l + 1, size=b - 1)])
        return (rng.standard_normal((b, l, d)).astype(np.float32),
                np.arange(l)[None, :] >= lens[:, None])
    return (*seq(la), *seq(lt))


def _run_jax(jm, params, h_a, m_a, h_t, m_t, dtype):
    opt = lambda m: None if m is None else jnp.asarray(m)
    return jm.apply(params, jnp.asarray(h_a, dtype), jnp.asarray(h_t, dtype), opt(m_a), opt(m_t))


def _run_port(tm, h_a, m_a, h_t, m_t, dtype):
    opt = lambda m: None if m is None else torch.from_numpy(m)
    with torch.no_grad():
        return tm(torch.from_numpy(h_a).to(dtype), torch.from_numpy(h_t).to(dtype),
                  opt(m_a), opt(m_t))


@pytest.mark.parametrize("la,lt", [(20, 7),      # audio longer: truncated to the text
                                   (5, 9),       # audio shorter: zero-padded, PAD in the mask
                                   (None, None)])  # 2-D inputs are lifted to [B, 1, d]
def test_fusion_fp32_matches_jax(la, lt):
    kw = dict(d_model=64, num_emotions=4, n_heads=8, num_layers_fusion=1,
              num_layers_decoder=1, beta_hidden=32)
    jm = FusionWithEmotionDecoder(**kw)
    tm = port(jm, TM.FusionWithEmotionDecoder(**kw)).eval()
    ins = _inputs(np.random.default_rng(7), 3, la, lt, 64)
    ref = _run_jax(jm, jm.params, *ins, jnp.float32)
    got = _run_port(tm, *ins, torch.float32)
    for g, r in zip(got, ref):   # logits [B, E], beta [B, 1], z [B, E, d]
        np.testing.assert_allclose(np32(g), np.asarray(r), atol=1e-4, rtol=1e-4)


def test_fusion_int8_matches_jax_kernel_path(monkeypatch):
    """W8A8 at d=256: self and cross MHA (audio 70 and text 12 rows) on the
    MHA kernel, the fusion FFNs and the beta-gate MLP (1024 -> 256 -> 256,
    wide enough for min_dim=256) on the mlp2 kernel, the decoder's 4-query attention per op; the JAX package on its kernel
    path in interpret mode."""
    monkeypatch.setenv("HRIEMO_FORCE_MEGAKERNELS", "1")
    kw = dict(d_model=256, num_emotions=4, n_heads=8, num_layers_fusion=1,
              num_layers_decoder=1, beta_hidden=256)
    jm = FusionWithEmotionDecoder(**kw)
    tm = port(jm, TM.FusionWithEmotionDecoder(**kw)).eval()
    quantize_for_serving(tm.to(torch.bfloat16))
    block = tm.cross_modal.layers[0]
    assert block.self_attn_a.ops is not None and block.ffn_a.ops is not None
    assert tm.beta_gate.mlp.ops is not None
    jp = quantize_tree_for_serving(
        jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jm.params))
    ins = _inputs(np.random.default_rng(8), 3, 70, 12, 256)
    ref = _run_jax(jm, jp, *ins, jnp.bfloat16)
    got = _run_port(tm, *ins, torch.bfloat16)
    for g, r in zip(got, ref):
        assert_kernel_close(g, np.asarray(r, np.float32))


def _unfolded_tacfn(block, h_a, h_t, mask_a, mask_t, generator):
    """The TACFN block's forward before its LayerNorms went into the MHA
    calls: ``ln(q + drop(mha(q, kv)))`` at each attention, the same
    generators drawn in the same order."""
    from hriemo_torch.models._common import RngStream
    from hriemo_torch.nn.layers import dropout
    rs = RngStream(generator)
    drop = lambda x: dropout(x, block.dropout, rs(), block.training)  # noqa: E731

    def attend(mha, q, kv, mask, ln):
        return ln(q + drop(mha(q, kv, kv, mask, rs())))

    h_a_self = attend(block.self_attn_a, h_a, h_a, mask_a, block.self_norm_a)
    h_t_self = attend(block.self_attn_t, h_t, h_t, mask_t, block.self_norm_t)
    h_a_cm = attend(block.attn_a2t, h_a_self, h_t_self, mask_t, block.norm_a1)
    h_a_cm = block.norm_a2(h_a_cm + drop(block.ffn_a(h_a_cm)))
    h_t_cm = attend(block.attn_t2a, h_t_self, h_a_self, mask_a, block.norm_t1)
    return h_a_cm, block.norm_t2(h_t_cm + drop(block.ffn_t(h_t_cm)))


@pytest.mark.parametrize("int8,training", [(False, True), (False, False), (True, False)])
def test_tacfn_block_layer_norm_fold_is_bit_equal(int8, training):
    """The TACFN block hands each attention's residual and LayerNorm to its
    MHA call when no dropout acts (eval: per op on fp32, the int8 MHA
    sublayer on the int8 tree); a training forward with dropout 0.1 keeps
    the unfolded path. Either way the result is the unfolded forward's bit
    for bit, on the same generator."""
    from hriemo_torch.nn.layers import init_torch_defaults
    d = 128
    block = TM.TacfnCrossModalBlock(d, 4, dropout=0.1)
    init_torch_defaults(block, torch.Generator().manual_seed(1))
    dtype = torch.float32
    if int8:
        dtype = torch.bfloat16
        quantize_for_serving(block.to(dtype), min_dim=64)
        assert block.self_attn_a.ops is not None and block.self_norm_a.fp32 is not None
    block.train(training)
    ins = _inputs(np.random.default_rng(9), 3, 20, 9, d)
    h_a, m_a, h_t, m_t = (torch.from_numpy(t) for t in ins)
    h_a, h_t = h_a.to(dtype), h_t.to(dtype)
    with torch.no_grad():
        got = block(h_a, h_t, m_a, m_t, torch.Generator().manual_seed(4))
        ref = _unfolded_tacfn(block, h_a, h_t, m_a, m_t, torch.Generator().manual_seed(4))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    if training:  # dropout acted: the eval forward differs
        block.eval()
        with torch.no_grad():
            assert not torch.equal(block(h_a, h_t, m_a, m_t)[0], got[0])
