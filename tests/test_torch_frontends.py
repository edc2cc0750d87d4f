"""PyTorch port: WavLM and BERT frontends against the JAX package (CPU).

The int8 cases force the JAX package onto its kernel path
(HRIEMO_FORCE_MEGAKERNELS=1: Pallas in interpret mode), the route the
port takes whatever the device."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo.frontends.wavlm import relative_position_buckets as jax_buckets
from hriemo.ops.conv_stack import group_norm_stats_from_waveform as jax_gn_stats
from hriemo.ops.quant import quantize_tree_for_serving
import hriemo_torch.frontends as TF
from hriemo_torch.frontends.wavlm import relative_position_buckets
from hriemo_torch.ops.conv_stack import group_norm_stats_from_waveform
from hriemo_torch.ops.quant import quantize_for_serving

from torch_port_helpers import (assert_kernel_close, np32, one_torch_thread,  # noqa: F401
                                port, same_config)

D = 256


@pytest.mark.parametrize("cfg", [WavLMConfig.base_plus(), WavLMConfig.tiny()])
def test_relative_position_buckets_identical(cfg):
    """The bucket of (i, j) depends on j - i only, so the table at
    L = 1024 (the longest length the attention kernel takes) contains
    the table of every shorter length, 62..499 on the serving path."""
    for length in (1024, 124):
        got = relative_position_buckets(same_config(TF.WavLMConfig, cfg), length).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax_buckets(cfg, length)))


def test_group_norm_stats_match_jax():
    rng = np.random.default_rng(0)
    wave = rng.standard_normal((2, 1603)).astype(np.float32) * 0.3
    w = rng.standard_normal((16, 1, 10)).astype(np.float32) * 0.3
    mean, var = group_norm_stats_from_waveform(torch.from_numpy(wave), torch.from_numpy(w))
    jm, jv = jax_gn_stats(jnp.asarray(wave), jnp.asarray(w))
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)


def _bf16_tree(t):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), t)


def _wave(rng):
    wav = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
    mask = (np.arange(1600)[None, :] < np.array([[1600], [1100]])).astype(np.int32)
    return wav, mask


def test_wavlm_fp32_matches_jax():
    """Float tree: the per-op route (einsum attention, unfused FFN)."""
    cfg = WavLMConfig.tiny()
    jm = WavLMEncoder(cfg)
    tm = port(jm, TF.WavLMEncoder(same_config(TF.WavLMConfig, cfg)))
    wav, mask = _wave(np.random.default_rng(1))
    ref, fm_ref = jm.apply(jm.params, jnp.asarray(wav), jnp.asarray(mask))
    with torch.no_grad():
        got, fm = tm(torch.from_numpy(wav), torch.from_numpy(mask))
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_ref))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_wavlm_int8_matches_jax_kernel_path(monkeypatch):
    monkeypatch.setenv("HRIEMO_FORCE_MEGAKERNELS", "1")
    cfg = WavLMConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                           num_hidden_layers=2, fast_gelu=True)
    jm = WavLMEncoder(cfg)
    tm = port(jm, TF.WavLMEncoder(same_config(TF.WavLMConfig, cfg)))
    quantize_for_serving(tm.to(torch.bfloat16))
    assert all(layer.attn_ops is not None and layer.ffn_ops is not None
               for layer in tm.encoder.layers)
    wav, mask = _wave(np.random.default_rng(2))
    ref, fm_ref = jm.apply(quantize_tree_for_serving(_bf16_tree(jm.params)),
                           jnp.asarray(wav, jnp.bfloat16), jnp.asarray(mask))
    with torch.no_grad():
        got, fm = tm(torch.from_numpy(wav).to(torch.bfloat16), torch.from_numpy(mask))
    assert got.shape[1] == 79  # >= 48 frames: the attention kernel's route
    np.testing.assert_array_equal(fm.numpy(), np.asarray(fm_ref))
    assert_kernel_close(got, np.asarray(ref, np.float32))


def _tokens(rng, b, l, vocab):
    ids = rng.integers(3, vocab, size=(b, l))
    lens = np.array([l] + list(rng.integers(2, l, size=b - 1)))
    mask = (np.arange(l)[None, :] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


def test_bert_fp32_matches_jax():
    cfg = BertConfig.tiny()
    jm = BertEncoder(cfg)
    tm = port(jm, TF.BertEncoder(same_config(TF.BertConfig, cfg)))
    ids, mask = _tokens(np.random.default_rng(3), 3, 12, cfg.vocab_size)
    ref, ref_pool = jm.apply(jm.params, jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got, pool = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(pool.numpy(), np.asarray(ref_pool), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):  # longer than max_position_embeddings
        tm(torch.zeros((1, cfg.max_position_embeddings + 1), dtype=torch.long))


def test_bert_int8_matches_jax_kernel_path(monkeypatch):
    monkeypatch.setenv("HRIEMO_FORCE_MEGAKERNELS", "1")
    cfg = BertConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=2, fast_gelu=True)
    jm = BertEncoder(cfg)
    tm = port(jm, TF.BertEncoder(same_config(TF.BertConfig, cfg)))
    quantize_for_serving(tm.to(torch.bfloat16))
    assert all(layer.mha_ops is not None and layer.ffn_ops is not None
               for layer in tm.encoder.layer)
    ids, mask = _tokens(np.random.default_rng(4), 5, 16, cfg.vocab_size)
    ref, ref_pool = jm.apply(quantize_tree_for_serving(_bf16_tree(jm.params)),
                             jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got, pool = tm(torch.from_numpy(ids), torch.from_numpy(mask))
    assert_kernel_close(got, np.asarray(ref, np.float32))
    assert_kernel_close(pool, np.asarray(ref_pool, np.float32))


def test_bert_int8_attention_takes_its_layer_norm_into_the_mha():
    """An int8 BERT layer hands its attention LayerNorm (eps 1e-12) to the
    MHA sublayer: on the CPU the result is the unfolded ``layer_norm(x +
    mha(x))`` of the parent bit for bit, through the LayerNorm's fp32 copies."""
    import hriemo_torch.ops.attention_block as TA
    from hriemo_torch.nn.layers import layer_norm
    cfg = TF.BertConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                             num_hidden_layers=1)
    tm = TF.BertEncoder(cfg)
    tm.init_weights(torch.Generator().manual_seed(3))
    quantize_for_serving(tm.to(torch.bfloat16))
    layer = tm.encoder.layer[0]
    ln = layer.attention["output"]["LayerNorm"]
    assert layer.mha_ops is not None and ln.fp32 is not None
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 16, D)).astype(np.float32)).to(torch.bfloat16)
    kpm = torch.from_numpy(np.arange(16)[None, :] >= np.array([[16], [9], [1]]))
    with torch.no_grad():
        got = layer._attention(x, kpm)
        ref = layer_norm(x + TA.mha_block_int8_plain(x, x, layer.mha_ops, kpm), ln.weight,
                         ln.bias, cfg.layer_norm_eps)
    assert torch.equal(got, ref)
