"""PyTorch port: masking, LayerNorm, int8 quantization and weight
conversion against the JAX package (CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from hriemo.core import masking as JM
from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo.models import FusionWithEmotionDecoder
from hriemo.nn.layers import layer_norm_apply
from hriemo.ops import quant as JQ
import hriemo_torch.frontends as TF
import hriemo_torch.models as TM
from hriemo_torch.core import masking as TMK
from hriemo_torch.nn.layers import layer_norm
from hriemo_torch.ops import _cuda as TC
from hriemo_torch.ops import quant as TQ
from hriemo_torch.utils.convert import load_flat_params

from torch_port_helpers import FP32_TOL, flat, np32, one_torch_thread, port, same_config  # noqa: F401


def _masks(rng, b=4, l=11):
    lens = np.array([l, 0, 5, 1])[:b]
    return np.arange(l)[None, :] >= lens[:, None]   # row 1 fully padded


def test_masking_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 11, 6)).astype(np.float32)
    m = _masks(rng)
    for mask in (m, None):
        got = TMK.masked_mean(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
        ref = JM.masked_mean(jnp.asarray(x), None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(np32(got), np.asarray(ref), atol=FP32_TOL, rtol=FP32_TOL)
    # bf16 inputs accumulate in fp32 and come back in x's dtype
    got = TMK.masked_mean(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(m))
    assert got.dtype == torch.bfloat16
    for length in (5, 11, 15):
        np.testing.assert_array_equal(
            TMK.align_mask_to_length(torch.from_numpy(m), length).numpy(),
            np.asarray(JM.align_mask_to_length(jnp.asarray(m), length)))
    m2 = rng.random((4, 9)) < 0.3
    for a, t in ((m, m2), (m, None), (None, m2), (None, None)):
        got = TMK.build_fused_mask(None if a is None else torch.from_numpy(a),
                                   None if t is None else torch.from_numpy(t), 9)
        ref = JM.build_fused_mask(None if a is None else jnp.asarray(a),
                                  None if t is None else jnp.asarray(t), 9)
        if ref is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(np32(TMK.mask_to_bias(torch.from_numpy(m))),
                                  np.asarray(JM.mask_to_bias(jnp.asarray(m))))
    np.testing.assert_array_equal(
        TMK.invert_valid_mask(torch.tensor([[1, 0, 1]])).numpy(),
        np.asarray(JM.invert_valid_mask(jnp.asarray([[1, 0, 1]]))))


def test_fully_padded_row_is_uniform_not_nan():
    """NEG_INF is additive and finite: a fully padded key row softmaxes to
    a uniform distribution."""
    bias = TMK.mask_to_bias(torch.ones((1, 5), dtype=torch.bool))
    p = torch.softmax(torch.zeros(1, 1, 1, 5) + bias, -1)
    np.testing.assert_allclose(p.numpy(), np.full((1, 1, 1, 5), 0.2), atol=FP32_TOL)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    for eps in (1e-5, 1e-12):
        got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), eps)
        ref = layer_norm_apply({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                               jnp.asarray(x), eps)
        np.testing.assert_allclose(np32(got), np.asarray(ref), atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal(dtype):
    rng = np.random.default_rng(2)
    w = (rng.standard_normal((64, 48)) * 0.05).astype(np.float32)
    w[3] = 0.0  # the eps clamp
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    jq = JQ.quantize_linear_params({"weight": jw})
    tq, ts = TQ.quantize_linear_params(tw)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq["w_int8"]))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jq["w_scale"]))
    jr, jrs = JQ.quantize_rowwise(jw)
    tr, trs = TQ.quantize_rowwise(tw)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(trs.numpy(), np.asarray(jrs))


def test_int8_linear_matches_jax():
    """fp32 activations: the same int8 math gives the same fp32 result up
    to the dequant's rounding."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((96, 64)) * 0.05).astype(np.float32)
    b = rng.standard_normal(96).astype(np.float32)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    jp = JQ.quantize_linear_params({"weight": jnp.asarray(w), "bias": jnp.asarray(b)})
    ref = JQ.int8_linear(jp, jnp.asarray(x))
    wq, ws = TQ.quantize_linear_params(torch.from_numpy(w))
    got = TQ.int8_linear(torch.from_numpy(x), wq, ws, torch.from_numpy(b))
    np.testing.assert_allclose(np32(got), np.asarray(ref), atol=FP32_TOL, rtol=FP32_TOL)
    assert TQ.int8_linear.launches == 0  # CPU tensors take the plain version


@pytest.mark.parametrize("route", [None, "fused", "chain"])
def test_cpu_int8_linear_takes_plain_on_either_route(route):
    """On CPU tensors int8_linear runs its plain version whatever the route
    argument (chosen or forced): the JAX result, no launch, no route
    counted."""
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((768, 512)) * 0.05).astype(np.float32)
    x = rng.standard_normal((3, 7, 512)).astype(np.float32)
    jp = JQ.quantize_linear_params({"weight": jnp.asarray(w)})
    ref = JQ.int8_linear(jp, jnp.asarray(x))
    wq, ws = TQ.quantize_linear_params(torch.from_numpy(w))
    routes = dict(TQ.int8_linear.routes)
    got = TQ.int8_linear(torch.from_numpy(x), wq, ws, route=route)
    np.testing.assert_allclose(np32(got), np.asarray(ref), atol=FP32_TOL, rtol=FP32_TOL)
    assert TQ.int8_linear.launches == 0 and dict(TQ.int8_linear.routes) == routes


@pytest.mark.parametrize("n,k,out_bytes,config,want", [
    (2304, 768, 2, -1, (0, 6)),    # the WavLM sublayer's q/k/v: 6 blocks of 384
    (768, 768, 2, -1, (0, 2)),     # its out-projection, int8_linear 768 -> 768
    (768, 768, 4, -1, (0, 2)),     # fp32 x: fp32 rows staged
    (768, 768, 2, 1, (1, 3)),      # 3 x 256 forced
    (768, 512, 2, -1, (0, 2)),     # the feature projection
    (2048, 768, 2, -1, (1, 8)),    # the decoder's FFN in: 8 x 256
    (768, 2048, 2, -1, (1, 3)),    # and out: K past the 384-column block's memory
    (768, 2048, 4, -1, (1, 3)),
    (256, 512, 4, -1, (1, 1)),
    (256, 256, 4, -1, None),       # 64 fp32 rows of 264 do not fit two A tiles and the ring
    (200, 256, 2, -1, None),       # no block spans 200 columns
    (768, 3072, 2, -1, None),      # K past both blocks' shared memory
    (8192, 256, 2, -1, None),      # past the largest cluster
    (768, 760, 2, -1, None),       # K % 16
])
def test_proj_cluster_choice(n, k, out_bytes, config, want):
    """The projection's block and cluster by output and input width and the
    stored element's bytes (plain Python; the card holds the kernels)."""
    assert TC.proj_cluster(n, k, out_bytes, config) == want


def test_proj_cluster_spans_every_path_width():
    """Every (N, K) of the served forward's projections has a cluster, for
    bf16 and fp32 outputs: the sublayer's q/k/v and out-projection,
    int8_linear's decoder, decoder FFN and feature-projection widths."""
    for n, k in ((2304, 768), (768, 768), (768, 512), (2048, 768), (768, 2048)):
        for out_bytes in (2, 4):
            cfg, blocks = TC.proj_cluster(n, k, out_bytes)
            bn, most, kmax = TC.PROJ_CONFIGS[cfg]
            assert bn * blocks == n and blocks <= most and k <= kmax


@pytest.mark.parametrize("n,m,k,out_bytes,sms,want", [
    (768, 23808, 512, 2, 132, "fused"),   # the feature projection at 1.25 s (384 x 62)
    (768, 15968, 512, 2, 132, "fused"),   # and at 10 s (32 x 499)
    (768, 15968, 512, 4, 132, "fused"),   # fp32 x
    (768, 1996, 512, 2, 132, "chain"),    # phase 4's 10 s batch: 0.48 waves of 2 x 384
    (768, 3072, 768, 2, 132, "fused"),    # the decoder's cross-attention k/v at 1.25 s
    (768, 1536, 768, 2, 132, "chain"),    # its 4-query rows at 1.25 s (384 x 4)
    (768, 1536, 768, 2, 66, "fused"),     # the same grid on half the SMs
    (2048, 1536, 768, 2, 132, "fused"),   # the decoder FFN's first Linear: 1.45 waves of 8 x 256
    (768, 1536, 2048, 2, 132, "chain"),   # its second: 0.55 waves of 3 x 256
    (768, 128, 768, 2, 132, "chain"),     # the 10 s batch's 32 x 4 rows
    (200, 30000, 256, 2, 132, "chain"),   # no cluster spans 200 columns
])
def test_proj_route_choice(n, m, k, out_bytes, sms, want):
    """int8_linear's route by rows, widths and the card's SMs (plain
    Python; the card holds each route's output and time)."""
    assert TC.proj_route(n, m, k, out_bytes, sms) == want


@pytest.mark.parametrize("n,m,k,want", [
    (2304, 23808, 768, (1, 9)),   # the q/k/v projection at 1.25 s: 256-column blocks
    (2304, 4096, 768, (1, 9)),    # 4.4 waves of 9 x 256
    (2304, 3072, 768, (0, 6)),    # 3.3 waves: the 384-column block
    (768, 23808, 768, (0, 2)),    # below 2048 columns the widest block spans
    (2048, 23808, 768, (1, 8)),   # only the 256-column block spans 2048
])
def test_proj_block_choice(n, m, k, want):
    """The projection's block by rows where both blocks span its width."""
    assert TC.proj_block(n, m, k) == want


def _tiny_models():
    d = 256
    wc = WavLMConfig.tiny(hidden_size=d, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=1)
    bc = BertConfig.tiny(hidden_size=d, num_attention_heads=4, intermediate_size=512,
                         num_hidden_layers=1)
    fkw = dict(d_model=d, num_emotions=4, n_heads=8, num_layers_fusion=1,
               num_layers_decoder=1, beta_hidden=128)
    return [(WavLMEncoder(wc), TF.WavLMEncoder(same_config(TF.WavLMConfig, wc))),
            (BertEncoder(bc), TF.BertEncoder(same_config(TF.BertConfig, bc))),
            (FusionWithEmotionDecoder(**fkw), TM.FusionWithEmotionDecoder(**fkw))]


def test_quantize_for_serving_bit_equal_to_jax_tree():
    """The serving recipe (bf16 cast, then quantize) gives the same int8
    weights, scales and remaining parameters, name for name, as
    quantize_tree_for_serving on the JAX tree."""
    for jm, tm in _tiny_models():
        port(jm, tm)
        jq = JQ.quantize_tree_for_serving(
            jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jm.params))
        TQ.quantize_for_serving(tm.to(torch.bfloat16))
        ref = flat(jq)
        got = tm.state_dict()
        assert sorted(got) == sorted(ref)
        assert TQ.count_quantized(tm) == JQ.count_quantized(jq) > 0
        for name, r in ref.items():
            g = got[name]
            if g.dtype == torch.bfloat16:
                np.testing.assert_array_equal(np32(g), r.astype(np.float32), err_msg=name)
            else:
                np.testing.assert_array_equal(g.numpy(), r, err_msg=name)


def test_load_flat_params_is_strict():
    jm, tm = _tiny_models()[1]
    params = flat(jm.params)
    load_flat_params(tm, params)
    name = "embeddings.LayerNorm.weight"
    with pytest.raises(KeyError):
        load_flat_params(tm, {k: v for k, v in params.items() if k != name})
    with pytest.raises(KeyError):
        load_flat_params(tm, {**params, "extra.weight": params[name]})
    with pytest.raises(ValueError):
        load_flat_params(tm, {**params, name: params[name][:-1]})
