"""PyTorch port: the int8 numerics report and the selective revert
(hriemo_torch/ops/quant.py ``int8_numerics_report``, ``exclude=``) against
the JAX package (hriemo/ops/quant.py), and trees in which one Linear of a
fused block is kept in full precision (CPU)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

from hriemo.frontends import BertConfig, BertEncoder, WavLMConfig, WavLMEncoder
from hriemo.models import FusionWithEmotionDecoder
from hriemo.nn.layers import linear_apply
from hriemo.ops import quant as JQ
import hriemo_torch.frontends as TF
import hriemo_torch.models as TM
from hriemo_torch.nn.layers import Linear, set_use_kernels
from hriemo_torch.ops import quant as TQ

from torch_port_helpers import (assert_kernel_close, flat, np32, one_torch_thread,  # noqa: F401
                                port, same_config)

# Statistics are float64 reductions of the same activations: relative 1e-4;
# deltas are differences of fp32 probabilities: 1e-5 absolute.
STATS_RTOL = 1e-4
DELTA_ATOL = 1e-5
D = 256


class Mlp(nn.Module):
    """tests/test_quant.py's models: ``l1`` (``l2``) and ``head`` Linears."""

    def __init__(self, params: dict):
        super().__init__()
        for name, p in params.items():
            o, i = p["weight"].shape
            self.add_module(name, Linear(i, o))
        with torch.no_grad():
            for name, p in params.items():
                self._modules[name].weight.copy_(torch.from_numpy(np.array(p["weight"])))
                self._modules[name].bias.copy_(torch.from_numpy(np.array(p["bias"])))


def _jax_apply(p, x):
    h = jax.nn.relu(linear_apply(p["l1"], x))
    if "l2" in p:
        h = jax.nn.relu(linear_apply(p["l2"], h))
    return {"probs": jax.nn.softmax(linear_apply(p["head"], h).astype(jnp.float32), -1)}


def _port_apply(m, x):
    h = torch.relu(m.l1(x))
    if hasattr(m, "l2"):
        h = torch.relu(m.l2(h))
    return {"probs": torch.softmax(m.head(h).float(), -1)}


def _outlier_model():
    """tests/test_quant.py::test_int8_report_outlier_mitigation's model."""
    rng = np.random.default_rng(0)
    d = 64
    lin = lambda o, i, s=0.3: {  # noqa: E731
        "weight": jnp.asarray(rng.standard_normal((o, i)).astype(np.float32)) * s / np.sqrt(i),
        "bias": jnp.zeros((o,), jnp.float32),
    }
    params = {"l1": lin(d, d, 4.0), "l2": lin(d, d, 4.0), "head": lin(8, d, 4.0)}
    params["l1"]["weight"] = params["l1"]["weight"].at[3].mul(300.0)
    x = np.asarray(rng.standard_normal((32, d)).astype(np.float32))
    return params, x, dict(envelope=0.01, min_dim=8, max_reverts=3)


def _clean_model():
    """tests/test_quant.py::test_int8_report_clean_weights_within_envelope's model."""
    rng = np.random.default_rng(1)
    d = 64
    lin = lambda o, i: {  # noqa: E731
        "weight": jnp.asarray(rng.standard_normal((o, i)).astype(np.float32)) / np.sqrt(i),
        "bias": jnp.zeros((o,), jnp.float32),
    }
    params = {"l1": lin(d, d), "head": lin(8, d)}
    x = np.asarray(rng.standard_normal((16, d)).astype(np.float32))
    return params, x, dict(envelope=0.02, min_dim=8)


def _assert_reports_equal(got, ref):
    for key in ("envelope", "gate_output", "n_quantized_layers", "reverted_layers",
                "within_envelope"):
        assert got[key] == ref[key], (key, got[key], ref[key])
    assert list(got["activation_amax"]) == list(ref["activation_amax"])
    for name, st in ref["activation_amax"].items():
        for k, v in st.items():
            np.testing.assert_allclose(got["activation_amax"][name][k], v, rtol=STATS_RTOL,
                                       err_msg=f"{name} {k}")
    for which in ("deltas_full_int8", "deltas_final"):
        assert set(got[which]) == set(ref[which])
        for k, v in ref[which].items():
            assert abs(got[which][k] - v) <= DELTA_ATOL, (which, k, got[which][k], v)


@pytest.mark.parametrize("make", [_outlier_model, _clean_model], ids=["outlier", "clean"])
def test_report_matches_jax(make):
    """The same report on tests/test_quant.py's two models: layer names,
    quantized-layer count, revert order, envelope verdict, statistics and
    deltas. The outlier model reverts ``l2`` first and ends within its
    envelope, in both packages."""
    params, x, kw = make()
    ref = JQ.int8_numerics_report(_jax_apply, params, (jnp.asarray(x),), **kw)
    model = Mlp(params)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = TQ.int8_numerics_report(_port_apply, model, (torch.from_numpy(x),), **kw)
    _assert_reports_equal(got, ref)
    # the caller's module is never changed
    after = model.state_dict()
    assert set(after) == set(before) and all(torch.equal(after[k], before[k]) for k in before)
    assert TQ.count_quantized(model) == 0
    if make is _outlier_model:
        assert got["reverted_layers"][0] == "l2" and got["within_envelope"]
        assert got["deltas_full_int8"]["probs"] > 0.01


def test_exclude_keeps_paths_and_their_subtrees_in_full_precision():
    """``exclude`` takes the JAX tree's "a/b/c" paths: an excluded MHA keeps
    its in_proj and its out_proj, an excluded Linear only itself; the int8
    weights of every other layer are bit-equal to the JAX package's."""
    fusion = FusionWithEmotionDecoder(d_model=D, num_emotions=4, n_heads=8, num_layers_fusion=1,
                                      num_layers_decoder=1, beta_hidden=256)
    tf = port(fusion, TM.FusionWithEmotionDecoder(d_model=D, num_emotions=4, n_heads=8,
                                                  num_layers_fusion=1, num_layers_decoder=1,
                                                  beta_hidden=256))
    full = TQ.quantize_for_serving(copy.deepcopy(tf))
    paths = TQ.quantized_layer_paths(full)
    assert paths == JQ.quantized_layer_paths(JQ.quantize_tree_for_serving(fusion.params))
    mha = next(p for p in paths if p.endswith("attn"))
    lin = next(p for p in paths if not p.startswith(mha)
               and not any(q.startswith(p + "/") for q in paths))
    exclude = frozenset({mha, lin})
    jq = flat(JQ.quantize_tree_for_serving(fusion.params, exclude=exclude))
    tq = TQ.quantize_for_serving(tf, exclude=exclude)
    got = {k: v.numpy() for k, v in tq.state_dict().items()}
    assert set(got) == set(jq)
    for k, v in jq.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert TQ.count_quantized(tq) == JQ.count_quantized(
        JQ.quantize_tree_for_serving(fusion.params, exclude=exclude)) == len(paths) - 3
    assert any(k.startswith(mha.replace("/", ".") + ".in_proj_weight") for k in got)
    assert any(k.startswith(mha.replace("/", ".") + ".out_proj.weight") for k in got)


def _full_stack():
    """WavLM, BERT and the fusion model at 256 wide (one layer, intermediate
    512), where min_dim = 256 quantizes all three, as
    tests/test_torch_e2e_infer.py's ``--int8`` case."""
    wc = WavLMConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                          num_hidden_layers=1)
    bc = BertConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                         num_hidden_layers=1)
    fk = dict(d_model=D, num_emotions=4, n_heads=8, num_layers_fusion=1,
              num_layers_decoder=1, beta_hidden=256)
    # seeds of their own: at one seed WavLM's and BERT's 256 x 256 weights
    # come out bit-equal, and the JAX collector, which names a layer by a
    # hash of its int8 weight, would merge them
    jw, jb, jf = WavLMEncoder(wc, seed=1), BertEncoder(bc, seed=2), FusionWithEmotionDecoder(**fk)
    tm = nn.ModuleDict({
        "w": port(jw, TF.WavLMEncoder(same_config(TF.WavLMConfig, wc))),
        "b": port(jb, TF.BertEncoder(same_config(TF.BertConfig, bc))),
        "f": port(jf, TM.FusionWithEmotionDecoder(**fk))}).eval()
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
    wmask = (np.arange(1600)[None, :] < np.array([[1600], [1200]])).astype(np.int32)
    ids = rng.integers(0, bc.vocab_size, (2, 12))
    tmask = (np.arange(12)[None, :] < np.array([[12], [7]])).astype(np.int32)

    def jax_apply(p, wav, wmask, ids, tmask):
        h_a, fmask = jw.apply(p["w"], wav, wmask)
        h_t, _ = jb.apply(p["b"], ids, tmask)
        logits, beta, _ = jf.apply(p["f"], h_a, h_t.astype(h_a.dtype), fmask == 0, tmask == 0)
        return {"probs": jax.nn.sigmoid(logits), "beta": beta}

    def port_apply(m, wav, wmask, ids, tmask):
        h_a, fmask = m["w"](wav, wmask)
        h_t, _ = m["b"](ids, tmask)
        logits, beta, _ = m["f"](h_a, h_t.to(h_a.dtype), fmask == 0, tmask == 0)
        return {"probs": torch.sigmoid(logits.float()), "beta": beta.float()}

    args = (wav, wmask, ids, tmask)
    jparams = {"w": jw.params, "b": jb.params, "f": jf.params}
    return (jax_apply, jparams, tuple(jnp.asarray(a) for a in args),
            port_apply, tm, tuple(torch.from_numpy(a) for a in args))


def test_full_stack_report_names_match_jax():
    """At 256 wide the port's report names JAX's layers (WavLM, BERT, and
    the fusion model's packed MHA slices ``in_proj_q/k/v``), counts JAX's
    quantized layers and reads the same statistics; its deltas are finite
    and small."""
    jax_apply, jparams, jargs, port_apply, tm, targs = _full_stack()
    ref = JQ.int8_numerics_report(jax_apply, jparams, jargs, envelope=1.0)
    got = TQ.int8_numerics_report(port_apply, tm, targs, envelope=1.0)
    assert got["n_quantized_layers"] == ref["n_quantized_layers"] > 20
    assert set(got["activation_amax"]) == set(ref["activation_amax"])
    assert any(n.endswith("/in_proj_q") for n in got["activation_amax"])
    assert {n.split("/")[0] for n in got["activation_amax"]} == {"w", "b", "f"}
    for name, st in ref["activation_amax"].items():
        assert got["activation_amax"][name]["rows"] == st["rows"], name
        np.testing.assert_allclose(got["activation_amax"][name]["crest_p90"], st["crest_p90"],
                                   rtol=1e-3, err_msg=name)
    assert got["reverted_layers"] == [] and got["within_envelope"]
    for k in ("probs", "beta"):
        assert 0 < got["deltas_full_int8"][k] < 0.05, got["deltas_full_int8"]


def _mixed(which: str):
    """One WavLM (two layers) or BERT (two layers) encoder at 256 wide, and
    its quantized JAX tree and port module with one Linear of layer 0's
    block kept in full precision."""
    if which == "wavlm":
        cfg = WavLMConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                               num_hidden_layers=2)
        enc, tenc = WavLMEncoder(cfg), TF.WavLMEncoder(same_config(TF.WavLMConfig, cfg))
        path = "encoder/layers/0/feed_forward/output_dense"
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((2, 1600)) * 0.1).astype(np.float32)
        m = (np.arange(1600)[None, :] < np.array([[1600], [1100]])).astype(np.int32)
    else:
        cfg = BertConfig.tiny(hidden_size=D, num_attention_heads=4, intermediate_size=512,
                              num_hidden_layers=2)
        enc, tenc = BertEncoder(cfg), TF.BertEncoder(same_config(TF.BertConfig, cfg))
        path = "encoder/layer/0/attention/self/key"
        rng = np.random.default_rng(6)
        x = rng.integers(0, cfg.vocab_size, (2, 12))
        m = (np.arange(12)[None, :] < np.array([[12], [8]])).astype(np.int32)
    tenc = port(enc, tenc).eval()
    jq = JQ.quantize_tree_for_serving(enc.params, exclude=frozenset({path}))
    return enc, jq, tenc, path, x, m


def test_mixed_wavlm_tree_runs_and_matches_jax():
    """Layer 0's FFN ``output_dense`` kept in full precision: that FFN runs
    per op, every other block (layer 0's attention, layer 1) on its fused
    route, and the encoder matches JAX's CPU route at the kernel-path
    tolerance. With no fused block at all the port matches JAX's per-op
    route tightly."""
    enc, jq, tenc, path, x, m = _mixed("wavlm")
    ref, _ = enc.apply(jq, jnp.asarray(x), jnp.asarray(m))
    per_op = TQ.quantize_for_serving(copy.deepcopy(tenc),
                                     exclude=frozenset({path}), fuse_blocks=False)
    mixed = TQ.quantize_for_serving(tenc, exclude=frozenset({path}))
    l0, l1 = mixed.encoder.layers
    assert l0.ffn_ops is None and l0.feed_forward["output_dense"].w_int8 is None
    assert l0.attn_ops is not None and l1.attn_ops is not None and l1.ffn_ops is not None
    with torch.no_grad():
        got, _ = mixed(torch.from_numpy(x), torch.from_numpy(m))
        got_op, _ = per_op(torch.from_numpy(x), torch.from_numpy(m))
    assert_kernel_close(got, ref)
    np.testing.assert_allclose(np32(got_op), np32(ref), atol=1e-4, rtol=1e-4)


def test_mixed_bert_tree_runs_where_jax_raises():
    """Layer 0's ``key`` kept in full precision: the JAX package packs
    query/key/value once query and output are int8 and raises ``KeyError``
    (``hriemo/frontends/bert.py:61-71``); the port runs that self-attention
    per op, and matches its own fully per-op route at the kernel-path
    tolerance."""
    enc, jq, tenc, path, x, m = _mixed("bert")
    with pytest.raises(KeyError, match="w_int8"):
        enc.apply(jq, jnp.asarray(x), jnp.asarray(m))
    per_op = TQ.quantize_for_serving(copy.deepcopy(tenc),
                                     exclude=frozenset({path}), fuse_blocks=False)
    mixed = TQ.quantize_for_serving(tenc, exclude=frozenset({path}))
    l0, l1 = mixed.encoder.layer
    assert l0.mha_ops is None and l1.mha_ops is not None
    assert l0.ffn_ops is not None and l1.ffn_ops is not None
    with torch.no_grad():
        got, pooled = mixed(torch.from_numpy(x), torch.from_numpy(m))
        ref, _ = per_op(torch.from_numpy(x), torch.from_numpy(m))
    assert np.isfinite(np32(got)).all() and np.isfinite(np32(pooled)).all()
    assert_kernel_close(got, ref)


def test_full_trees_route_as_before():
    """A fully int8 tree fuses every block; ``fuse_blocks=False`` fuses
    none; a float tree quantizes nothing."""
    _, _, tenc, _, _, _ = _mixed("wavlm")
    q = TQ.quantize_for_serving(copy.deepcopy(tenc))
    assert all(layer.attn_ops is not None and layer.ffn_ops is not None
               for layer in q.encoder.layers)
    q = TQ.quantize_for_serving(copy.deepcopy(tenc), fuse_blocks=False)
    assert all(layer.attn_ops is None and layer.ffn_ops is None for layer in q.encoder.layers)
    assert TQ.count_quantized(q) == 12
    q = TQ.quantize_for_serving(tenc, exclude=frozenset({"encoder"}))
    assert TQ.count_quantized(q) == 0
    assert all(layer.attn_ops is None for layer in q.encoder.layers)


def test_collector_names_every_int8_linear_on_the_plain_route():
    """Under ``collect_activation_amax`` each int8 Linear that runs through
    ``int8_linear_plain`` records under its path; the report's statistics
    pass runs the copy with ``use_kernels=False``."""
    params, x, _ = _clean_model()
    q = set_use_kernels(TQ.quantize_for_serving(Mlp(params), min_dim=8, fuse_blocks=False),
                        False)
    with TQ.collect_activation_amax(q) as col:
        _port_apply(q, torch.from_numpy(x))
    st = col.stats()
    assert list(st) == ["l1", "head"] and st["l1"]["rows"] == 16
    assert TQ._AMAX_COLLECTOR is None
