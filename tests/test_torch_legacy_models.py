"""PyTorch port: the legacy models (the bidirectional CrossModalBlock and
CrossModalTransformer, the scalar BetaGate and the FusionClassifier;
hriemo_torch/models) against the JAX package on the same parameters and
inputs, fp32 on the CPU in eval mode at 1e-5."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import hriemo.models as JM
import hriemo_torch.models as TM

from torch_port_helpers import FP32_TOL, np32, one_torch_thread, port  # noqa: F401
from test_torch_models import _inputs, _run_jax, _run_port

D = 32


def _close(got, ref):
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np32(g), np.asarray(r), atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("la,lt", [(11, 6), (1, 1)])
def test_cross_modal_block_and_transformer_match_jax(la, lt):
    ins = _inputs(np.random.default_rng(3), 3, la, lt, D)
    jb = JM.CrossModalBlock(d_model=D, n_heads=4)
    _close(_run_port(port(jb, TM.CrossModalBlock(D, 4)).eval(), *ins, torch.float32),
           _run_jax(jb, jb.params, *ins, jnp.float32))
    jt = JM.CrossModalTransformer(num_layers=2, d_model=D, n_heads=4)
    tt = port(jt, TM.CrossModalTransformer(2, D, 4)).eval()
    assert "layers.1.attn_t2a.in_proj_weight" in tt.state_dict()
    _close(_run_port(tt, *ins, torch.float32), _run_jax(jt, jt.params, *ins, jnp.float32))


@pytest.mark.parametrize("la,lt", [(9, 9),    # equal lengths
                                   (13, 5),   # audio longer: cut to the text length
                                   (4, 8)])   # audio shorter: zero-padded to it
def test_scalar_beta_gate_matches_jax(la, lt):
    ins = _inputs(np.random.default_rng(4), 3, la, lt, D)
    jg = JM.BetaGate(d_model=D, hidden_dim=16)
    got = _run_port(port(jg, TM.BetaGate(D, 16)).eval(), *ins, torch.float32)
    ref = _run_jax(jg, jg.params, *ins, jnp.float32)
    assert tuple(got[0].shape) == (3, lt, D) and tuple(got[1].shape) == (3, 1)
    _close(got, ref)


@pytest.mark.parametrize("la,lt", [(None, None), (15, 6)])
def test_fusion_classifier_matches_jax(la, lt):
    kw = dict(d_model=D, num_classes=5, n_heads=4, num_layers=2, beta_hidden=16)
    jm = JM.FusionClassifier(**kw)
    tm = port(jm, TM.FusionClassifier(**kw)).eval()
    assert {"classifier.0.weight", "classifier.1.weight", "classifier.4.bias"} \
        <= set(tm.state_dict())
    ins = _inputs(np.random.default_rng(5), 3, la, lt, D)
    got = _run_port(tm, *ins, torch.float32)
    assert [tuple(t.shape) for t in got] == [(3, 5), (3, 1), (3, D)]
    _close(got, _run_jax(jm, jm.params, *ins, jnp.float32))


def test_fusion_classifier_pools_without_the_mask():
    """The reference quirk: the fused sequence is mean-pooled over all of its
    rows, PAD rows included, so a padded batch element's pooled vector is
    not the masked mean of its rows."""
    kw = dict(d_model=D, num_classes=3, n_heads=4, num_layers=1, beta_hidden=16)
    jm = JM.FusionClassifier(**kw)
    tm = port(jm, TM.FusionClassifier(**kw)).eval()
    h_a, m_a, h_t, m_t = _inputs(np.random.default_rng(6), 2, 8, 8, D)
    m_t[1, 3:] = True  # element 1: text valid for 3 of 8 rows
    with torch.no_grad():
        ta, tt_ = torch.from_numpy(h_a), torch.from_numpy(h_t)
        ma, mt = torch.from_numpy(m_a), torch.from_numpy(m_t)
        _, _, pooled = tm(ta, tt_, ma, mt)
        ha2, ht2 = tm.cross_modal(ta, tt_, ma, mt)
        fused, _ = tm.beta_gate(ha2, ht2, ma, mt)
        masked = TM.masked_mean(fused, ma | mt)
    np.testing.assert_allclose(np32(pooled), np32(fused.mean(1)), atol=FP32_TOL, rtol=0)
    assert (pooled[1] - masked[1]).abs().max() > 1e-2
    ref = _run_jax(jm, jm.params, h_a, m_a, h_t, m_t, jnp.float32)
    np.testing.assert_allclose(np32(pooled), np.asarray(ref[2]), atol=FP32_TOL, rtol=FP32_TOL)
