"""PyTorch port: attention export and the MOSEI evaluation entry points
(hriemo_torch/nn/attention.py ``need_weights``, the models'
``return_attention`` and ``use_output_layer``, hriemo_torch/infer/
{mosei_eval_infer,mosei_summary_metrics,mosei_plot_metrics}.py) against the
JAX package on the same weights and inputs, on the CPU. The end-to-end
inference CLI is tests/test_torch_e2e_infer.py."""

import csv
import importlib.util

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hriemo.infer import mosei_eval_infer as JEVAL
from hriemo.infer import mosei_summary_metrics as JSUM
from hriemo.models import FusionWithEmotionDecoder, MoseiFusionWithEmotionDecoder
from hriemo.models.emotion_decoder import EmotionDecoder
from hriemo.nn.attention import mha_apply
from hriemo.nn.module import flatten_params
import hriemo_torch.models as TM
from hriemo_torch.infer import mosei_eval_infer as TEVAL
from hriemo_torch.infer import mosei_plot_metrics as TPLOT
from hriemo_torch.infer import mosei_summary_metrics as TSUM
from hriemo_torch.models.emotion_decoder import EmotionDecoder as TEmotionDecoder
from hriemo_torch.nn.attention import MultiheadAttention
from hriemo_torch.train import train_mosei_fusion_seq_level_decoder as TRAIN_MOSEI
from hriemo_torch.utils.convert import load_flat_params

from torch_port_helpers import FP32_TOL, flat, one_torch_thread, port  # noqa: F401

MAP_TOL = 1e-5


# ------------------------------------------------------ attention export

@pytest.mark.parametrize("lq,lk,masked", [(7, 7, True), (5, 9, True), (9, 5, False),
                                          (1024, 1024, True)])
def test_need_weights_matches_jax(lq, lk, masked):
    """Output and head-averaged pre-dropout weights against
    ``mha_apply(..., need_weights=True)``; at 1024 x 1024, where
    ``flash_mha`` would take the call, the weights still come back."""
    from hriemo.nn.attention import mha_init

    d, h, b = 32, 4, 2
    rng = np.random.default_rng(lq + lk)
    jp = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32) * 0.3),
        mha_init(jax.random.key(0), d))
    q = rng.standard_normal((b, lq, d)).astype(np.float32)
    kv = rng.standard_normal((b, lk, d)).astype(np.float32)
    mask = np.arange(lk)[None, :] >= np.array([lk, lk - 3])[:, None] if masked else None
    ref_out, ref_w = mha_apply(jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), h,
                               key_padding_mask=None if mask is None else jnp.asarray(mask),
                               need_weights=True)
    mha = load_flat_params(MultiheadAttention(d, h), flat(jp)).eval()
    tq, tkv = torch.from_numpy(q), torch.from_numpy(kv)
    tmask = None if mask is None else torch.from_numpy(mask)
    with torch.no_grad():
        out, w = mha(tq, tkv, tkv, tmask, need_weights=True)
        default = mha(tq, tkv, tkv, tmask)
    assert w.shape == (b, lq, lk) and w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6)
    # outputs sum up to 1024 products of O(1): the fp32 plain-path tolerance
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=FP32_TOL)
    # the default call returns the output alone, as before
    assert isinstance(default, torch.Tensor) and default.shape == out.shape


def test_need_weights_takes_no_fused_route(monkeypatch):
    """With ``need_weights`` neither ``flash_mha`` nor the int8 MHA block
    runs (their plain versions stand in for them on the CPU)."""
    import hriemo_torch.nn.attention as TA

    def refuse(*a, **k):
        raise AssertionError("fused route taken with need_weights")

    monkeypatch.setattr(TA, "flash_mha_plain", refuse)
    monkeypatch.setattr(TA, "mha_block_int8_plain", refuse)
    mha = TA.MultiheadAttention(256, 8).eval()
    torch.nn.init.normal_(mha.in_proj_weight, std=0.05)
    from hriemo_torch.ops.quant import quantize_for_serving

    x = torch.randn(1, 1024, 256)
    with torch.no_grad():
        _, w = mha(x, x, x, need_weights=True)
        assert w.shape == (1, 1024, 1024)
        quantize_for_serving(mha.to(torch.bfloat16))
        assert mha.ops is not None
        xb = x[:, :64].to(torch.bfloat16)
        _, w = mha(xb, xb, xb, need_weights=True)
    assert w.dtype == torch.bfloat16 and w.shape == (1, 64, 64)


def _maps_close(got, ref):
    assert set(got) == {"encoder", "decoder"}
    assert len(got["encoder"]) == len(ref["encoder"]) and \
        len(got["decoder"]) == len(ref["decoder"])
    for g, r in zip(got["encoder"], ref["encoder"]):
        assert set(g) == set(r) == {"audio_self", "text_self", "audio_queries_text",
                                    "text_queries_audio"}
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(r[k]), atol=MAP_TOL, err_msg=k)
    for g, r in zip(got["decoder"], ref["decoder"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=MAP_TOL)


@pytest.mark.parametrize("mosei", [False, True])
def test_return_attention_matches_jax(mosei):
    """The encoder's four maps per layer and the decoder's ``[B, E, L]``
    maps of both fusion models, beside their logits, beta and z."""
    rng = np.random.default_rng(5)
    kw = dict(d_model=32, num_emotions=4, n_heads=4, num_layers_fusion=2,
              num_layers_decoder=2, beta_hidden=16)
    if mosei:
        jm = MoseiFusionWithEmotionDecoder(d_audio=12, d_text=20, **kw)
        tm = port(jm, TM.MoseiFusionWithEmotionDecoder(d_audio=12, d_text=20, **kw)).eval()
        da, dt = 12, 20
    else:
        jm = FusionWithEmotionDecoder(**kw)
        tm = port(jm, TM.FusionWithEmotionDecoder(**kw)).eval()
        da = dt = 32
    h_a = rng.standard_normal((3, 11, da)).astype(np.float32)
    h_t = rng.standard_normal((3, 6, dt)).astype(np.float32)
    m_a = np.arange(11)[None, :] >= np.array([11, 7, 3])[:, None]
    m_t = np.arange(6)[None, :] >= np.array([6, 6, 2])[:, None]
    ref = jm.apply(jm.params, *map(jnp.asarray, (h_a, h_t, m_a, m_t)), return_attention=True)
    with torch.no_grad():
        got = tm(*map(torch.from_numpy, (h_a, h_t, m_a, m_t)), return_attention=True)
        plain = tm(*map(torch.from_numpy, (h_a, h_t, m_a, m_t)))
    assert len(got) == 4 and len(plain) == 3
    for g, r, p in zip(got[:3], ref[:3], plain):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=MAP_TOL)
        np.testing.assert_array_equal(g.numpy(), p.numpy())
    _maps_close(got[3], ref[3])
    assert got[3]["decoder"][0].shape == (3, 4, 6)
    assert got[3]["encoder"][0]["text_queries_audio"].shape == (3, 6, 11)


def test_decoder_without_output_layer():
    """``use_output_layer=False``: no ``out_proj`` parameter (strict name
    parity with JAX) and no logits."""
    kw = dict(d_model=32, num_emotions=4, n_heads=4, num_layers=1, use_output_layer=False)
    jm = EmotionDecoder(**kw)
    tm = TEmotionDecoder(**kw)
    assert set(tm.state_dict()) == set(flatten_params(jm.params))
    assert not any("out_proj.weight" == k or k.startswith("out_proj") for k in tm.state_dict())
    load_flat_params(tm, flat(jm.params))
    mem = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    z_ref, logits_ref, maps_ref = jm.apply(jm.params, jnp.asarray(mem), return_attention=True)
    with torch.no_grad():
        z, logits, maps = tm.eval()(torch.from_numpy(mem), return_attention=True)
    assert logits is None and logits_ref is None
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), atol=MAP_TOL)
    np.testing.assert_allclose(maps[0].numpy(), np.asarray(maps_ref[0]), atol=MAP_TOL)


# ------------------------------------------------------ mosei_eval_infer

MOSEI_TINY = ["--epochs", "2", "--batch_size", "4", "--grad_accum", "1", "--d_model", "32",
              "--n_heads", "4", "--num_layers_fusion", "1", "--num_layers_decoder", "1",
              "--beta_hidden", "16", "--max_len_audio", "24", "--max_len_text", "12",
              "--compute_dtype", "float32", "--lr", "1e-3", "--save_calibrated_ths"]


@pytest.fixture(scope="module")
def mosei_run(tmp_path_factory):
    """A checkpoint of the port's MOSEI trainer at test_infer_tools.py's tiny
    flags, and a copy of it without its length caps."""
    from hriemo_torch.utils.checkpoint import load_torch_checkpoint, save_torch_checkpoint

    root = tmp_path_factory.mktemp("mosei")
    out = root / "run"
    TRAIN_MOSEI.main(["--synthetic", "48", "--out_dir", str(out), "--device", "cpu"]
                     + MOSEI_TINY)
    ckpt = load_torch_checkpoint(str(out / "best_mosei_fusion_decoder.pt"))
    ckpt["args"].update(max_len_audio=0, max_len_text=0)
    save_torch_checkpoint(str(root / "uncapped.pt"), ckpt)
    data = out / "synthetic_data"
    common = ["--index_csv", str(data / "mosei_index_splits.csv"),
              "--audio_dir", str(data / "features" / "audio"),
              "--text_dir", str(data / "features" / "text"), "--splits", "val", "test",
              "--batch_size", "4", "--amp_dtype", "off"]
    return root, {"capped": str(out / "best_mosei_fusion_decoder.pt"),
                  "uncapped": str(root / "uncapped.pt")}, common


@pytest.mark.parametrize("caps", ["capped", "uncapped"])
def test_mosei_eval_matches_jax_cli(mosei_run, caps):
    """Probabilities, labels, beta and every attention map of both CLIs on
    one checkpoint, with ``--dump_beta --dump_attn``; ``y_prob.npy`` is the
    same without ``--dump_attn``."""
    root, ckpts, common = mosei_run
    argv = ["--ckpt", ckpts[caps], *common, "--dump_beta", "--dump_attn",
            "--attn_max_samples", "6"]
    jdir, tdir, bare = (root / f"{w}_{caps}" for w in ("jax", "port", "bare"))
    JEVAL.main(argv + ["--out_dir", str(jdir)])
    TEVAL.main(argv + ["--out_dir", str(tdir), "--device", "cpu"])
    TEVAL.main(["--ckpt", ckpts[caps], *common, "--out_dir", str(bare), "--device", "cpu"])
    for split in ("val", "test"):
        for name in ("y_prob", "y_true", "beta_mean"):
            got, ref = (np.load(d / f"{split}_{name}.npy") for d in (tdir, jdir))
            assert got.shape == ref.shape and np.isfinite(got).all(), name
            np.testing.assert_allclose(got, ref, atol=MAP_TOL, err_msg=name)
        np.testing.assert_array_equal(np.load(bare / f"{split}_y_prob.npy"),
                                      np.load(tdir / f"{split}_y_prob.npy"))
        got, ref = (torch.load(d / f"{split}_attentions.pt", weights_only=False)
                    for d in (tdir, jdir))
        assert len(got["encoder"]) == len(ref["encoder"]) == 2   # batches of 4, then 2
        for g, r in zip(got["encoder"], ref["encoder"]):
            _maps_close({"encoder": g, "decoder": []}, {"encoder": r, "decoder": []})
        for g, r in zip(got["decoder"], ref["decoder"]):
            assert len(g) == len(r) == 1
            np.testing.assert_allclose(g[0].numpy(), r[0].numpy(), atol=MAP_TOL)
        la = got["encoder"][0][0]["audio_self"].shape[-1]
        assert la == 24 if caps == "capped" else la > 24   # uncapped: the split's longest


@pytest.fixture(scope="module")
def mosei_pred(mosei_run):
    """The port's artifacts of the capped checkpoint's val and test splits,
    the summary and plot tools' input. Returns ``(pred_dir, ckpt)``."""
    root, ckpts, common = mosei_run
    pred = root / "summary"
    TEVAL.main(["--ckpt", ckpts["capped"], *common, "--out_dir", str(pred), "--device", "cpu"])
    return pred, ckpts["capped"]


def test_mosei_summary_matches_jax(mosei_pred):
    """The summary CLIs of both packages over the port's artifacts write the
    same CSV and return the same metrics."""
    pred, ckpt = mosei_pred
    argv = ["--pred_dir", str(pred), "--split", "val", "--ckpt", ckpt]
    got = TSUM.main(argv)
    text = (pred / "val_summary_metrics.csv").read_text()
    ref = JSUM.main(argv)
    assert (pred / "val_summary_metrics.csv").read_text() == text
    assert got == ref
    with open(pred / "val_summary_metrics.csv", newline="") as f:
        assert len(list(csv.DictReader(f))) == 6


def test_mosei_plots(mosei_pred):
    """The plot tool writes its files (a host tool: needs matplotlib)."""
    if importlib.util.find_spec("matplotlib") is None:
        pytest.skip("matplotlib is not installed")
    pred, _ = mosei_pred
    out = TPLOT.main(["--pred_dir", str(pred), "--split", "val"])
    for name in ("per_class_f1.png", "per_class_ap.png", "combined_pr_curve.png",
                 "overall_metrics.txt"):
        assert (out / name).exists(), name


def test_mosei_eval_defaults_to_the_card(mosei_run):
    """Without ``--device cpu`` the CLI runs on the card and raises without one."""
    _, ckpts, common = mosei_run
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TEVAL.main(["--ckpt", ckpts["capped"], *common, "--out_dir", "unused"])
