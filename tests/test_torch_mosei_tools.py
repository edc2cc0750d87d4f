"""PyTorch port: the MOSEI tools (hriemo_torch/tools/{mosei_export_per_class_metrics,
mosei_plot_results,mosei_plot_thresholds,mosei_plot_training_curves,
export_mosei_standard_folds}.py) against the JAX package's tools/ on one
checkpoint of the port's MOSEI trainer and its inference artifacts (CPU).
CSV, text and JSON outputs must be equal; the plots need only exist."""

import importlib
import importlib.util
import json
import pathlib
import sys

import pytest

from hriemo_torch.infer import mosei_eval_infer as TEVAL
from hriemo_torch.tools import export_mosei_standard_folds as TFOLDS
from hriemo_torch.tools import mosei_export_per_class_metrics as TEXPORT
from hriemo_torch.tools import mosei_plot_results as TRESULTS
from hriemo_torch.tools import mosei_plot_thresholds as TTHS
from hriemo_torch.tools import mosei_plot_training_curves as TCURVES
from hriemo_torch.train import train_mosei_fusion_seq_level_decoder as TRAIN_MOSEI

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
MOSEI_TINY = ["--epochs", "2", "--batch_size", "4", "--grad_accum", "1", "--d_model", "32",
              "--n_heads", "4", "--num_layers_fusion", "1", "--num_layers_decoder", "1",
              "--beta_hidden", "16", "--max_len_audio", "24", "--max_len_text", "12",
              "--compute_dtype", "float32", "--lr", "1e-3", "--save_calibrated_ths"]


def _jax_tool(name):
    """A module of the repo's tools/ (they import the JAX package)."""
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    return importlib.import_module(name)


def _needs_matplotlib():
    if importlib.util.find_spec("matplotlib") is None:
        pytest.skip("matplotlib is not installed")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The port's MOSEI trainer at tests/test_infer_tools.py's tiny flags,
    then ``mosei_eval_infer`` on its val split with beta and attention dumps."""
    root = tmp_path_factory.mktemp("tools")
    out = root / "run"
    TRAIN_MOSEI.main(["--synthetic", "48", "--out_dir", str(out), "--device", "cpu"]
                     + MOSEI_TINY)
    data = out / "synthetic_data"
    ckpt = out / "best_mosei_fusion_decoder.pt"
    pred = root / "preds"
    TEVAL.main(["--ckpt", str(ckpt), "--index_csv", str(data / "mosei_index_splits.csv"),
                "--audio_dir", str(data / "features" / "audio"),
                "--text_dir", str(data / "features" / "text"), "--splits", "val",
                "--batch_size", "4", "--amp_dtype", "off", "--dump_beta", "--dump_attn",
                "--attn_max_samples", "4", "--out_dir", str(pred), "--device", "cpu"])
    return {"root": root, "out": out, "ckpt": str(ckpt), "pred": pred}


@pytest.mark.parametrize("with_ckpt", [True, False])
def test_per_class_metrics_csv_equal(run, with_ckpt):
    """``metrics_per_class.csv`` equal to the JAX tool's, with the
    checkpoint's calibrated thresholds and calibrated in-sample without."""
    argv = ["--pred_dir", str(run["pred"])] + (["--ckpt", run["ckpt"]] if with_ckpt else [])
    root = run["root"]
    ref = _jax_tool("mosei_export_per_class_metrics").main(
        argv + ["--out_csv", str(root / f"jax_{with_ckpt}.csv")])
    got = TEXPORT.main(argv + ["--out_csv", str(root / f"port_{with_ckpt}.csv")])
    text = pathlib.Path(got).read_text()
    assert text == pathlib.Path(ref).read_text()
    assert text.splitlines()[0] == "class,auc,auprc,f1_at_0.5,f1_at_calibrated,threshold"
    assert len(text.splitlines()) == 7


def test_plot_results_case_study_equal(run):
    """The figures exist; ``case_study.txt`` equals the JAX tool's."""
    _needs_matplotlib()
    argv = ["--pred_dir", str(run["pred"]), "--split", "val", "--ckpt", run["ckpt"],
            "--max_attn_samples", "2"]
    ref = _jax_tool("mosei_plot_results").main(argv + ["--out_dir", str(run["root"] / "jr")])
    got = TRESULTS.main(argv + ["--out_dir", str(run["root"] / "tr")])
    for name in ("score_histograms.png", "label_correlation.png", "confusion_matrices.png",
                 "beta_distribution.png", "attention_sample0.png", "attention_sample1.png"):
        assert (got / name).stat().st_size > 0, name
    assert (got / "case_study.txt").read_text() == (ref / "case_study.txt").read_text()


def test_label_correlation_keeps_constant_classes_as_identity():
    import numpy as np

    y = np.array([[1, 0, 1], [0, 0, 1], [1, 0, 1], [0, 0, 1]])
    c = TRESULTS.label_correlation(y)
    np.testing.assert_array_equal(c[1], [0, 1, 0])
    assert c[0, 0] == 1.0 and c[0, 2] == 0.0


def test_threshold_and_curve_plots(run):
    """The threshold bar plot and the training curves from the trainer's
    ``train_log.csv`` exist."""
    _needs_matplotlib()
    out = TTHS.main(["--ckpt", run["ckpt"], "--out", str(run["root"] / "figs" / "th.png")])
    assert out.stat().st_size > 0
    log = run["out"] / "outputs" / "train_log.csv"
    out = TCURVES.main(["--log_csv", str(log), "--out", str(run["root"] / "figs" / "c.png")])
    assert out.stat().st_size > 0
    cols = TCURVES.read_log(log)
    assert cols["epoch"] == [1.0, 2.0] and len(cols["mean_beta"]) == 2


def test_export_standard_folds_json_equal(tmp_path):
    """The folds file written from an SDK checkout equals the JAX tool's;
    without mmsdk and ``--sdk`` both exit."""
    sdk = tmp_path / "sdk" / "CMU_MOSEI"
    sdk.mkdir(parents=True)
    (sdk / "cmu_mosei_std_folds.py").write_text(
        "standard_train_fold=['a','b']\nstandard_valid_fold=['c']\nstandard_test_fold=['d']\n")
    jax_tool = _jax_tool("export_mosei_standard_folds")
    ref = jax_tool.main(["--sdk", str(tmp_path / "sdk"), "--out", str(tmp_path / "j.json")])
    got = TFOLDS.main(["--sdk", str(tmp_path / "sdk"), "--out", str(tmp_path / "t.json")])
    assert got.read_text() == ref.read_text()
    assert json.loads(got.read_text())["valid"] == ["c"]
    if importlib.util.find_spec("mmsdk") is None:
        for main in (jax_tool.main, TFOLDS.main):
            with pytest.raises(SystemExit, match="mmsdk is not importable"):
                main(["--out", str(tmp_path / "x.json")])
