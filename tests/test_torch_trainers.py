"""PyTorch port: the trainer CLIs (hriemo_torch/train) at
tests/test_train_pipelines.py's tiny flags on the CPU. They write the
artifacts and keys that the JAX trainers write (hriemo/train/
train_fusion_seq_level_decoder.py:168-181,
train_mosei_fusion_seq_level_decoder.py:264-285, train_fusion_seq_level.py
and train_fusion_utter_level.py:151-161, linear_probe_baseline.py:128-130,
train_text_baseline.py:136-139), default to the card, resume the MOSEI
trainer mid-run as tests/test_resume.py resumes the JAX one, and run the
MOSEI trainer over the (data x model) mesh as the single-process run."""

import csv
import json

import numpy as np
import pytest
import torch

import hriemo_torch.models as TM
from hriemo_torch.parallel.train_step import TrainConfig, create_train_state
from hriemo_torch.train import linear_probe_baseline as PROBE
from hriemo_torch.train import train_fusion_seq_level as SEQ
from hriemo_torch.train import train_fusion_seq_level_decoder as IEMO
from hriemo_torch.train import train_fusion_utter_level as UTT
from hriemo_torch.train import train_mosei_fusion_seq_level_decoder as MOSEI
from hriemo_torch.train import train_text_baseline as TEXT
from hriemo_torch.utils import checkpoint as C

from test_train_pipelines import TINY
from torch_port_helpers import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
SMALL = ["--num_layers_fusion", "1", "--num_layers_decoder", "1",
         "--max_len_audio", "24", "--max_len_text", "12"]


def _log(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("loss_type", ["single_label", "multi_label"])
def test_iemocap_decoder_cli(tmp_path, loss_type):
    out = tmp_path / "run"
    best = IEMO.main(["--synthetic", "48", "--loss_type", loss_type, "--out_dir", str(out)]
                     + SMALL + TINY + CPU)
    if loss_type == "single_label":
        assert best > 1 / 6   # six synthetic classes around separable centroids
    else:
        assert best >= 0.0
    ckpt = torch.load(out / "best_fusion_seq_decoder.pt", map_location="cpu",
                      weights_only=False)
    assert set(ckpt) == {"model_state_dict", "args", "label2id", "epoch", "val_acc"}
    assert ckpt["args"]["loss_type"] == loss_type and len(ckpt["label2id"]) == 6
    assert ckpt["val_acc"] == best
    model = TM.FusionWithEmotionDecoder(d_model=32, num_emotions=6, n_heads=4,
                                        num_layers_fusion=1, num_layers_decoder=1,
                                        beta_hidden=16)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    meta = json.loads((out / "meta.json").read_text())
    assert set(meta) == {"model", "level", "loss_type", "best_val_acc", "epoch", "label2id"}
    log = _log(out / "outputs" / "train_log.csv")
    assert list(log[0]) == ["epoch", "train_loss", "val_loss", "val_acc", "mean_beta",
                            "epoch_time_s"]
    assert len(log) == 3


def test_mosei_cli(tmp_path):
    out = tmp_path / "run"
    best = MOSEI.main(["--synthetic", "48", "--grad_accum", "2", "--save_calibrated_ths",
                       "--select_by", "calibrated_macro_f1", "--out_dir", str(out)]
                      + SMALL + TINY + CPU)
    assert best > 0.3
    ckpt = torch.load(out / "best_mosei_fusion_decoder.pt", map_location="cpu",
                      weights_only=False)
    assert set(ckpt) == {"model_state_dict", "args", "emo_cols", "epoch", "val_macro_auc",
                         "val_macro_f1", "val_calibrated_macro_f1",
                         "val_calibrated_thresholds"}
    assert len(ckpt["val_calibrated_thresholds"]) == 6 and ckpt["args"]["d_model"] == 32
    assert isinstance(ckpt["model_state_dict"]["audio_proj.weight"], torch.Tensor)
    model = TM.MoseiFusionWithEmotionDecoder(d_audio=74, d_text=300, d_model=32,
                                             n_heads=4, num_layers_fusion=1,
                                             num_layers_decoder=1, beta_hidden=16)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    meta = json.loads((out / "meta.json").read_text())
    assert set(meta) == {"model", "select_by", "best_metric", "epoch", "val_macro_auc",
                         "val_macro_f1", "val_calibrated_macro_f1",
                         "val_calibrated_thresholds"}
    log = _log(out / "outputs" / "train_log.csv")
    assert list(log[0])[:5] == ["epoch", "train_loss", "val_loss", "val_auc", "mean_beta"]
    assert len(log) == 3


@pytest.mark.parametrize("level", ["seq", "utter"])
def test_fusion_classifier_clis(tmp_path, level):
    out = tmp_path / "run"
    if level == "seq":
        best = SEQ.main(["--synthetic", "48", "--num_layers", "1", "--max_len_audio", "24",
                         "--max_len_text", "12", "--out_dir", str(out)] + TINY + CPU)
    else:
        best = UTT.main(["--synthetic", "64", "--num_layers", "1", "--out_dir", str(out)]
                        + TINY + CPU)
    assert best > 0.3   # six synthetic classes around separable centroids
    ckpt = torch.load(out / f"best_fusion_{'seq' if level == 'seq' else 'utt'}.pt",
                      map_location="cpu", weights_only=False)
    assert set(ckpt) == {"model_state_dict", "args", "label2id", "epoch", "val_acc"}
    assert len(ckpt["label2id"]) == 6 and ckpt["val_acc"] == best
    model = TM.FusionClassifier(d_model=32, num_classes=6, n_heads=4, num_layers=1,
                                beta_hidden=16)
    model.load_state_dict(ckpt["model_state_dict"], strict=True)
    meta = json.loads((out / "meta.json").read_text())
    assert set(meta) == {"model", "level", "best_val_acc", "epoch", "label2id"}
    assert meta["model"] == "FusionClassifier" and meta["level"] == level
    log = _log(out / "outputs" / "train_log.csv")
    assert list(log[0]) == ["epoch", "train_loss", "val_loss", "val_acc", "mean_beta",
                            "epoch_time_s"]
    assert len(log) == 3


@pytest.mark.parametrize("cli,flags", [(PROBE, []), (PROBE, ["--modality", "audio"]),
                                       (TEXT, ["--head", "linear"]), (TEXT, [])])
def test_baseline_clis(tmp_path, cli, flags):
    out = tmp_path / "run"
    results = cli.main(["--synthetic", "64", "--d_model", "16", "--epochs", "8",
                        "--batch_size", "8", "--lr", "1e-2", "--out_dir", str(out)]
                       + flags + CPU)
    metrics = json.loads((out / "metrics.json").read_text())
    splits = {"train", "val", "test"}
    if cli is PROBE:
        assert set(metrics) == {"modality", "label2id"} | splits
        assert metrics["modality"] == (flags[1] if flags else "concat")
    else:
        assert set(metrics) == {"head", "best_val_macro_f1", "label2id"} | splits
        assert metrics["best_val_macro_f1"] == metrics["val"]["macro_f1"]
    assert len(metrics["label2id"]) == 6   # "frustrated" normalised to "frustration"
    assert "frustration" in metrics["label2id"]
    for split in splits:
        assert set(metrics[split]) == {"acc", "macro_f1", "n"} and metrics[split]["n"] > 0
        assert metrics[split] == results[split]
    assert metrics["train"]["acc"] > 0.5   # planted signal, six classes


RESUME = ["--batch_size", "4", "--grad_accum", "1", "--d_model", "32", "--n_heads", "4",
          "--num_layers_fusion", "1", "--num_layers_decoder", "1", "--beta_hidden", "16",
          "--max_len_audio", "24", "--max_len_text", "12", "--compute_dtype", "float32",
          "--lr", "1e-3", "--resume"]


def test_mosei_resume_continues_training(tmp_path):
    """tests/test_resume.py on the port: 2 epochs, then resumed to 4."""
    out = str(tmp_path / "run")
    MOSEI.main(["--synthetic", "32", "--out_dir", out, "--epochs", "2"] + RESUME + CPU)
    meta1 = json.loads((tmp_path / "run" / "resume" / "meta.json").read_text())
    assert meta1["epoch"] == 2
    saved = C.restore_native(str(tmp_path / "run" / "resume" / "state"),
                             like=_mosei_state())

    MOSEI.main(["--synthetic", "32", "--out_dir", out, "--epochs", "4"] + RESUME + CPU)
    meta2 = json.loads((tmp_path / "run" / "resume" / "meta.json").read_text())
    assert meta2["epoch"] == 4 and meta2["best_metric"] >= meta1["best_metric"]
    assert [int(r["epoch"]) for r in _log(tmp_path / "run" / "outputs" / "train_log.csv")] \
        == [3, 4]
    steps = int(saved.step)
    final = C.restore_native(str(tmp_path / "run" / "resume" / "state"), like=_mosei_state())
    assert steps > 0 and int(final.step) == 2 * steps and int(final.count) == 2 * steps
    ckpt = torch.load(f"{out}/best_mosei_fusion_decoder.pt", map_location="cpu",
                      weights_only=False)
    assert ckpt["args"]["epochs"] == 4


def _mosei_state():
    model = TM.MoseiFusionWithEmotionDecoder(d_audio=74, d_text=300, d_model=32, n_heads=4,
                                             num_layers_fusion=1, num_layers_decoder=1,
                                             beta_hidden=16)
    return create_train_state(model, TrainConfig())


def test_native_checkpoint_round_trip_is_exact(tmp_path):
    """A TrainState with count and step 7 and moments of random values: every
    leaf comes back bit-equal, in place; a parameter dict too."""
    st = _mosei_state()
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in [*st.model.parameters(), *st.mu, *st.nu]:
            t.copy_(torch.randn(t.shape, generator=g))
    st.count.fill_(7)
    st.step.fill_(7)
    st.total_notfinite.fill_(2)
    C.save_native(str(tmp_path / "resume" / "state"), st)
    fresh = _mosei_state()
    got = C.restore_native(str(tmp_path / "resume" / "state"), like=fresh)
    assert got is fresh and int(got.count) == 7 and int(got.step) == 7
    assert int(got.total_notfinite) == 2
    for a, b in zip([*st.model.parameters(), *st.mu, *st.nu],
                    [*got.model.parameters(), *got.mu, *got.nu]):
        assert torch.equal(a, b)
    params = C.state_dict_cpu(st.model)
    C.save_native(str(tmp_path / "best_params"), params)
    back = C.restore_native(str(tmp_path / "best_params"), like=C.state_dict_cpu(fresh.model))
    assert set(back) == set(params) and all(torch.equal(back[k], params[k]) for k in params)


def test_mosei_trace_dir_writes_a_trace(tmp_path):
    out, trace = tmp_path / "run", tmp_path / "trace"
    MOSEI.main(["--synthetic", "16", "--out_dir", str(out), "--trace_dir", str(trace),
                "--epochs", "2", "--native_ckpt"] + RESUME[:-1] + CPU)
    files = list(trace.glob("*.pt.trace.json"))
    assert len(files) == 1   # the first epoch only
    assert '"traceEvents"' in files[0].read_text()
    assert (out / "native_state").is_file() and (out / "resume" / "state").is_file()


@pytest.mark.parametrize("cli", [IEMO, MOSEI, SEQ, UTT, PROBE, TEXT])
def test_trainers_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "8", "--out_dir", str(tmp_path)])


def test_mosei_native_loader_matches_python_loader(tmp_path, capsys):
    """``--native_loader`` runs the C++ batch assembler (bit-equal batches),
    says so, and trains exactly as the same run on the Python loader: the
    same log and the same checkpoint."""
    argv = ["--synthetic", "48", "--grad_accum", "2"] + SMALL + TINY + CPU
    MOSEI.main(argv + ["--out_dir", str(tmp_path / "py")])
    assert "--native_loader" not in capsys.readouterr().out
    MOSEI.main(argv + ["--out_dir", str(tmp_path / "native"), "--native_loader"])
    assert "[mosei] --native_loader: batches from the C++ loader" in capsys.readouterr().out
    logs = [_log(tmp_path / d / "outputs" / "train_log.csv") for d in ("py", "native")]
    assert [{k: v for k, v in r.items() if k != "epoch_time_s"} for r in logs[0]] == \
        [{k: v for k, v in r.items() if k != "epoch_time_s"} for r in logs[1]]
    sds = [torch.load(tmp_path / d / "best_mosei_fusion_decoder.pt", map_location="cpu",
                      weights_only=False)["model_state_dict"] for d in ("py", "native")]
    assert all(torch.equal(sds[0][k], sds[1][k]) for k in sds[0])


MESH_ARGV = ["--synthetic", "48", "--grad_accum", "2"] + SMALL + TINY + CPU
MESHES = {"dp": ["--n_data", "2"], "tp": ["--n_model", "2"],
          "2x2": ["--n_data", "2", "--n_model", "2"]}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The MOSEI CLI at tests/test_train_pipelines.py's tiny flags (fp32,
    dropout 0.1), in this process and over each mesh (gloo ranks the CLI
    spawns): ``{run: out_dir}``."""
    root = tmp_path_factory.mktemp("mesh_runs")
    MOSEI.main(MESH_ARGV + ["--out_dir", str(root / "single")])
    for name, flags in MESHES.items():
        MOSEI.main(MESH_ARGV + flags + ["--out_dir", str(root / name)])
    return {name: root / name for name in ("single", *MESHES)}


def _losses(out):
    return [(float(r["train_loss"]), float(r["val_loss"]))
            for r in _log(out / "outputs" / "train_log.csv")]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_mosei_mesh_run_matches_single_process(mesh_runs, mesh):
    """``--n_data 2``, ``--n_model 2`` and both: every rank keeps its block
    of the same global batch and its block of the same dropout masks, so
    the log's train and val losses are the single-process run's at rtol
    1e-5; rank 0 alone wrote the artifacts."""
    got, ref = _losses(mesh_runs[mesh]), _losses(mesh_runs["single"])
    assert len(got) == len(ref) == 3
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    out = mesh_runs[mesh]
    assert (out / "best_mosei_fusion_decoder.pt").is_file() and (out / "meta.json").is_file()


def test_mosei_mesh_checkpoint_loads_unsharded(mesh_runs):
    """The 2 x 2 run's checkpoint is saved whole: it loads strictly into an
    unsharded model, with the single-process run's names and shapes."""
    ckpt = torch.load(mesh_runs["2x2"] / "best_mosei_fusion_decoder.pt", map_location="cpu",
                      weights_only=False)
    ref = torch.load(mesh_runs["single"] / "best_mosei_fusion_decoder.pt", map_location="cpu",
                     weights_only=False)
    assert ckpt["args"]["n_data"] == 2 and ckpt["args"]["n_model"] == 2
    sd = ckpt["model_state_dict"]
    assert {k: v.shape for k, v in sd.items()} == \
        {k: v.shape for k, v in ref["model_state_dict"].items()}
    model = TM.MoseiFusionWithEmotionDecoder(d_audio=74, d_text=300, d_model=32, n_heads=4,
                                             num_layers_fusion=1, num_layers_decoder=1,
                                             beta_hidden=16)
    model.load_state_dict(sd, strict=True)


def test_mosei_mesh_run_against_jax_cli(mesh_runs, tmp_path):
    """The JAX CLI's ``--n_data 2`` (a 2 x 1 mesh of its CPU devices) on the
    same corpus and flags: both logs have the same epochs and columns,
    finite falling train losses, and both runs clear test_mosei_cli's bar
    on the best calibrated metric."""
    from hriemo.train.train_mosei_fusion_seq_level_decoder import main as jax_main

    jbest = jax_main(["--synthetic", "48", "--grad_accum", "2", "--n_data", "2",
                      "--out_dir", str(tmp_path / "jax")] + SMALL + TINY)
    jlog = _log(tmp_path / "jax" / "outputs" / "train_log.csv")
    log = _log(mesh_runs["dp"] / "outputs" / "train_log.csv")
    assert [list(r) for r in log] == [list(r) for r in jlog]
    assert [r["epoch"] for r in log] == [r["epoch"] for r in jlog] == ["1", "2", "3"]
    for rows in (log, jlog):
        losses = [float(r["train_loss"]) for r in rows]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    meta = json.loads((mesh_runs["dp"] / "meta.json").read_text())
    assert jbest > 0.3 and meta["best_metric"] > 0.3


def test_mosei_mesh_flags_default_to_the_card(tmp_path, monkeypatch):
    """A mesh run resolves its device before it starts a rank: without
    ``--device cpu`` and without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MOSEI.main(["--synthetic", "8", "--out_dir", str(tmp_path), "--n_data", "2"])
