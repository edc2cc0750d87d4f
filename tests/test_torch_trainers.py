"""PyTorch port: the two trainer CLIs (hriemo_torch/train) at
tests/test_train_pipelines.py's tiny flags on the CPU. They write the
artifacts and keys that the JAX trainers write (hriemo/train/
train_fusion_seq_level_decoder.py:168-181 and
train_mosei_fusion_seq_level_decoder.py:264-285), default to the card, and
refuse the JAX flags that the port does not take yet."""

import csv
import json

import pytest
import torch

import hriemo_torch.models as TM
from hriemo_torch.train import train_fusion_seq_level_decoder as IEMO
from hriemo_torch.train import train_mosei_fusion_seq_level_decoder as MOSEI

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


@pytest.mark.parametrize("cli", [IEMO, MOSEI])
def test_trainers_default_to_the_card_and_raise_without_one(tmp_path, monkeypatch, cli):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--synthetic", "8", "--out_dir", str(tmp_path)])


@pytest.mark.parametrize("flags,item", [(["--resume"], 5), (["--native_ckpt"], 5),
                                        (["--trace_dir", "t"], 5), (["--native_loader"], 7),
                                        (["--n_data", "2"], 8), (["--n_model", "2"], 8)])
def test_mosei_refuses_flags_it_does_not_take_yet(tmp_path, flags, item):
    with pytest.raises(SystemExit, match=f"queue 1 item {item}"):
        MOSEI.main(["--synthetic", "8", "--out_dir", str(tmp_path)] + flags + CPU)
