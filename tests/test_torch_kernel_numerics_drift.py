"""Drift guard for the port's committed per-bucket kernel numerics
(``hriemo_torch/kernel_numerics_h100.json``, written on the card by
``python -m hriemo_torch.tools.kernel_numerics``), as
tests/test_kernel_numerics_drift.py guards the TPU file.

The file must cover every ``(kernel, shape)`` that the port's serving
buckets give (``infer/e2e_infer.py``'s defaults), each delta within its
limit, and name the card it was read on. After a bucket or kernel change:
rerun the tool on the card (``chip_smoke.py`` phase 8a writes the file to
``chip_smoke_out/``) and commit it with the change."""

import json
import pathlib

import pytest

from hriemo_torch.tools import kernel_numerics as KN

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def artifact():
    return json.loads((ROOT / "hriemo_torch" / "kernel_numerics_h100.json").read_text())


def test_names_the_card(artifact):
    """The card's name and power limit, as nvidia-smi prints them."""
    name, limit = (p.strip() for p in artifact["card"].split(","))
    assert "H100" in name and limit.endswith(" W") and float(limit[:-2]) > 0
    assert artifact["batch"] == KN.B == 8


def test_covers_every_bucket_of_the_port(artifact):
    rows = {(r["kernel"], r["shape"]) for r in artifact["rows"]}
    want = KN.expected_rows()
    assert len(want) == len(set(want)) == 45
    missing = [k for k in want if k not in rows]
    assert not missing, missing
    audio, _ = KN.serving_buckets()
    assert sum(k == "wavlm_attention_block" for k, _ in rows) == len(audio) == 14


def test_covers_the_conv_stack_at_every_bucket(artifact):
    """The port's own rows: the served conv stack at each of the 14 audio
    buckets."""
    rows = {(r["kernel"], r["shape"]) for r in artifact["rows"]}
    want = [k for k in KN.port_rows() if k[0] == "conv_stack"]
    assert len(want) == len(set(want)) == 14
    assert not set(want) & set(KN.expected_rows())
    assert not [k for k in want if k not in rows]


def test_covers_the_wgmma_core_at_every_bucket(artifact):
    """The port's own rows: WavLM's gated int8 core on its wgmma warpgroups
    at each of the 14 audio buckets' frames, and no other port rows."""
    rows = {(r["kernel"], r["shape"]) for r in artifact["rows"]}
    want = [k for k in KN.port_rows() if k[0] == "int8_core_wgmma"]
    audio, _ = KN.serving_buckets()
    frames = KN.bucket_frames(audio)
    assert want == [("int8_core_wgmma", f"L={frames[sec]} (bucket {sec}s)") for sec in audio]
    assert len(set(want)) == 14 and len(KN.port_rows()) == 28
    assert not set(want) & set(KN.expected_rows())
    assert not [k for k in want if k not in rows]


def test_every_delta_within_its_limit(artifact):
    for r in artifact["rows"]:
        assert r["threshold"] == KN.THRESH[r["kernel"]], r
        assert 0 <= r["max_delta"] <= r["threshold"], r


def test_same_rows_and_limits_as_the_tpu_record():
    """The ``(kernel, shape)`` set and the limits of the JAX package's
    ``kernel_numerics.json``: the port's buckets are the JAX serving
    config's."""
    tpu = json.loads((ROOT / "kernel_numerics.json").read_text())
    assert {(e["kernel"], e["shape"]) for e in tpu} == set(KN.expected_rows())
    assert all(e["threshold"] == KN.THRESH[e["kernel"]] for e in tpu)


def test_tool_runs_on_the_cpu():
    """The tool's comparisons at batch 1 on two buckets and one text bucket:
    on the CPU each wrapper takes its plain version, so every delta is 0."""
    checks = KN.Checks("cpu", 0, b=1, frames={1.25: 62, 10.0: 499}, text=(8,))
    results = checks.run_all(lambda line: None)
    assert [s for k, s, _ in results if k in ("wavlm_attention_block", "ffn_block")] == [
        "L=62 (bucket 1.25s)", "L=499 (bucket 10.0s)", "M=62", "M=499"]
    assert sum(k == "mha_block" for k, _, _ in results) == 6
    assert [s for k, s, _ in results if k == "conv_stack"] == [
        "Tw=20000 (bucket 1.25s)", "Tw=160000 (bucket 10.0s)"]
    assert [s for k, s, _ in results if k == "int8_core_wgmma"] == [
        "L=62 (bucket 1.25s)", "L=499 (bucket 10.0s)"]
    assert all(d == 0.0 for _, _, d in results) and len(results) == 19
    rep = KN.report(results, "cpu", 0)
    assert rep["rows"][0] == {"kernel": "wavlm_attention_block",
                              "shape": "L=62 (bucket 1.25s)", "max_delta": 0.0,
                              "threshold": 0.05}
