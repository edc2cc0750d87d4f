"""PyTorch port: the (data x model) mesh on torch.distributed
(hriemo_torch/parallel/{launch,mesh,train_step,dryrun}.py) against the JAX
package's mesh (hriemo/parallel) on its 8-device CPU mesh.

The port's ranks are gloo processes on the CPU, two or four, each started
by ``launch.spawn``; one spawn per world size runs all of this module's
cases (``torch_dist_workers.run_jobs``), and the tests read its results.
Inputs come from numpy seeds. Tolerances are tests/test_torch_train_step.py's:
loss and grad norm at rtol 1e-5, parameters at atol 1e-5 after the step,
the attention key biases' (a vanishing leaf) at 3 lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hriemo.models import MoseiFusionWithEmotionDecoder
from hriemo.nn.module import flatten_params
from hriemo.parallel import make_mesh as jax_make_mesh
from hriemo.parallel import param_shardings as jax_param_shardings
from hriemo.parallel import train_step as JS
from hriemo_torch.nn.layers import MLP2, dropout, dropout_rows
from hriemo_torch.parallel import mesh as PM
from hriemo_torch.parallel.dryrun import dryrun_multichip
from hriemo_torch.parallel.launch import spawn

import torch_dist_workers as W
from torch_port_helpers import flat, one_torch_thread  # noqa: F401

LR = 1e-4
SPAWN_TIMEOUT = 300
RECIPE = dict(loss_type="multi_label", beta_entropy=1e-3, normalize_labels=True,
              warmup_steps=1, total_steps=6, schedule="warmup_cosine", lr=LR,
              weight_decay=0.05,
              pos_weight=np.asarray([0.5, 1.0, 2.0, 1.5, 0.8, 3.0], np.float32))


def _jax_model():
    return MoseiFusionWithEmotionDecoder(**W.MOSEI, dropout=0.0)


def _batch(seed, b=4, accum=1, la=10, lt=6):
    rng = np.random.default_rng(seed)
    lead = (accum, b) if accum > 1 else (b,)
    lens = lambda l: rng.integers(2, l + 1, size=lead)  # noqa: E731
    return {"h_a": rng.standard_normal(lead + (la, 8)).astype(np.float32),
            "h_t": rng.standard_normal(lead + (lt, 12)).astype(np.float32),
            "mask_a": np.arange(la) >= lens(la)[..., None],
            "mask_t": np.arange(lt) >= lens(lt)[..., None],
            "y": rng.uniform(-1, 4, lead + (6,)).astype(np.float32)}


def _int8_inputs():
    rng = np.random.default_rng(0)
    b, la, lt = 16, 16, 8
    return [rng.standard_normal((b, la, 128)).astype(np.float32),
            rng.standard_normal((b, lt, 128)).astype(np.float32),
            np.arange(la)[None, :] >= rng.integers(la // 2, la + 1, size=b)[:, None],
            np.arange(lt)[None, :] >= rng.integers(lt // 2, lt + 1, size=b)[:, None]]


def _nonfinite_batch():
    bad = _batch(11)
    bad["h_a"][3, 0, 0] = np.nan  # a row of the second data rank only
    return bad


DROPOUT = dict(cfg=dict(RECIPE, grad_accum=2), batches=[_batch(7, accum=2), _batch(8, accum=2)],
               dropout=0.1, gen_seed=5)
LEARN = dict(cfg=dict(RECIPE, lr=1e-3, grad_accum=2, total_steps=50, warmup_steps=2),
             batches=[_batch(9, accum=2)] * 8)


def _jobs2(params):
    return {
        "jax_dp": ("train_steps", dict(shape=(2, 1), cfg=RECIPE, batches=[_batch(1)],
                                       params=params)),
        "dropout_dp": ("train_steps", dict(shape=(2, 1), **DROPOUT)),
        "dropout_tp": ("train_steps", dict(shape=(1, 2), **DROPOUT)),
        "nonfinite_dp": ("train_steps", dict(shape=(2, 1), cfg=RECIPE,
                                             batches=[_nonfinite_batch()], params=params)),
        "nonfinite_tp": ("train_steps", dict(shape=(1, 2), cfg=RECIPE,
                                             batches=[_nonfinite_batch()], params=params)),
        "eval_dp": ("evaluate", dict(shape=(2, 1), batch=_batch(3, b=6), params=params)),
        "eval_tp": ("evaluate", dict(shape=(1, 2), batch=_batch(3, b=6), params=params)),
        "int8": ("int8_forward", dict(shape=(2, 1), inputs=_int8_inputs())),
        "refuse_3x1": ("make_mesh_refuses", dict(n_data=3, n_model=1)),
        "refuse_n_model_3": ("make_mesh_refuses", dict(n_data=None, n_model=3)),
    }


def _jobs4(params):
    return {
        "jax_2x2": ("train_steps", dict(shape=(2, 2), cfg=dict(RECIPE, grad_accum=2),
                                        batches=[_batch(2, accum=2)], params=params)),
        "dropout_2x2": ("train_steps", dict(shape=(2, 2), **DROPOUT)),
        "learns_2x2": ("train_steps", dict(shape=(2, 2), **LEARN)),
    }


def _run(n, jobs):
    """Every rank's result of each job: ``{name: [rank 0's, rank 1's, ...]}``."""
    per_rank = spawn(W.run_jobs, n, "cpu", list(jobs.values()), timeout=SPAWN_TIMEOUT)
    return {name: [r[i] for r in per_rank] for i, name in enumerate(jobs)}


@pytest.fixture(scope="module")
def jax_model():
    return _jax_model()


@pytest.fixture(scope="module")
def world2(jax_model):
    return _run(2, _jobs2(flat(jax_model.params)))


@pytest.fixture(scope="module")
def world4(jax_model):
    return _run(4, _jobs4(flat(jax_model.params)))


def _same_on_every_rank(results):
    for r in results[1:]:
        assert r["metrics"] == results[0]["metrics"] and r["counts"] == results[0]["counts"]
        for k, v in results[0]["params"].items():
            np.testing.assert_array_equal(r["params"][k], v, err_msg=k)


def _check_params(got, ref, lr=LR):
    """Parameters after the step within atol 1e-5; the attention key bias
    (its gradient is 0 in exact arithmetic, so Adam steps on rounding noise
    in either sign) within 3 lr."""
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        g = got[name]
        assert g.shape == r.shape, name
        if name.endswith("in_proj_bias"):
            d = g.shape[0] // 3
            np.testing.assert_allclose(g[d:2 * d], r[d:2 * d], rtol=0, atol=3 * lr, err_msg=name)
            g, r = np.delete(g, np.s_[d:2 * d]), np.delete(r, np.s_[d:2 * d])
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=name)


def _jax_step(jm, cfg_kw, batch, devices, n_model):
    mesh = jax_make_mesh(n_data=devices // n_model, n_model=n_model,
                         devices=jax.devices()[:devices])
    cfg = JS.TrainConfig(**cfg_kw)
    state = JS.create_train_state(jm, cfg, params=jm.params, mesh=mesh)
    state, m = JS.make_train_step(jm, cfg, mesh=mesh, donate=False)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(0))
    return {k: float(v) for k, v in m.items()}, flat(state.params)


# ------------------------------------------------------------- shardings


def test_param_shardings_match_jax(jax_model):
    """The TP rules give every parameter of the MOSEI model the spec JAX
    gives it, name by name, on a 4 x 2 mesh; on 8 x 1 everything is
    replicated."""
    tm = W.mosei_model()
    for n_data, n_model in ((4, 2), (8, 1)):
        jspecs = flatten_params(jax_param_shardings(
            jax_make_mesh(n_data=n_data, n_model=n_model), jax_model.params))
        specs = PM.param_shardings(PM.Mesh(n_data, n_model, 0, None, None), tm)
        assert list(specs) == [n for n, _ in tm.named_parameters()]
        assert specs == {k: tuple(v.spec) for k, v in jspecs.items()}
    assert sum(s != () for s in specs.values()) == 0
    # the two fusion FFNs and the decoder's, three sharded leaves each
    assert sum(s != () for s in PM.param_shardings(PM.Mesh(4, 2, 0, None, None), tm).values()) == 9


def test_sharded_mlp2_refuses_the_int8_route():
    """JAX never serves int8 under TP: a sharded FFN neither quantizes nor
    prepares the int8 MLP2 kernel."""
    model = W.mosei_model()
    mlp = model.backbone.cross_modal.layers[0].ffn_a
    hidden = mlp._modules["0"].weight.shape[0]
    PM.shard_params(model, PM.Mesh(1, 2, 1, None, None))
    assert isinstance(mlp, MLP2) and mlp._modules["0"].weight.shape[0] == hidden // 2
    with pytest.raises(ValueError, match="tensor-parallel"):
        mlp.prepare_kernels()
    with pytest.raises(ValueError, match="tensor-parallel"):
        mlp._modules["2"].quantize_(1)


def test_uneven_batches_and_meshes_are_refused(world2):
    mesh = PM.Mesh(2, 1, 1, None, None)
    with pytest.raises(ValueError, match="do not divide"):
        PM.shard_batch(_batch(0, b=3), mesh)
    with pytest.raises(ValueError, match="do not divide"):
        PM.shard_batch(_batch(0, b=3, accum=2), mesh, grad_accum=2)
    local = PM.shard_batch(_batch(0, b=4, accum=2), mesh, grad_accum=2)
    np.testing.assert_array_equal(local["h_a"], _batch(0, b=4, accum=2)["h_a"][:, 2:])
    assert world2["refuse_3x1"] == [True, True]         # 3 x 1 does not fill 2 ranks
    assert world2["refuse_n_model_3"] == [True, True]   # 2 ranks in groups of 3


# ---------------------------------------------------- steps against JAX


@pytest.mark.parametrize("case", ["jax_dp", "jax_2x2"])
def test_mesh_step_matches_jax(jax_model, world2, world4, case):
    """One step at n_data=2 (B=4), and at 2 x 2 with grad_accum=2 (micro
    batch 4), equals ``make_mesh``'s step in JAX on the same parameters and
    batch; every rank ends with the same whole parameters."""
    runs = (world2 if case == "jax_dp" else world4)[case]
    _same_on_every_rank(runs)
    if case == "jax_dp":
        metrics, ref = _jax_step(jax_model, RECIPE, _batch(1), 2, 1)
    else:
        metrics, ref = _jax_step(jax_model, dict(RECIPE, grad_accum=2), _batch(2, accum=2), 4, 2)
    got = runs[0]
    for key in ("loss", "grad_norm", "lr", "mean_beta"):
        np.testing.assert_allclose(got["metrics"][0][key], metrics[key], rtol=1e-5, err_msg=key)
    _check_params(got["params"], ref)


# --------------------------------------- steps against one process, dropout


@pytest.mark.parametrize("case", ["dropout_dp", "dropout_tp", "dropout_2x2"])
def test_mesh_step_matches_single_process_at_dropout(world2, world4, case):
    """At dropout 0.1 each rank draws its block of the whole batch's masks
    (and of the decoder's column-sharded hidden), so two steps over the
    mesh equal the port's single-process steps on the whole batch."""
    runs = (world4 if case == "dropout_2x2" else world2)[case]
    _same_on_every_rank(runs)
    ref = W.train_steps(None, **DROPOUT)
    for got, want in zip(runs[0]["metrics"], ref["metrics"]):
        for key in ("loss", "grad_norm", "lr", "mean_beta"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    _check_params(runs[0]["params"], ref["params"])


@pytest.mark.parametrize("rows, features", [((2, 4), None), ((0, 3), (4, 8)), ((3, 6), (0, 4))])
def test_dropout_block_is_the_whole_mask_block(rows, features):
    """A rank's mask (its rows under ``dropout_rows``, its feature block by
    ``features``) is that block of the whole tensor's mask, drawn in one
    process: the row generators depend on the row's index in the whole
    batch, not on how many rows a rank holds."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((6, 3, 12)).astype(np.float32))
    whole = dropout(x, 0.3, torch.Generator().manual_seed(9), True)
    cols = slice(None) if features is None else slice(features[0], features[0] + features[1])
    part = x[rows[0]:rows[1], :, cols]
    with dropout_rows(rows[0]):
        got = dropout(part, 0.3, torch.Generator().manual_seed(9), True,
                      None if features is None else (features[0], 12))
    assert torch.equal(got, whole[rows[0]:rows[1], :, cols])
    assert 0 < int((got == 0).sum()) < got.numel()


def test_mesh_step_learns(world4):
    """The port of test_dp_tp_train_step_runs_and_learns: 8 steps at 2 x 2
    with grad_accum=2 overfit one batch."""
    got = world4["learns_2x2"]
    _same_on_every_rank(got)
    losses = [m["loss"] for m in got[0]["metrics"]]
    assert np.isfinite(losses).all() and got[0]["counts"] == [8, 8, 0]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("case", ["nonfinite_dp", "nonfinite_tp"])
def test_nonfinite_batch_is_skipped_on_every_rank(jax_model, world2, case):
    """A NaN in one data rank's rows (or, under TP, in the shared batch)
    skips the step on every rank: parameters unchanged, one non-finite step
    counted, no update counted."""
    start = flat(jax_model.params)
    for got in world2[case]:
        assert got["counts"] == [1, 0, 1]
        for k, v in start.items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)


@pytest.mark.parametrize("case", ["eval_dp", "eval_tp"])
def test_sharded_eval_step_matches_unsharded(jax_model, world2, case):
    """Every rank gets the whole batch's loss, logits and beta, equal to the
    unsharded eval step's."""
    loss, logits, beta = W.evaluate(None, _batch(3, b=6), flat(jax_model.params))
    for got in world2[case]:
        np.testing.assert_allclose(got[0], loss, rtol=1e-5)
        np.testing.assert_allclose(got[1], logits, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got[2], beta, atol=1e-5, rtol=1e-5)


def test_int8_sharded_matches_single_process(world2):
    """The port of test_int8_sharded_matches_single_device: the int8 tree
    (d=128) over two data ranks, each on its rows, gathers what one process
    computes on the whole batch (atol 1e-5)."""
    logits, beta = W.int8_forward(None, _int8_inputs())
    for got in world2["int8"]:
        np.testing.assert_allclose(got[0], logits, atol=1e-5)
        np.testing.assert_allclose(got[1], beta, atol=1e-5)


# ------------------------------------------------------------- dry run


def test_dryrun_multichip_four_ranks(capsys):
    """``dryrun_multichip(4)``: a 2 x 2 mesh, the ring over 2 shards, DP
    serving of the float and int8 trees."""
    line = dryrun_multichip(4, "cpu")
    assert line.startswith("dryrun_multichip OK: mesh=(2 data x 2 model)")
    assert "sp ring attention OK (L=16 over 2 shards" in line
    assert "dp over 2) OK" in line and "== single-process" in line
    assert line in capsys.readouterr().out
