"""The port's data-parallel training against the JAX package.

Two gloo ranks on the CPU (``tests/torch_mesh_worker.py``, started once for
the file) run ``make_train_step(mesh)`` for every loss of the registry and
the autoencoder and TAE pairs, the same with a penalty read outside a model
call (weight decay over ``model.parameters()``, on one weight, on the
decoder), ``make_fused_train_step(mesh)`` on ``[l, n,
3]`` and ``[3n, l]``, unrolled and ``mode="blocked"`` (the plain versions on
the CPU), the committee step in its three batch modes, and ``fit(mesh)``
with a checkpoint and a resume: alanine with a ``[38, 8, 2]`` head, weights
made by JAX and carried across by ``.npz``, 64 noisy frames from a numpy
seed, two Adam steps at ``lr=1e-2``. Each is held to JAX's one-device step
and to its ``data_mesh(2)`` step on the conftest's virtual devices.
Tolerances: losses and weights after the steps 1e-5, parameter gradients
of the last step 5e-5·max(1, max|g|). Both ranks hold the same bits, and a
resume repeats the uninterrupted run bit for bit. The ``train`` command's
``--devices 2 --device cpu`` gives ``--devices 1``'s model within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molann_tpu.ann import create_sequential_nn as jcreate_sequential_nn
from molann_tpu.io import save_model as jsave_model
from molann_tpu.parallel import data_mesh as jdata_mesh
from molann_tpu.parallel import shard_batch as jshard_batch
from molann_tpu.parallel.mesh import replicated_sharding
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train import autoencoder_loss as jautoencoder_loss
from molann_tpu.train import fit as jfit
from molann_tpu.train import make_ensemble_train_step as jmake_ensemble_step
from molann_tpu.train import make_train_step as jmake_train_step
from molann_tpu.train import masked_optimizer as jmasked_optimizer
from molann_tpu.train import mse_loss as jmse_loss
from molann_tpu.train import stack_models as jstack_models
from molann_tpu.train import timelagged_autoencoder_loss as jtae_loss
from molann_tpu.train import trainable_mask as jtrainable_mask
from molann_tpu.train.losses import registry as jregistry
from molann_tpu_torch.cli import main
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import named_tensors
from molann_tpu_torch.train import (make_ensemble_train_step,
                                    masked_optimizer, mse_loss,
                                    trainable_mask)
from torch_mesh_worker import PENALTY, STEPS, Ranks, load

N = 22
L = 64
LR = 1e-2
TOL = 1e-5
GRAD = 5e-5
REF = "t:preprocessing_layer.align_layer.ref_x"
# losses that do not depend on the output bias (centred moments): its
# gradient is rounding noise on both sides, which Adam scales to the
# learning rate, so that weight is held by its gradient alone
BIAS_FREE = {"eigenfunction", "vamp"}
LOSSES = ("mse", "eigenfunction", "committor", "vamp", "autoencoder", "tae",
          # a penalty read outside a model call: over ``model.parameters()``,
          # on ``model.ann_layers.layers[0].weight``, over the decoder's
          # ``named_parameters()``
          "mse_decay", "mse_first_weight", "autoencoder_decoder_decay")
PAIRS = ("autoencoder", "tae", "autoencoder_decoder_decay")
CASES = ([f"step_{k}" for k in LOSSES]
         + [f"fused_{a}_{m}" for a in ("lna", "t")
            for m in ("auto", "blocked")]
         + [f"ensemble_{m}" for m in ("shared", "member", "bagging")]
         + ["fit", "penalty_share", "bypass"])


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, written for the ranks, which start at once and run while
    the tests compute JAX's references."""
    d = tmp_path_factory.mktemp("mesh_train")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(3))
    jdec = jcreate_sequential_nn([2, 8, 38], key=jax.random.PRNGKey(4))
    jsave_model(str(d / "model.npz"), jm)
    jsave_model(str(d / "pair.npz"), (jm, jdec))
    jmembers = [jalanine_model(hidden_dims=(8, 2),
                               key=jax.random.PRNGKey(5 + i))[0]
                for i in range(2)]
    for i, m in enumerate(jmembers):
        jsave_model(str(d / f"member{i}.npz"), m)
    rng = np.random.default_rng(11)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(L, N, 3))).astype(np.float32)
    arrays = dict(
        x=x, y=rng.normal(size=(L, 2)).astype(np.float32),
        w=rng.uniform(0.5, 2.0, L).astype(np.float32),
        labels=rng.permutation(np.repeat([1, 0, 2], [20, 24, 20])).astype(
            np.int32),
        x_t=x[:L // 2], x_tau=x[L // 2:],
        w_t=rng.uniform(0.5, 2.0, L // 2).astype(np.float32))
    for k, v in arrays.items():
        np.save(d / f"{k}.npy", v)
    ranks = Ranks("train", d)
    yield dict(d=d, ranks=ranks, jm=jm, jdec=jdec, jmembers=jmembers,
               **arrays)
    ranks.close()


def _out(s, case, rank=0):
    s["ranks"].wait()
    return load(s["d"], case, rank)


def _penalty(params):
    return PENALTY * sum(jnp.sum(w * w) + jnp.sum(b * b) for w, b in params)


def _jax_loss(name):
    if name == "mse_decay":
        return lambda m, batch: (jmse_loss(m, batch)
                                 + _penalty(m.ann_layers.params))
    if name == "mse_first_weight":
        def loss(m, batch):
            w = m.ann_layers.params[0][0]
            return jmse_loss(m, batch) + PENALTY * jnp.sum(w * w)
        return loss
    if name == "autoencoder_decoder_decay":
        ae = _jax_loss("autoencoder")
        return lambda pair, x: ae(pair, x) + _penalty(pair[1].params)
    if name == "autoencoder":
        def loss(pair, x):
            m, dec = pair
            return jautoencoder_loss(m.ann_layers, dec, m.preprocessing_layer,
                                     x)
        return loss
    if name == "tae":
        def loss(pair, batch):
            m, dec = pair
            return jtae_loss(m.ann_layers, dec, m.preprocessing_layer, *batch)
        return loss
    return jregistry[name]


def _batch(s, name):
    names = {"mse": ("x", "y"), "eigenfunction": ("x", "w"),
             "committor": ("x", "labels"), "vamp": ("x_t", "x_tau", "w_t"),
             "autoencoder": "x", "tae": ("x_t", "x_tau"),
             "mse_decay": ("x", "y"), "mse_first_weight": ("x", "y"),
             "autoencoder_decoder_decay": "x"}[name]
    if isinstance(names, str):
        return jnp.asarray(s[names])
    return tuple(jnp.asarray(s[n]) for n in names)


def _jax_steps(loss_fn, model, batch, mesh=None):
    """JAX's training after ``STEPS`` Adam steps: ``(model, losses,
    gradients of the last step)``; the gradients only without a mesh."""
    opt = jmasked_optimizer(optax.adam(LR), jtrainable_mask(model))
    state = opt.init(model)
    losses, grads = [], None
    if mesh is None:
        @jax.jit
        def step(model, state, batch):
            loss, grads = jax.value_and_grad(loss_fn)(model, batch)
            updates, state = opt.update(grads, state, model)
            return optax.apply_updates(model, updates), state, loss, grads

        for _ in range(STEPS):
            model, state, loss, grads = step(model, state, batch)
            losses.append(float(loss))
        return model, losses, grads
    step = jmake_train_step(loss_fn, opt, mesh)
    repl = replicated_sharding(mesh)
    model, state = jax.device_put(model, repl), jax.device_put(state, repl)
    batch = jshard_batch(batch, mesh)
    for _ in range(STEPS):
        model, state, loss = step(model, state, batch)
        losses.append(float(loss))
    return model, losses, None


def _mlp(prefix, jmlp):
    """``{port name: JAX array}`` of an MLP, weights transposed to torch's
    ``[d_out, d_in]``."""
    out = {}
    for i, (w, b) in enumerate(jmlp.params):
        out[f"{prefix}layers.{i}.weight"] = np.asarray(w).T
        out[f"{prefix}layers.{i}.bias"] = np.asarray(b).reshape(-1)
    return out


def _parts(jmodel, pair):
    """``{port key suffix: JAX array}`` of a model or a ``(model, decoder)``
    pair, as the ranks name them."""
    if pair:
        return {**{f"0{k}": v for k, v in _mlp("ann_layers.",
                                               jmodel[0].ann_layers).items()},
                **{f"1{k}": v for k, v in _mlp("", jmodel[1]).items()}}
    return {f"0{k}": v for k, v in _mlp("ann_layers.",
                                        jmodel.ann_layers).items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


def _grad_tol(g):
    return GRAD * max(1.0, float(np.abs(g).max()))


def _check_step(got, jmodel, jlosses, jgrads, pair, skip_bias=False):
    np.testing.assert_allclose(got["losses"], jlosses, rtol=TOL, atol=TOL)
    want = _parts(jmodel, pair)
    last_bias = max(k for k in want if k.startswith("0") and "bias" in k)
    for k, v in want.items():
        if not (skip_bias and k == last_bias):
            _close(got[k[0] + "t:" + k[1:]], v, TOL)
    if jgrads is not None:
        for k, g in _parts(jgrads, pair).items():
            _close(got[k[0] + "g:" + k[1:]], g, _grad_tol(g))


@pytest.mark.parametrize("reference", ["one_device", "data_mesh2"])
@pytest.mark.parametrize("name", LOSSES)
def test_train_step_matches_jax(setup, name, reference):
    """``make_train_step(loss, mesh)`` on two ranks computes the full-batch
    loss, exactly as JAX's GSPMD step does, for the batch-statistic losses
    too: its losses, gradients and weights are JAX's one-device and
    ``data_mesh(2)`` steps'. A penalty that reads the parameters outside
    a model call counts once: every rank computes it whole, and the
    wrapper scales its gradient by ``1/size`` before the all-reduce."""
    s = setup
    pair = name in PAIRS
    jmodel = (s["jm"], s["jdec"]) if pair else s["jm"]
    mesh = jdata_mesh(2) if reference == "data_mesh2" else None
    jmodel, jlosses, jgrads = _jax_steps(_jax_loss(name), jmodel,
                                         _batch(s, name), mesh)
    got = _out(s, f"step_{name}")
    _check_step(got, jmodel, jlosses, jgrads, pair, name in BIAS_FREE)
    np.testing.assert_array_equal(
        got["0" + REF],
        np.asarray(s["jm"].preprocessing_layer.align_layer.ref_x))


def test_a_penalty_outside_a_call_counts_once(setup):
    """One step of ``mse + 1e-2 * sum(|p|^2 for p in model.parameters())``
    on two ranks: the all-reduced gradient less the gradient without a
    mesh holds no share of the penalty's own gradient (JAX's GSPMD step
    counts the term once)."""
    got = _out(setup, "penalty_share")
    extra = got["ranks"].astype(np.float64) - got["plain"]
    pen = got["penalty"].astype(np.float64)
    counted = 1.0 + float(extra @ pen / (pen @ pen))
    assert abs(counted - 1.0) < 1e-4, f"the penalty counted {counted} times"
    _close(got["ranks"], got["plain"], _grad_tol(got["plain"]))


def test_a_read_past_the_wrapper_raises_naming_the_parameter(setup):
    """A loss that closes over the model it trains reads a parameter past
    the ``ShardedModel``: on two ranks ``make_train_step(loss, mesh)`` and
    ``fit(..., mesh=)`` raise a ``RuntimeError`` that names it, and a world
    of one (``data_mesh(1)``, no collectives) runs the loss with the bits of
    the step without a mesh."""
    got = _out(setup, "bypass")
    for how in ("step", "fit"):
        msg = str(got[f"error_{how}"])
        assert "ann_layers.layers.0.weight" in msg, (how, msg)
    mine = [k for k in got if k.startswith("none:")]
    assert {"none:losses", "none:g:ann_layers.layers.0.weight"} <= set(mine)
    for k in mine:
        np.testing.assert_array_equal(got["one:" + k[5:]], got[k], err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_ranks_hold_the_same_bits(setup, case):
    """Every rank ends every case with the same bits: the reductions are
    one all-reduce in a fixed order."""
    a, b = _out(setup, case, 0), _out(setup, case, 1)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{case} {k}")


@pytest.fixture(scope="module")
def jax_mse(setup):
    """JAX's MSE training on the whole batch, one device and mesh."""
    batch = (jnp.asarray(setup["x"]), jnp.asarray(setup["y"]))
    return {ref: _jax_steps(jmse_loss, setup["jm"], batch,
                            jdata_mesh(2) if ref == "data_mesh2" else None)
            for ref in ("one_device", "data_mesh2")}


@pytest.mark.parametrize("mode", ["auto", "blocked"])
@pytest.mark.parametrize("layout", ["lna", "t"])
def test_fused_train_step_matches_jax(setup, jax_mse, layout, mode):
    """``make_fused_train_step(mesh)`` averages the ranks' losses and
    gradients (JAX's ``shard_map`` step): with equal shards, the
    full-batch MSE step of JAX on one device and on ``data_mesh(2)``."""
    got = _out(setup, f"fused_{layout}_{mode}")
    got = {("0" + k if k[0] in "tg" else k): v for k, v in got.items()}
    for ref, (jmodel, jlosses, jgrads) in jax_mse.items():
        _check_step(got, jmodel, jlosses, jgrads, False)


def _jax_ensemble(setup, mode, mesh):
    stacked = jstack_models(setup["jmembers"])
    opt = jmasked_optimizer(optax.adam(LR), jtrainable_mask(stacked))
    states = jax.vmap(opt.init)(stacked)
    step = jmake_ensemble_step(jmse_loss, opt, mesh, batch_mode=mode)
    x, y = setup["x"], setup["y"]
    batch = ((np.stack([x, x[::-1]]), np.stack([y, y[::-1]]))
             if mode == "member" else (x, y))
    losses = []
    for _ in range(STEPS):
        stacked, states, loss = step(stacked, states, batch)
        losses.append(np.asarray(loss))
    return stacked, np.array(losses)


@pytest.mark.parametrize("mode", ["shared", "member"])
def test_ensemble_step_matches_jax(setup, mode):
    """The committee step on two ranks takes JAX's per-shard ``pmean`` of
    each member's loss and gradients (frames on axis 1 in ``"member"``
    mode): JAX's ``data_mesh(2)`` step."""
    got = _out(setup, f"ensemble_{mode}")
    stacked, losses = _jax_ensemble(setup, mode, jdata_mesh(2))
    np.testing.assert_allclose(got["losses"], losses, rtol=TOL, atol=TOL)
    for i in range(2):
        for li, (w, b) in enumerate(stacked.ann_layers.params):
            _close(got[f"{i}t:ann_layers.layers.{li}.weight"],
                   np.asarray(w)[i].T, TOL)
            _close(got[f"{i}t:ann_layers.layers.{li}.bias"],
                   np.asarray(b)[i].reshape(-1), TOL)


def test_ensemble_bagging_is_a_stratified_bootstrap(setup):
    """Bagging on two ranks resamples within each rank's shard, the same
    local indices on both (one generator seed): the one-device committee
    step on each member's two resampled shards, concatenated."""
    x, y = setup["x"], setup["y"]
    h = L // 2
    ms = [load_model(str(setup["d"] / f"member{i}.npz"), device="cpu")
          for i in range(2)]
    adam = functools.partial(torch.optim.Adam, lr=LR)
    opts = [masked_optimizer(adam, trainable_mask(m))(m) for m in ms]
    step = make_ensemble_train_step(mse_loss, batch_mode="member")
    gen = torch.Generator().manual_seed(5)
    losses = []
    for _ in range(STEPS):
        xb, yb = [], []
        for _ in range(2):
            idx = torch.randint(0, h, (h,), generator=gen).numpy()
            xb.append(np.concatenate([x[:h][idx], x[h:][idx]]))
            yb.append(np.concatenate([y[:h][idx], y[h:][idx]]))
        ms, opts, loss = step(ms, opts, (np.stack(xb), np.stack(yb)))
        losses.append(loss.numpy())
    got = _out(setup, "ensemble_bagging")
    np.testing.assert_allclose(got["losses"], np.array(losses), rtol=TOL,
                               atol=TOL)
    for i, m in enumerate(ms):
        for k, t in named_tensors(m):
            _close(got[f"{i}t:{k}"], t.detach().numpy(), TOL)


def test_fit_resumes_bit_identical_and_matches_jax(setup):
    """``fit(mesh)``: rank 0 alone writes the checkpoints, a resume from
    step 2 on both ranks repeats steps 3-4 bit for bit, and the run is
    JAX's ``fit`` on ``data_mesh(2)``."""
    x, y = setup["x"], setup["y"]
    batches = [(x[s:s + 32], y[s:s + 32]) for s in (0, 32, 16)] * 2
    got = _out(setup, "fit")
    assert list(got["ckpts"]) == [f"ckpt_{s:010d}.{k}.npz"
                                  for s in (2, 4) for k in ("model", "opt")]
    np.testing.assert_array_equal(got["resumed"], got["losses"][2:])
    for k in got:
        if k.startswith("t:"):
            np.testing.assert_array_equal(got["r" + k], got[k])
    res = jfit(setup["jm"], jmse_loss, iter(batches),
               optimizer=optax.adam(LR), mesh=jdata_mesh(2), num_steps=4)
    np.testing.assert_allclose(got["losses"], res.losses, rtol=TOL, atol=TOL)
    for k, v in _mlp("ann_layers.", res.model.ann_layers).items():
        _close(got[f"t:{k}"], v, TOL)


@pytest.mark.parametrize("loss", ["mse", "committor"])
def test_train_command_on_two_ranks(setup, tmp_path, capfd, loss):
    """``train --devices 2 --device cpu`` starts two gloo ranks, takes
    batches of a multiple of 2, and writes ``--devices 1``'s model."""
    d = setup["d"]
    extra = (["--targets", str(d / "y.npy")] if loss == "mse"
             else ["--labels", str(d / "labels.npy")])
    outs = {}
    for n in (1, 2):
        out = tmp_path / f"trained{n}.npz"
        rc = main(["train", str(d / "model.npz"), str(d / "x.npy"),
                   "--loss", loss, *extra, "--steps", "3", "--batch-size",
                   "32", "--lr", "0.01", "--log-every", "0", "--devices",
                   str(n), "--device", "cpu", "--out", str(out)])
        assert rc == 0
        assert "trained 3 steps" in capfd.readouterr().out
        outs[n] = dict(named_tensors(load_model(str(out), device="cpu")))
    for k, t in outs[1].items():
        _close(outs[2][k].detach().numpy(), t.detach().numpy(), TOL)
