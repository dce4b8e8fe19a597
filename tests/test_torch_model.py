"""The port's Big LSTM against the JAX package's, on weights carried across.

Reduced Big LSTM (2 layers, 256 hidden, 64 projection, 512 vocab), one
batch of the synthetic stream, the JAX package's initial weights moved into
the port with ``repro_torch.convert``.

Tolerances:
  * float32 params: logits and loss to rtol 1e-5; gradients to rtol 1e-4
    with atol 1e-6·max|g| per leaf. Both sides sum the same products in
    different orders (XLA's and PyTorch's CPU matrix products), and the
    backward through 16 LSTM steps compounds that to a few 1e-6 relative;
  * bfloat16 params (the default): the two frameworks round the bf16
    products, the bf16 cell state and the embedding gradient's bf16
    scatter-add at different places, so logits are held to atol 3e-2 (a
    few bf16 ulps of values ~1), the fp32 loss to rtol 1e-3 and gradients
    to a relative Frobenius error of 5e-2 per leaf (measured: 1-1.5% on
    most leaves, 2.6% on head_b, a 64-term sum of bf16 cotangents).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.core import optimizers as jopt
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.models import build_model
from repro.models.counting import count_params as jax_count_params
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data import SyntheticLM
from repro_torch.models import build_model as port_build_model
from repro_torch.models import lstm
from repro_torch.models.counting import count_params
from repro_torch.tree import leaves


def _cfgs(param_dtype):
    jcfg = dataclasses.replace(jax_reduced(jax_get_arch("biglstm")),
                               param_dtype=param_dtype)
    tcfg = dataclasses.replace(reduced(get_arch("biglstm")),
                               param_dtype=param_dtype)
    return jcfg, tcfg


def _batch(cfg, seed=3):
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=16, n_workers=1,
                     seed=seed)
    return ds.worker_batch(0, 5, 4)


def _jax_and_port(param_dtype):
    jcfg, tcfg = _cfgs(param_dtype)
    model = build_model(jcfg)
    jparams = jax.jit(model.init)(jax.random.PRNGKey(7))
    tparams = convert.to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    batch = _batch(tcfg)
    return model, jparams, tcfg, tparams, batch


def _port_loss_and_grads(tparams, batch, tcfg):
    leaves_ = leaves(tparams)
    for t in leaves_:
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = port_build_model(tcfg).loss_fn(tparams, tb)   # training's
    grads = torch.autograd.grad(loss, leaves_)
    return loss.detach(), grads


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_logits_loss_and_grads_match_jax(param_dtype):
    model, jparams, tcfg, tparams, batch = _jax_and_port(param_dtype)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    jlogits = model.logits_fn(jparams, jb)
    (jloss, _), jgrads = jax.value_and_grad(model.loss_fn, has_aux=True)(
        jparams, jb)
    with torch.no_grad():
        tlogits = lstm.lstm_logits(tparams, torch.from_numpy(batch["tokens"]),
                                   tcfg)
    tloss, tgrads = _port_loss_and_grads(tparams, batch, tcfg)
    assert tlogits.dtype == getattr(torch, param_dtype)
    assert tlogits.shape == (4, 16, tcfg.vocab_size)
    jg = [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(jgrads)]
    tg = [g.float().numpy() for g in tgrads]
    assert [g.shape for g in jg] == [g.shape for g in tg]
    if param_dtype == "float32":
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(a, b, rtol=1e-4,
                                       atol=1e-6 * np.abs(b).max())
    else:
        np.testing.assert_allclose(tlogits.float().numpy(),
                                   np.asarray(jlogits, np.float32), atol=3e-2)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-3)
        for a, b in zip(tg, jg):
            assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b)


def test_convert_round_trips_params_and_opt_state_bit_exactly():
    jcfg, _ = _cfgs("bfloat16")
    params = build_model(jcfg).init(jax.random.PRNGKey(1))
    R = 2
    stacked = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x[None], (R,) + x.shape), params)
    opt = jopt.compressed_sync(jopt.local_adaalter(H=4), "int8")
    state = jax.vmap(opt.init)(stacked)
    state["b2_local"] = jax.tree_util.tree_map(lambda b: b * 1.37 + 0.1,
                                               state["b2_local"])
    tree = jax.tree_util.tree_map(np.asarray, (stacked, state))
    tp, ts = convert.to_torch(tree)
    assert tp["embed"].dtype == torch.bfloat16
    assert ts["b2_sync"]["embed"].dtype == torch.float32
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == (R,)
    back = convert.to_numpy((tp, ts), bf16=ml_dtypes.bfloat16)
    want_leaves, want_def = jax.tree_util.tree_flatten(tree)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_param_count_matches_reference_and_tree():
    for full in (False, True):
        jcfg = jax_get_arch("biglstm")
        tcfg = get_arch("biglstm")
        if not full:
            jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
        assert count_params(tcfg) == jax_count_params(jcfg)
    assert count_params(get_arch("biglstm")) == 832_198_527
    _, tcfg = _cfgs("float32")
    params = lstm.init_lstm(torch.Generator().manual_seed(0), tcfg)
    assert sum(t.numel() for t in leaves(params)) == count_params(tcfg)


def test_fresh_init_is_seeded_and_has_reference_shapes():
    jcfg, tcfg = _cfgs("bfloat16")
    jshapes = jax.tree_util.tree_map(
        lambda x: (x.shape, str(x.dtype)),
        jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0)))
    a = lstm.init_lstm(torch.Generator().manual_seed(5), tcfg, torch.bfloat16)
    b = lstm.init_lstm(torch.Generator().manual_seed(5), tcfg, torch.bfloat16)
    tshapes = jax.tree_util.tree_map(
        lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
        convert.to_numpy(a, ml_dtypes.bfloat16))
    assert tshapes == jax.tree_util.tree_map(lambda s: (tuple(s[0]), s[1]),
                                             jshapes,
                                             is_leaf=lambda s: isinstance(s, tuple))
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_synthetic_stream_is_the_reference_stream():
    kw = dict(vocab_size=997, seq_len=12, n_workers=3, seed=4)
    mine, theirs = SyntheticLM(**kw), JaxSyntheticLM(**kw)
    for step in (0, 5):
        a, b = mine.global_batch(step, 6), theirs.global_batch(step, 6)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_unported_architectures_raise():
    """Every architecture is registered, llama3-405b too (405.9 B
    parameters; training it waits for several cards); an unknown name is a
    KeyError; hymba-1.5b, ported, builds."""
    assert get_arch("llama3-405b").param_count() == 405_853_388_800
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    hymba = get_arch("hymba-1.5b")
    assert hymba.hybrid and port_build_model(reduced(hymba)).init(None, "meta")
