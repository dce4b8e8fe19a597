"""The port's optimizers against the JAX package's and the paper's pseudocode.

Tolerances:
  * against ``repro.core.optimizers`` (compiled, as the train step runs
    them) on identical grads: fp32 params to rtol 1e-6 (XLA may rewrite
    g/sqrt(a) into g·rsqrt(a) and contract a product into an add; each is
    an ulp of the update); bf16 params to rtol 1e-2 (such an ulp can move
    a bf16 store by one bf16 ulp, 2^-8 relative);
  * against the float64 NumPy transcriptions in ``repro.core.reference``:
    rtol 3e-5, atol 1e-6 — the JAX package's own tolerance there;
  * bitwise: local_adaalter with H=1 and one worker against adaalter
    inside the port; warmup_lr against the compiled reference; and the
    int8 error-feedback sync (wire, residuals, averaged state) on identical
    state, where the encode is bitwise by construction and the mean of two
    workers is exact.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import optimizers as jopt
from repro.core import reference as ref
from repro_torch import convert
from repro_torch.core import optimizers as topt
from repro_torch.launch.steps import mean_over_workers
from repro_torch.tree import leaves, tree_map

T, N, D = 8, 2, 48
WARMUP = 3


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    grads = rng.normal(size=(T, N, D)).astype(np.float32)
    x0 = rng.normal(size=D).astype(np.float32)
    return x0, grads


def _jmean(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(jnp.mean(x, axis=0, keepdims=True),
                                   x.shape), tree)


def _tj(a, dtype):
    """fp32 numpy -> (jax array, port tensor) holding the same bits."""
    j = jnp.asarray(a).astype(dtype)
    return j, convert.to_torch(np.asarray(j))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


SYNC_ALGS = {
    "sgd": (lambda m: m.sgd(lr=0.1, warmup_steps=WARMUP)),
    "adagrad": (lambda m: m.adagrad(lr=0.5, eps=1.0, b0=0.0,
                                    warmup_steps=WARMUP)),
    "adaalter": (lambda m: m.adaalter(lr=0.5, eps=1.0, b0=1.0,
                                      warmup_steps=WARMUP)),
}
LOCAL_ALGS = {
    "local_sgd": (lambda m: m.local_sgd(lr=0.1, H=2, warmup_steps=WARMUP)),
    "local_adaalter": (lambda m: m.local_adaalter(lr=0.5, eps=1.0, b0=1.0,
                                                  H=2,
                                                  warmup_steps=WARMUP)),
}
DTYPES = {"float32": (jnp.float32, 1e-6), "bfloat16": (jnp.bfloat16, 1e-2)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("alg", list(SYNC_ALGS))
def test_sync_algorithm_matches_jax(problem, alg, dtype):
    x0, grads = problem
    jdt, rtol = DTYPES[dtype]
    jo, to = SYNC_ALGS[alg](jopt), SYNC_ALGS[alg](topt)
    jx, tx = _tj(x0, jdt)
    jp, tp = {"w": jx}, {"w": tx}
    js, ts = jo.init(jp), to.init(tp)
    jupdate = jax.jit(jo.update)
    for g in grads:
        gm, sq = g.mean(axis=0), (g ** 2).mean(axis=0)
        jg, tg = _tj(gm, jdt)
        jp, js = jupdate({"w": jg}, {"w": jnp.asarray(sq)}, js, jp)
        tp, ts = to.update({"w": tg}, {"w": torch.from_numpy(sq)}, ts, tp)
        assert tp["w"].dtype == tx.dtype
        np.testing.assert_allclose(_np(tp["w"]), _np(jp["w"]), rtol=rtol,
                                   atol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == T
    if "b2" in ts:
        np.testing.assert_allclose(ts["b2"]["w"].numpy(),
                                   np.asarray(js["b2"]["w"]), rtol=1e-6)


def _run_local_pair(jo, to, x0, grads, jdt):
    jx, tx = _tj(np.broadcast_to(x0, (N,) + x0.shape), jdt)
    jp, tp = {"w": jx}, {"w": tx}
    js, ts = jax.vmap(jo.init)(jp), to.init(tp, workers=N)
    jstep = jax.jit(jax.vmap(jo.local_step))
    jsync = jax.jit(lambda p, s: jo.sync(p, s, _jmean))
    for t, g in enumerate(grads, start=1):
        jg, tg = _tj(g, jdt)
        jp, js = jstep({"w": jg}, js, jp)
        tp, ts = to.local_step({"w": tg}, ts, tp)
        if t % jo.H == 0:
            jp, js = jsync(jp, js)
            tp, ts = to.sync(tp, ts, mean_over_workers)
        yield jp, js, tp, ts


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("alg", list(LOCAL_ALGS))
def test_local_algorithm_matches_jax(problem, alg, dtype):
    x0, grads = problem
    jdt, rtol = DTYPES[dtype]
    for jp, js, tp, ts in _run_local_pair(LOCAL_ALGS[alg](jopt),
                                          LOCAL_ALGS[alg](topt), x0, grads,
                                          jdt):
        np.testing.assert_allclose(_np(tp["w"]), _np(jp["w"]), rtol=rtol,
                                   atol=1e-6)
        np.testing.assert_array_equal(ts["step"].numpy(),
                                      np.asarray(js["step"]))
        if "b2_local" in ts:
            np.testing.assert_array_equal(ts["tprime"].numpy(),
                                          np.asarray(js["tprime"]))
            for k in ("b2_sync", "b2_local"):
                np.testing.assert_allclose(ts[k]["w"].numpy(),
                                           np.asarray(js[k]["w"]), rtol=1e-6)


def _port_sync_run(o, x0, grads):
    params = {"w": torch.from_numpy(np.array(x0))}
    state = o.init(params)
    out = []
    for g in grads:
        params, state = o.update({"w": torch.from_numpy(g.mean(axis=0))},
                                 {"w": torch.from_numpy((g ** 2).mean(axis=0))},
                                 state, params)
        out.append(params["w"].numpy().copy())
    return np.asarray(out), state


def _port_local_run(o, x0, grads, n):
    params = {"w": torch.from_numpy(np.array(
        np.broadcast_to(x0, (n,) + x0.shape)))}
    state = o.init(params, workers=n)
    out = []
    for t, g in enumerate(grads, start=1):
        params, state = o.local_step({"w": torch.from_numpy(g[:n])}, state,
                                     params)
        if t % o.H == 0:
            params, state = o.sync(params, state, mean_over_workers)
        out.append(params["w"].numpy().copy())
    return np.asarray(out), state


@pytest.mark.parametrize("alg", ["adagrad", "adaalter", "local_sgd",
                                 "local_adaalter"])
def test_matches_paper_pseudocode(problem, alg):
    x0, grads = problem
    if alg == "adagrad":
        ours, st = _port_sync_run(topt.adagrad(0.5, 1.0, 0.0), x0, grads)
        want, b2 = ref.ref_adagrad(x0, grads, lr=0.5, eps=1.0, b0=0.0)
    elif alg == "adaalter":
        ours, st = _port_sync_run(topt.adaalter(0.5, 1.0, 1.0), x0, grads)
        want, b2 = ref.ref_adaalter(x0, grads, lr=0.5, eps=1.0, b0=1.0)
    elif alg == "local_sgd":
        ours, st = _port_local_run(topt.local_sgd(0.3, H=4), x0, grads, N)
        want, b2 = ref.ref_local_sgd(x0, grads, lr=0.3, H=4), None
    else:
        ours, st = _port_local_run(topt.local_adaalter(0.5, 1.0, 1.0, H=4),
                                   x0, grads, N)
        want, b2 = ref.ref_local_adaalter(x0, grads, lr=0.5, eps=1.0, H=4)
    np.testing.assert_allclose(ours, want, rtol=3e-5, atol=1e-6)
    if b2 is not None:
        got = st["b2"]["w"] if "b2" in st else st["b2_local"]["w"]
        np.testing.assert_allclose(got.numpy(), b2, rtol=3e-5)


def test_local_adaalter_h1_equals_adaalter(problem):
    x0, grads = problem
    one = grads[:, :1]                        # one worker: bit-identical
    local, _ = _port_local_run(topt.local_adaalter(0.5, 1.0, 1.0, H=1), x0,
                               one, 1)
    sync_, _ = _port_sync_run(topt.adaalter(0.5, 1.0, 1.0), x0, one)
    np.testing.assert_array_equal(local[:, 0], sync_)
    # several workers: equal up to the order of the mean and the update
    local, _ = _port_local_run(topt.local_adaalter(0.5, 1.0, 1.0, H=1), x0,
                               grads, N)
    sync_, _ = _port_sync_run(topt.adaalter(0.5, 1.0, 1.0), x0, grads)
    for i in range(N):
        np.testing.assert_allclose(local[:, i], sync_, rtol=1e-6, atol=1e-7)


def test_warmup_lr_matches_compiled_reference():
    for warmup in (0, 7, 100, 600):
        steps = np.arange(1, 1500, dtype=np.int32)
        want = jax.jit(jax.vmap(lambda s: jopt.warmup_lr(0.5, s, warmup)))(
            jnp.asarray(steps))
        got = np.array([topt.warmup_lr(0.5, int(s), warmup) for s in steps],
                       np.float32)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want, np.float32).view(
                                          np.uint32))


@pytest.mark.parametrize("batch_ndim", [0, 1])
def test_clip_by_global_norm_matches_jax(batch_ndim):
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(2, 30)).astype(np.float32) * 4,
            "b": [rng.normal(size=(2, 5, 7)).astype(np.float32)]}
    jc, jf = jopt.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, tree), 1.5, batch_ndim)
    tc, tf = topt.clip_by_global_norm(convert.to_torch(tree), 1.5,
                                      batch_ndim)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(tc["b"][0].numpy(), np.asarray(jc["b"][0]),
                               rtol=1e-6)
    assert topt.clip_by_global_norm(tree, 0.0)[0] is tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compressed_sync_int8_bitwise_vs_jax(problem, dtype):
    """On identical state, the int8 EF sync round gives the reference's
    wire, residuals and averaged state bit for bit."""
    x0, grads = problem
    jdt = DTYPES[dtype][0]
    jo = jopt.compressed_sync(jopt.local_adaalter(0.5, H=2), "int8",
                              use_pallas=False)
    to = topt.compressed_sync(topt.local_adaalter(0.5, H=2), "int8",
                              use_kernels=True)
    jx = jnp.asarray(np.broadcast_to(x0, (N,) + x0.shape)).astype(jdt)
    jp = {"w": jx, "v": jnp.asarray(grads[0, :, :7]).astype(jdt)}
    js = jax.vmap(jo.init)(jp)
    jstep = jax.jit(jax.vmap(jo.local_step))
    for g in grads[:3]:                      # diverge workers and residuals
        jp, js = jstep({"w": jnp.asarray(g).astype(jdt),
                        "v": jnp.asarray(g[:, :7] * 3).astype(jdt)}, js, jp)
        jp, js = jax.jit(lambda p, s: jo.sync(p, s, _jmean))(jp, js)
        jp, js = jstep({"w": jnp.asarray(g * 2).astype(jdt),
                        "v": jnp.asarray(g[:, 3:10]).astype(jdt)}, js, jp)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    tp, ts = convert.to_torch(as_np((jp, js)))
    jp2, js2 = jax.jit(lambda p, s: jo.sync(p, s, _jmean))(jp, js)
    tp2, ts2 = to.sync(tp, ts, mean_over_workers)
    for k in ("w", "v"):
        np.testing.assert_array_equal(
            convert.to_numpy(tp2[k], ml_dtypes.bfloat16).view(np.uint8),
            np.asarray(jp2[k]).view(np.uint8))
        for s in ("b2_sync", "b2_local", "res_params", "res_b2"):
            np.testing.assert_array_equal(
                ts2[s][k].numpy().view(np.uint32),
                np.asarray(js2[s][k]).view(np.uint32))
    assert int(ts2["tprime"][0]) == 0


@pytest.mark.parametrize("compression", ["", "int8"])
def test_sync_consumes_the_state_it_is_given(problem, compression):
    """The aliasing rule of ``LocalOptimizer``: a local step writes over
    none of its inputs; a sync may (the in-place mean over the params and
    b2_local it is given; the int8 kernel path's residuals), and handing
    it clones keeps the caller's state and gives the same result."""
    x0, grads = problem
    o = topt.compressed_sync(topt.local_adaalter(0.5, H=2), compression,
                             use_kernels=True)
    params = {"w": torch.from_numpy(np.array(np.broadcast_to(x0, (N, D))))}
    state = o.init(params, workers=N)
    for g in grads[:2]:                     # diverge workers and residuals
        params, state = o.local_step({"w": torch.from_numpy(g)}, state,
                                     params)
        params, state = o.sync(params, state, mean_over_workers)
    clone = lambda tree: tree_map(torch.clone, tree)
    same = lambda a, b: all(torch.equal(x, y) for x, y in
                            zip(leaves(a), leaves(b)))
    inputs = (params, state)
    before = clone(inputs)
    params, state = o.local_step({"w": torch.from_numpy(grads[2])}, state,
                                 params)
    assert same(inputs, before)              # the local step wrote over none
    assert not same((params, state), before)
    kept = clone((params, state))
    via_clones = o.sync(*clone((params, state)), mean_over_workers)
    assert same((params, state), kept)       # the clones were consumed
    synced = o.sync(params, state, mean_over_workers)
    assert same(synced, via_clones)
    if compression:
        # residuals written in place; params and b2_local only read
        assert synced[1]["res_params"]["w"] is state["res_params"]["w"]
        assert not torch.equal(state["res_params"]["w"],
                               kept[1]["res_params"]["w"])
        assert torch.equal(params["w"], kept[0]["w"])
    else:
        # the mean was written over the params and b2_local handed in
        assert synced[0]["w"] is params["w"]
        assert synced[1]["b2_local"]["w"] is state["b2_local"]["w"]
        assert not torch.equal(params["w"], kept[0]["w"])


@pytest.mark.parametrize("algorithm", ["sgd", "adagrad", "adaalter",
                                       "local_sgd", "local_adaalter"])
@pytest.mark.parametrize("compression", ["", "fp32", "bf16", "int8"])
def test_comm_accounting_matches_jax(algorithm, compression):
    from repro.core import comm as jcomm
    from repro_torch.core import comm as tcomm
    n = 832_198_527
    assert tcomm.payload_bytes(n, 4, compression) == jcomm.payload_bytes(
        n, 4, compression)
    assert tcomm.sync_payload_bytes(algorithm, n, compression=compression) \
        == jcomm.sync_payload_bytes(algorithm, n, compression=compression)
    assert tcomm.sync_bytes_per_step(algorithm, n, H=4,
                                     compression=compression) \
        == jcomm.sync_bytes_per_step(algorithm, n, H=4,
                                     compression=compression)
    for flat in (False, True):
        assert tcomm.round_collectives(algorithm, 11, flat=flat) == \
            jcomm.round_collectives(algorithm, 11, flat=flat)
    for fused in (True, False):
        assert tcomm.ef_sync_hbm_bytes(n, fused=fused, dtype_bytes=2) == \
            jcomm.ef_sync_hbm_bytes(n, fused=fused, dtype_bytes=2)


def test_sync_engine_state_round_trips_and_unported_codec_paths_raise():
    from repro_torch.configs import OptimizerConfig, SyncConfig
    from repro_torch.core.codecs import get_codec
    from repro_torch.core.sync_engine import make_sync_engine
    oc = OptimizerConfig.from_sync(SyncConfig(policy="adaptive",
                                              threshold=0.5), H=4)
    engine = make_sync_engine(oc, H=4)
    engine.reset(0)
    for step in range(3):
        engine.observe(step, engine.want_sync(step), {"drift": 0.1})
    st = engine.export_state()
    other = make_sync_engine(oc, H=4)
    other.reset(0)
    other.import_state(st)
    assert other.policy.host_state() == engine.policy.host_state() == (3, 0.1 + 0.1 + 0.1)
    assert engine.round_collectives(11) == 22
    assert engine.round_collectives(11, flat=True) == 1
    # the unfused int8 codec round-trips through the quantize pair, as the
    # reference's does, and its one-pass encode is stripped
    codec = get_codec("int8", fused=False)
    assert codec.ef_roundtrip is None
    x = np.random.default_rng(0).standard_normal((2, 700)).astype(np.float32)
    got = codec.roundtrip(torch.from_numpy(x), 1)
    from repro.core.codecs import get_codec as jget_codec
    want = jax.jit(lambda a: jget_codec("int8", fused=False).roundtrip(a, 1))(
        jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert got.shape == (2, 700)
    assert float((got - torch.from_numpy(x)).abs().max()) <= \
        float(np.abs(x).max()) / 253


@pytest.mark.parametrize("workers", [2, 3, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mean_over_workers_bitwise_vs_jax(workers, dtype):
    """The sync mean is the reference's compiled ``jnp.mean``: an fp32 sum
    over the workers in order, times f32(1/R), cast back; at R = 3 and 6
    a plain ``Tensor.mean`` differs on about a third of the elements."""
    from repro.launch.steps import _mean_over_workers
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    x = np.random.default_rng(workers).standard_normal(
        (workers, 3, 40_000)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(jax.jit(_mean_over_workers)(xj))
    t = convert.to_torch(np.asarray(xj))
    got = mean_over_workers({"w": t})["w"]
    assert got is t                          # written in place
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    np.testing.assert_array_equal(convert.to_numpy(got).view(bits),
                                  want.view(bits))
