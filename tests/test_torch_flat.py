"""The port's flat parameter plane against the JAX package, and inside the
port against the per-leaf layout.

Against the JAX package (its Pallas kernels in interpret mode, its jitted
oracles, its ``core/flatspace.py``):
  * FlatSpace geometry — slots, offsets, plane size, padding, dtype
    buckets, the round16 sidecars — for reduced and full-width Big LSTM
    (from shapes alone) and a mixed-dtype tree, at 1, 2 and 4 shards:
    exactly;
  * ``pack`` of the reference's initial parameters, its packed optimizer
    state carried across by ``repro_torch.convert``, ``adapt_flat_state``,
    ``mean_planes``: bitwise;
  * the flat update's plain version: y to rtol 1e-6 (fp32 rows) / 8e-3
    (bf16 rows), atol 1e-6, the reference's kernel tolerances
    (``tests/test_kernels.py``); b2_local bitwise against the port's plain
    versions and to 1 ulp of the compiled reference, whose CPU compile
    contracts ``b2_local + g·g`` into an FMA;
  * the flat EF encode's plain version: wire and residual bitwise.

Inside the port: with the same weights and batches the flat and the
per-leaf train steps leave bitwise equal state (params, both B², both
residuals, the gradient anchor) after a local, a sync and a local step,
for every wire codec, with and without the kernels' wrappers, one-pass and
three-pass.

The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against these same plain versions.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import OptimizerConfig as JOptimizerConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs import reduced as jax_reduced
from repro.configs.base import SyncConfig as JSyncConfig
from repro.core import flatspace as jfsp
from repro.core import optimizers as jopt
from repro.kernels.adaalter_update import flat_fused_update as jax_flat_update
from repro.kernels.ref import flat_ef_blocks_ref as jax_flat_ef_ref
from repro.kernels.ref import flat_fused_update_ref as jax_flat_update_ref
from repro.kernels.sync_fused import flat_ef_blocks as jax_flat_ef_blocks
from repro.kernels.sync_fused import flat_ef_plane as jax_flat_ef_plane
from repro.models import build_model
from repro_torch import charges, convert
from repro_torch.configs import (OptimizerConfig, ShapeConfig, SyncConfig,
                                 get_arch, reduced)
from repro_torch.core import flatspace as fsp
from repro_torch.data import SyntheticLM, make_train_batch
from repro_torch.kernels import _build, adaalter_update, ref, sync_fused
from repro_torch.launch.steps import build_train_programs
from repro_torch.models.lstm import init_lstm
from repro_torch.tree import leaves, tree_map

R = 2


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def _bits(x) -> np.ndarray:
    a = convert.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------- #
# geometry
# --------------------------------------------------------------------------- #
def _mixed_trees():
    """A tree of bf16 and fp32 leaves in interleaved order, (JAX abstract,
    port meta), R workers stacked."""
    spec = {"a": ((300,), "bfloat16"), "b": ((70_000,), "float32"),
            "c": [((5, 3), "bfloat16"), ((), "float32")],
            "d": ((2, 256, 129), "bfloat16")}

    def jax_leaf(s):
        return jax.ShapeDtypeStruct((R,) + s[0], jnp.dtype(s[1]))

    def port_leaf(s):
        return torch.empty((R,) + s[0], dtype=getattr(torch, s[1]),
                           device="meta")

    is_leaf = lambda s: isinstance(s, tuple) and isinstance(s[1], str)  # noqa
    return (jax.tree_util.tree_map(jax_leaf, spec, is_leaf=is_leaf),
            {"a": port_leaf(spec["a"]), "b": port_leaf(spec["b"]),
             "c": [port_leaf(s) for s in spec["c"]], "d": port_leaf(spec["d"])})


def _lstm_trees(full: bool):
    jcfg = jax_get_arch("biglstm")
    tcfg = get_arch("biglstm")
    if not full:
        jcfg, tcfg = jax_reduced(jcfg), reduced(tcfg)
    abstract = jax.eval_shape(build_model(jcfg).init, jax.random.PRNGKey(0))
    jtree = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct((R,) + x.shape, x.dtype), abstract)
    ttree = tree_map(lambda x: x[None].expand((R,) + x.shape),
                     init_lstm(None, tcfg, getattr(torch, tcfg.param_dtype),
                               "meta"))
    return jtree, ttree


@pytest.mark.parametrize("which", ["reduced", "full", "mixed"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_flatspace_geometry_matches_jax(which, shards):
    jtree, ttree = (_mixed_trees() if which == "mixed"
                    else _lstm_trees(which == "full"))
    jfs = jfsp.FlatSpace.build(jtree, batch_ndim=1, shards=shards)
    tfs = fsp.FlatSpace.build(ttree, batch_ndim=1, shards=shards)
    assert [(s.index, s.shape, jnp.dtype(s.dtype).name, s.size, s.offset,
             s.padded) for s in jfs.slots] == \
        [(s.index, s.shape, fsp.dtype_name(s.dtype), s.size, s.offset,
          s.padded) for s in tfs.slots]
    for attr in ("batch_shape", "plane_size", "shard_size", "n_leaves",
                 "n_real", "pad_elems"):
        assert getattr(tfs, attr) == getattr(jfs, attr), attr
    assert tfs.bucket_ranges() == jfs.bucket_ranges()
    if which == "full":
        assert tfs.n_real == 832_198_527 and tfs.n_leaves == 11
        if shards == 1:
            assert tfs.plane_size == 832_372_736
        return                      # the per-element masks are 832 MB here
    elems = jfs.round16_elems()
    np.testing.assert_array_equal(tfs.round16_elems(), elems)
    for row in (128, 256):
        want = jfsp.FlatSpace.rows_sidecar(elems, row)
        np.testing.assert_array_equal(tfs.rows_sidecar(elems, row), want)
        np.testing.assert_array_equal(tfs.round16_rows(row), want)


def test_flatspace_refuses_what_the_reference_refuses():
    _, ttree = _mixed_trees()
    with pytest.raises(ValueError, match="eps > 0"):
        fsp.FlatSpace.build(ttree, batch_ndim=1, eps=0.0)
    with pytest.raises(ValueError, match="shards"):
        fsp.FlatSpace.build(ttree, batch_ndim=1, shards=0)
    with pytest.raises(ValueError, match="non-float"):
        fsp.FlatSpace.build({"i": torch.zeros(2, 3, dtype=torch.int32)},
                            batch_ndim=1)
    with pytest.raises(ValueError, match="batch axes"):
        fsp.FlatSpace.build({"a": torch.zeros(2, 3), "b": torch.zeros(3, 3)},
                            batch_ndim=1)


# --------------------------------------------------------------------------- #
# pack, the optimizer state, convert, adapt, mean
# --------------------------------------------------------------------------- #
def _jax_flat_state(compression: str):
    """The reference's initial flat train state for reduced Big LSTM, its
    worker rows made to differ, as NumPy: (base params, plane, state)."""
    jcfg = jax_reduced(jax_get_arch("biglstm"))
    params0 = jax.jit(build_model(jcfg).init)(jax.random.PRNGKey(0))
    noise = jax.random.normal(jax.random.PRNGKey(1), (R,))
    stacked = jax.tree_util.tree_map(
        lambda x: (x[None] * (1 + 0.01 * noise.reshape((R,) + (1,) * x.ndim))
                   ).astype(x.dtype), params0)
    opt = jopt.make_optimizer(JOptimizerConfig.from_sync(
        JSyncConfig(compression=compression), name="local_adaalter", H=4))
    state = jax.vmap(opt.init)(stacked)
    jfs = jfsp.FlatSpace.build(stacked, batch_ndim=1)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return (to_np(params0), to_np(stacked), to_np(jfs.pack(stacked)),
            to_np(jfsp.pack_opt_state(jfs, state)))


def test_pack_of_jax_params_is_the_jax_plane():
    _, stacked, plane, _ = _jax_flat_state("int8")
    _, ttree = _lstm_trees(False)
    tfs = fsp.FlatSpace.build(ttree, batch_ndim=1)
    got = tfs.pack(convert.to_torch(stacked))
    np.testing.assert_array_equal(_bits(got), _bits(plane))
    # unpack restores each leaf's dtype and bits
    back = tfs.unpack(got)
    for a, b in zip(leaves(back), leaves(convert.to_torch(stacked))):
        assert a.dtype == b.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("compression", ["", "int8"])
def test_jax_flat_state_crosses_unchanged(compression):
    """convert carries the reference's flat train state as it is (fp32
    planes, integer counters), and it equals the port's own flat init from
    the same weights; back across, it is the reference's arrays again."""
    base, _, plane, state = _jax_flat_state(compression)
    got_plane, got_state = convert.to_torch((plane, state))
    oc = OptimizerConfig.from_sync(SyncConfig(compression=compression),
                                   name="local_adaalter", H=4, flat=True)
    programs = build_train_programs(reduced(get_arch("biglstm")), oc,
                                    n_workers=R, device="cpu")
    p_plane, p_state = programs.init_fn(0, convert.to_torch(base))
    assert sorted(got_state) == sorted(p_state)
    for k in got_state:
        assert got_state[k].dtype == p_state[k].dtype, k
        if k in fsp.SCALAR_STATE_KEYS:
            assert torch.equal(got_state[k], p_state[k])
        else:
            np.testing.assert_array_equal(_bits(got_state[k]),
                                          _bits(p_state[k]), err_msg=k)
    # the reference's rows differ; the port's init copies one worker's
    np.testing.assert_array_equal(_bits(got_plane[:1]), _bits(plane[:1]))
    back_plane, back_state = convert.to_numpy((got_plane, got_state))
    np.testing.assert_array_equal(back_plane.view(np.uint32),
                                  plane.view(np.uint32))
    for k, v in state.items():
        np.testing.assert_array_equal(back_state[k], v)


def test_flat_init_is_the_packed_per_leaf_init():
    """The flat init builds the planes directly; they equal the packed
    per-leaf state, padding zero in every plane (b2 included)."""
    cfg = reduced(get_arch("biglstm"))
    kw = dict(name="local_adaalter", H=4, compression="int8")
    leaf = build_train_programs(cfg, OptimizerConfig(**kw), n_workers=R,
                                device="cpu")
    flat = build_train_programs(cfg, OptimizerConfig(**kw, flat=True),
                                n_workers=R, device="cpu")
    params, state = leaf.init_fn(3)
    plane, fstate = flat.init_fn(3)
    want_plane, want_state = leaf.to_flat(params, state)
    np.testing.assert_array_equal(_bits(plane), _bits(want_plane))
    pad = torch.ones(flat.flatspace.plane_size, dtype=torch.bool)
    for s in flat.flatspace.slots:
        pad[s.offset:s.offset + s.size] = False
    assert pad.any()
    for k, v in fstate.items():
        if k not in fsp.SCALAR_STATE_KEYS:
            np.testing.assert_array_equal(_bits(v), _bits(want_state[k]))
            assert not v[:, pad].any(), k
    p2, s2 = flat.to_legacy(plane, fstate)
    for a, b in zip(leaves(p2), leaves(params)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _adapt_cases():
    rng = np.random.default_rng(0)
    P = 4 * 128
    plane = rng.standard_normal((2, P)).astype(np.float32)
    same = np.repeat(plane[:1], 4, axis=0)
    state2 = {"step": np.array([5, 5], np.int32), "b2_sync": plane + 1}
    state4 = {"step": np.array([5, 5, 5, 5], np.int32),
              "b2_sync": np.abs(np.concatenate([plane, plane[::-1]]))}
    padded = np.pad(plane, [(0, 0), (0, 128)])
    return [
        (plane, state2, 2, P),                    # unchanged
        (plane, state2, 4, P),                    # grow: replicate rows
        (same, dict(state4, b2_sync=same), 2, P),  # shrink, identical rows
        (np.concatenate([plane, plane[::-1]]), state4, 2, P),  # diverged
        (plane, state2, 2, P + 256),              # pad the tail
        (padded, dict(state2, b2_sync=padded), 2, P),  # truncate zero tail
    ]


@pytest.mark.parametrize("case", range(6))
def test_adapt_flat_state_matches_jax(case):
    plane, state, workers, size = _adapt_cases()[case]
    want = jfsp.adapt_flat_state(plane, state, workers=workers,
                                 plane_size=size)
    got = fsp.adapt_flat_state(plane, state, workers=workers,
                               plane_size=size)
    np.testing.assert_array_equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert got[1][k].dtype == want[1][k].dtype
        np.testing.assert_array_equal(got[1][k], want[1][k])


def test_adapt_flat_state_refuses_what_the_reference_refuses():
    plane = np.ones((2, 512), np.float32)
    for kw in (dict(workers=3, plane_size=512),       # 2 -> 3 workers
               dict(workers=2, plane_size=256)):      # non-zero tail
        for mod in (jfsp, fsp):
            with pytest.raises(ValueError):
                mod.adapt_flat_state(plane, {}, **kw)
    assert fsp.is_flat_checkpoint(["#0", "#1/b2_sync"])
    assert not fsp.is_flat_checkpoint(["#0/embed", "#1/step"])


@pytest.mark.parametrize("workers", [2, 3])
def test_mean_planes_bitwise_vs_jax(workers):
    jtree, ttree = _mixed_trees()
    ttree = tree_map(lambda x: torch.empty(
        (workers,) + tuple(x.shape[1:]), dtype=x.dtype, device="meta"), ttree)
    tfs = fsp.FlatSpace.build(ttree, batch_ndim=1)
    rng = np.random.default_rng(workers)
    plane = rng.standard_normal((workers, tfs.plane_size)).astype(np.float32)
    elems = tfs.round16_elems()
    plane[:, elems] = np.asarray(jnp.asarray(plane[:, elems]).astype(
        jnp.bfloat16).astype(jnp.float32))      # 16-bit slots hold bf16
    want = jax.jit(lambda a: jfsp.mean_planes(a, elems))(jnp.asarray(plane))
    got = torch.from_numpy(plane.copy())
    assert fsp.mean_planes(got, tfs.round16_ranges()) is got
    np.testing.assert_array_equal(_bits(got), _bits(want))


# --------------------------------------------------------------------------- #
# the flat kernels' plain versions
# --------------------------------------------------------------------------- #
P_PLANE = 2 * 65536


def _rnd_rows(row: int) -> np.ndarray:
    """One plane row's sidecar: the first 3/4 of the plane bf16, the rest
    fp32 (as two dtype buckets would lie)."""
    side = np.zeros((P_PLANE // row, 1), np.float32)
    side[: 3 * P_PLANE // 4 // row] = 1.0
    return side


def _update_inputs(seed):
    rng = np.random.default_rng(seed)
    shape = (R, P_PLANE)
    x = rng.standard_normal(shape).astype(np.float32)
    x[:, : 3 * P_PLANE // 4] = np.asarray(jnp.asarray(
        x[:, : 3 * P_PLANE // 4]).astype(jnp.bfloat16).astype(jnp.float32))
    g = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    bs = rng.uniform(1.0, 5.0, shape).astype(np.float32)
    bl = (bs + rng.uniform(0.0, 2.0, shape)).astype(np.float32)
    return x, g, bs, bl


def _assert_y_close(got, want, rnd_elems):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    for mask, rtol in ((rnd_elems, 8e-3), (~rnd_elems, 1e-6)):
        np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=rtol,
                                   atol=1e-6)


@pytest.mark.parametrize("one_row", [True, False])
def test_flat_update_plain_matches_jax_kernel_and_oracles(one_row):
    x, g, bs, bl = _update_inputs(_seed("flat_update", one_row))
    eta, extra = 0.37, 3.0
    rows = _rnd_rows(128)
    rnd_elems = np.repeat(rows[:, 0] > 0, 128)
    side = rows if one_row else np.tile(rows, (R, 1))
    t = [torch.from_numpy(a.copy()) for a in (x, g, bs, bl)]
    y, b2 = adaalter_update.flat_fused_update(
        *t, adaalter_update.update_scalars(eta, extra, "cpu"),
        torch.from_numpy(side))
    j = [jnp.asarray(a) for a in (x, g, bs, bl)]
    yk, b2k = jax_flat_update(*j, eta, extra, jnp.asarray(np.tile(rows, (R, 1))),
                              interpret=True)
    _assert_y_close(y, yk, rnd_elems)
    # bf16 rows hold bf16 values: the kernel rounds y through bf16 there
    assert (_bits(y)[:, rnd_elems] & 0xFFFF == 0).all()
    # b2_local: bitwise with the port's plain versions, 1 ulp of compiled JAX
    np.testing.assert_array_equal(_bits(b2), _bits(t[3] + t[1] * t[1]))
    for want in (b2k, jax.jit(jax_flat_update_ref)(
            *j, eta, extra, jnp.asarray(rnd_elems))[1]):
        np.testing.assert_array_max_ulp(b2.numpy(), np.asarray(want),
                                        maxulp=1)
    # the non-kernel flat update mirrors its own per-leaf path (bf16 slots:
    # bf16(x) − bf16(upd)), against the reference's
    yr, b2r = ref.flat_fused_update_ref(*t, eta, extra,
                                        torch.from_numpy(rnd_elems))
    yjr, _ = jax.jit(jax_flat_update_ref)(*j, eta, extra,
                                          jnp.asarray(rnd_elems))
    _assert_y_close(yr, yjr, rnd_elems)
    np.testing.assert_array_equal(_bits(b2r), _bits(b2))


def test_flat_update_writes_in_place_when_asked():
    x, g, bs, bl = (torch.from_numpy(a) for a in _update_inputs(1))
    sc = adaalter_update.update_scalars(0.5, 2.0, "cpu")
    rows = torch.from_numpy(_rnd_rows(128))
    y_new, b2_new = adaalter_update.flat_fused_update(x, g, bs, bl, sc, rows)
    y, b2 = adaalter_update.flat_fused_update(x, g, bs, bl, sc, rows, y=x,
                                              b2_out=bl)
    assert y is x and b2 is bl
    assert torch.equal(x, y_new) and torch.equal(bl, b2_new)


def _ef_inputs(seed):
    """(R·P/256, 256) fp32 payload and residual with the params half's
    sidecars (bf16 wire rounding on 3/4 of the blocks, clamp at f32 min)
    on the first half of each row and the B² half's (no rounding, clamp
    at 0) on the second; zero blocks and a clamped stripe included."""
    rng = np.random.default_rng(seed)
    nb_row = P_PLANE // 256
    x = (rng.standard_normal((R, P_PLANE)) * 0.5).astype(np.float32)
    x[:, P_PLANE // 2:] = np.abs(x[:, P_PLANE // 2:]) + 1.0
    e = (rng.standard_normal((R, P_PLANE)) * 1e-2).astype(np.float32)
    e[:, P_PLANE // 2:P_PLANE // 2 + 300] = -5.0
    x[:, 1024:1024 + 512] = 0.0
    e[:, 1024:1024 + 512] = 0.0
    rnd = np.zeros((nb_row, 1), np.float32)
    rnd[: 3 * nb_row // 8] = 1.0
    low = np.zeros((nb_row, 1), np.float32)
    low[: nb_row // 2] = np.finfo(np.float32).min
    return x.reshape(-1, 256), e.reshape(-1, 256), rnd, low


def test_flat_ef_plain_bitwise_vs_jax_kernel_and_oracles():
    x2d, e2d, rnd, low = _ef_inputs(0)
    e_port = torch.from_numpy(e2d.copy())
    w, r = sync_fused.flat_ef_blocks(torch.from_numpy(x2d), e_port,
                                     torch.from_numpy(rnd),
                                     torch.from_numpy(low))
    assert r is e_port                       # the residual is written in place
    tiled = [jnp.asarray(np.tile(a, (R, 1))) for a in (rnd, low)]
    wk, rk = jax_flat_ef_blocks(jnp.asarray(x2d), jnp.asarray(e2d), *tiled,
                                interpret=True)
    wr, rr = jax.jit(jax_flat_ef_ref)(jnp.asarray(x2d), jnp.asarray(e2d),
                                      *tiled)
    for want_w, want_r in ((wk, rk), (wr, rr)):
        np.testing.assert_array_equal(_bits(w), _bits(want_w))
        np.testing.assert_array_equal(_bits(r), _bits(want_r))
    assert not w[4:6].any() and not r[4:6].any()          # the zero blocks


@pytest.mark.parametrize("fused,use_kernels", [(True, True), (True, False),
                                               (False, True), (False, False)])
def test_flat_ef_plane_every_route_bitwise(fused, use_kernels):
    """flat_ef_plane one-pass and three-pass, with the kernels' wrappers
    and without, against the reference's three-pass composition."""
    x2d, e2d, rnd, low = _ef_inputs(1)
    plane, res = x2d.reshape(R, P_PLANE), e2d.reshape(R, P_PLANE)
    res_t = torch.from_numpy(res.copy())
    w, r = sync_fused.flat_ef_plane(
        torch.from_numpy(plane), res_t, torch.from_numpy(rnd),
        torch.from_numpy(low), use_kernels=use_kernels, fused=fused)
    assert r is res_t and w.shape == (R, P_PLANE)
    want_w, want_r = jax.jit(lambda a, b: jax_flat_ef_plane(
        a, b, rnd, low, use_pallas=False, fused=False))(
        jnp.asarray(plane), jnp.asarray(res))
    np.testing.assert_array_equal(_bits(w), _bits(want_w))
    np.testing.assert_array_equal(_bits(r), _bits(want_r))


def test_flat_wrappers_take_plain_versions_and_count_no_launch(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(_build, "load", no_build)
    before = (adaalter_update.flat_launches.n, sync_fused.flat_launches.n)
    x, g, bs, bl = (torch.from_numpy(a) for a in _update_inputs(2))
    adaalter_update.flat_fused_update(
        x, g, bs, bl, adaalter_update.update_scalars(0.1, 1.0, "cpu"),
        torch.from_numpy(_rnd_rows(128)))
    x2d, e2d, rnd, low = (torch.from_numpy(a) for a in _ef_inputs(2))
    sync_fused.flat_ef_blocks(x2d, e2d, rnd, low)
    assert (adaalter_update.flat_launches.n,
            sync_fused.flat_launches.n) == before


def test_flat_wrappers_raise_rather_than_fall_back(monkeypatch):
    """Off the CPU the flat wrappers never take their plain versions: on
    ``meta`` tensors (the dry-run's route) they return empty ``meta``
    outputs and launch nothing; another device and bad operands raise."""
    def no_plain(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(adaalter_update, "flat_fused_update_plain", no_plain)
    monkeypatch.setattr(sync_fused, "flat_ef_blocks_plain", no_plain)
    m = torch.empty(2, 256, device="meta")
    side = torch.empty(2, 1, device="meta")
    sc = torch.empty(2, device="meta")
    before = (adaalter_update.flat_launches.n, sync_fused.flat_launches.n)
    y, b2 = adaalter_update.flat_fused_update(m, m, m, m, sc, side)
    w, e = sync_fused.flat_ef_blocks(m, m, side, side)
    assert {t.device.type for t in (y, b2, w, e)} == {"meta"} and e is m
    assert (adaalter_update.flat_launches.n,
            sync_fused.flat_launches.n) == before
    # a device a wrapper does not take raises (meta, once it is not one)
    monkeypatch.setattr(charges, "DEVICES", ("cpu", "cuda"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        adaalter_update.flat_fused_update(m, m, m, m, sc, side)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sync_fused.flat_ef_blocks(m, m, side, side)
    ones = torch.ones(2, 256)
    with pytest.raises(ValueError, match="rnd_rows"):
        adaalter_update.flat_fused_update(ones, ones, ones, ones,
                                          torch.ones(2), torch.ones(3, 1))
    with pytest.raises(TypeError):
        adaalter_update.flat_fused_update(ones.bfloat16(), ones, ones, ones,
                                          torch.ones(2), torch.ones(2, 1))
    with pytest.raises(ValueError, match="tile"):
        sync_fused.flat_ef_blocks(ones, ones, torch.ones(3, 1),
                                  torch.ones(3, 1))


# --------------------------------------------------------------------------- #
# the flat train steps == the per-leaf ones, inside the port
# --------------------------------------------------------------------------- #
CFG = reduced(get_arch("biglstm"), vocab=128)
SHAPE = ShapeConfig(name="t", seq_len=16, global_batch=4, kind="train")

FLAT_CASES = {
    # name: (SyncConfig kwargs, use_kernels, other OptimizerConfig kwargs)
    "fp32_plain": (dict(), False, {}),
    "int8_plain": (dict(compression="int8"), False, {}),
    "int8_kernels": (dict(compression="int8"), True, {}),
    "bf16_plain": (dict(compression="bf16"), False, {}),
    "int8_unfused_kernels": (dict(compression="int8", fused=False), True, {}),
    "int8_kernels_clip": (dict(compression="int8"), True,
                          dict(grad_clip=0.05)),
    "int8_kernels_update_norm": (dict(compression="int8", policy="adaptive",
                                      threshold=1.0), True, {}),
    "int8_kernels_staleness": (dict(compression="int8", policy="adaptive",
                                    threshold=1.0,
                                    drift_metric="grad_staleness"), True, {}),
}


def _opt(flat, sync_kw, use_kernels, extra):
    return OptimizerConfig.from_sync(
        SyncConfig(**sync_kw), name="local_adaalter", lr=0.5, H=2,
        warmup_steps=3, use_kernels=use_kernels, flat=flat, **extra)


@pytest.mark.parametrize("name", list(FLAT_CASES))
def test_flat_step_bitwise_matches_per_leaf(name):
    sync_kw, use_kernels, extra = FLAT_CASES[name]
    pL = build_train_programs(CFG, _opt(False, sync_kw, use_kernels, extra),
                              n_workers=R, device="cpu")
    pF = build_train_programs(CFG, _opt(True, sync_kw, use_kernels, extra),
                              n_workers=R, device="cpu")
    assert pF.is_flat and not pL.is_flat
    assert pF.n_payload_leaves == pL.n_payload_leaves == 11
    fs = pF.flatspace
    paramsL, stateL = pL.init_fn(0)
    planeF, stateF = pF.init_fn(0)
    ds = SyntheticLM(vocab_size=CFG.vocab_size, seq_len=SHAPE.seq_len,
                     n_workers=R, seed=0, non_iid=True)
    keys = [k for k in ("b2_sync", "b2_local", "res_params", "res_b2",
                        "g_anchor") if k in stateL]
    assert sorted(stateF) == sorted(stateL)
    for step in range(3):                        # local, sync, post-sync
        batch = {k: torch.from_numpy(v) for k, v in
                 make_train_batch(CFG, SHAPE, ds, step, n_workers=R).items()}
        kind = "sync_step" if step == 1 else "local_step"
        paramsL, stateL, mL = getattr(pL, kind)(paramsL, stateL, batch)
        planeF, stateF, mF = getattr(pF, kind)(planeF, stateF, batch)
        for a, b in zip(leaves(paramsL), leaves(fs.unpack(planeF))):
            np.testing.assert_array_equal(_bits(a), _bits(b),
                                          err_msg=f"params@{step}")
        for key in keys:
            for a, b in zip(leaves(stateL[key]),
                            leaves(fs.unpack(stateF[key],
                                             dtype=torch.float32))):
                np.testing.assert_array_equal(_bits(a), _bits(b),
                                              err_msg=f"{key}@{step}")
        for key in fsp.SCALAR_STATE_KEYS:
            assert torch.equal(stateL[key], stateF[key])
        # derived scalars are summed in another order: close, not bitwise
        np.testing.assert_allclose(float(mF["loss"]), float(mL["loss"]),
                                   rtol=1e-6)
        if "drift" in mL:
            np.testing.assert_allclose(float(mF["drift"]),
                                       float(mL["drift"]), rtol=1e-4)
    # the local step after the sync wrote b2_local beside b2_sync, not over
    assert stateF["b2_local"].data_ptr() != stateF["b2_sync"].data_ptr()


def test_flat_requires_local_adaalter():
    for name in ("local_sgd", "adagrad"):
        with pytest.raises(ValueError, match="flat"):
            build_train_programs(CFG, OptimizerConfig(name=name, flat=True),
                                 n_workers=R, device="cpu")


def test_flat_requires_positive_eps():
    with pytest.raises(ValueError, match="eps"):
        OptimizerConfig(name="local_adaalter", eps=0.0, flat=True)
    with pytest.raises(ValueError, match="eps"):
        dataclasses.replace(OptimizerConfig(flat=True), eps=-1.0)
    assert OptimizerConfig(eps=0.0).eps == 0.0       # per-leaf runs take it
