"""The port's evaluation slice against the JAX package on the CPU: the fused
multi-scale grouping (its preparation, plain version and layer route), the
metrics, the camera undistortion, the Ev2Hands-S and Ev2Hands-R readers, the
real-data ERPC transform, the collision score and the whole Ev2Hands-S
evaluation, at small sizes (B <= 2, N = 256)."""

import collections
import dataclasses
import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu import evaluate as jev
from ev2hands_tpu import metrics as jm
from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.events import real_streams as jrs
from ev2hands_tpu.events import streams as js
from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
from ev2hands_tpu.model import layers as jl
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu.ops import collision as jc
from ev2hands_tpu.ops import pallas_grouping as jpg
from ev2hands_tpu.train import build_collision_context as j_collision_context
from ev2hands_tpu_torch import evaluate as tev
from ev2hands_tpu_torch import metrics as tm
from ev2hands_tpu_torch import train as ttrain
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.camera import undistort_points
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events import erpc as te
from ev2hands_tpu_torch.events import real_streams as trs
from ev2hands_tpu_torch.events import streams as ts
from ev2hands_tpu_torch.mano.layer import mano_forward
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model.tehnet import TEHNet
from ev2hands_tpu_torch.ops import collision as tc
from ev2hands_tpu_torch.ops import grouping as tg
from test_torch_erpc_mano import assert_erpc_equal
from test_torch_model import _cloud, load_sub, numpy_variables


def _t(a):
    return torch.from_numpy(np.array(a))


# --- fused multi-scale grouping -------------------------------------------

def _scale_params(rng, d_in, widths):
    """One scale's conv and BatchNorm parameters as numpy."""
    conv, bn, last = [], [], d_in
    for c in widths:
        conv.append({"kernel": (rng.randn(last, c) * 0.2).astype(np.float32),
                     "bias": (rng.randn(c) * 0.1).astype(np.float32)})
        bn.append({"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32),
                   "mean": (0.1 * rng.randn(c)).astype(np.float32),
                   "var": (np.abs(rng.randn(c)) + 0.5).astype(np.float32)})
        last = c
    return conv, bn


@pytest.fixture(scope="module")
def fused_case():
    """The JAX fused-scales test's inputs (B=2, S=16, N=256, nb=32, nested
    radii, an empty ball at centroid 3), prepared by the JAX package."""
    rng = np.random.RandomState(7)
    B, S, N, nb = 2, 16, 256, 32
    xyz = jnp.asarray(np.clip(rng.randn(B, N, 3) * 0.4, -1, 1), jnp.float32)
    feats = jnp.asarray(rng.randn(B, N, 5), jnp.float32)
    new_xyz = xyz[:, :S].at[:, 3, :].set(jnp.asarray([7.0, 7.0, 7.0]))
    widths = ((8, 8, 16), (16, 16, 32), (16, 24, 32))
    params = [_scale_params(rng, 8, w) for w in widths]

    sections = []

    @jax.jit
    def prepare(xyz, feats, new_xyz, params):
        perm = jpg.morton_perm(xyz)
        xyz_p = jnp.take_along_axis(xyz, perm[..., None], axis=1)
        feats_p = jnp.take_along_axis(feats, perm[..., None], axis=1)
        folded, sels = [], []
        for r, k, (conv, bn) in zip((0.15, 0.3, 0.6), (4, 8, 16), params):
            folded.append(jpg.fold_scale_params(feats_p, xyz_p, new_xyz, conv, bn))
            sels.append(jpg.permute_columns(
                jpg.dense_selection_mask(xyz, new_xyz, r, k), perm))
        act = jnp.stack([jpg.tile_activity(s, nb) for s in sels], axis=1).max(axis=1)
        stacked, sec = jpg.stack_folded_scales(folded)
        sections.append(sec)   # Python ints, known while tracing
        return folded, stacked, jnp.stack(sels, axis=1), act

    folded, stacked, sel_all, act = prepare(xyz, feats, new_xyz, params)
    return dict(folded=folded, stacked=stacked, sections=sections[0], sel_all=sel_all,
                act=act, nb=nb, widths=widths)


def _port_folded(f):
    return tg.FoldedScale(*(_t(a) for a in f))


def test_stack_folded_scales_matches_jax(fused_case):
    ref, ref_sections = fused_case["stacked"], fused_case["sections"]
    got, sections, blocks = tg.stack_folded_scales(
        [_port_folded(f) for f in fused_case["folded"]])
    assert sections == ref_sections == (16, 32, 32)
    assert blocks == tuple(w[:2] for w in fused_case["widths"])
    for name, a, b in zip(tg.FoldedScale._fields, got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_msg_fused_scales_plain_matches_interpret(fused_case):
    """The plain version against the TPU kernel in interpret mode (atol
    2e-5, the JAX package's own test's), and against the port's per-scale
    plain version on each section."""
    stacked, sections = fused_case["stacked"], fused_case["sections"]
    nb = fused_case["nb"]
    assert float(jnp.mean(fused_case["act"].astype(jnp.float32))) < 0.95
    ref = jpg.dense_msg_fused_scales_pallas_sparse(
        stacked, fused_case["sel_all"], fused_case["act"], sections, sb=8,
        nb=nb, interpret=True)
    sel_all, act = _t(fused_case["sel_all"]), _t(fused_case["act"])
    got = tg.msg_fused_scales_sparse_plain(
        _port_folded(stacked), sel_all, act, sections, nb, chunk=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    per_scale = torch.cat([
        tg.msg_scale_sparse_plain(_port_folded(f), sel_all[:, r],
                                  tg.tile_activity(sel_all[:, r], nb), nb)
        for r, f in enumerate(fused_case["folded"])], dim=-1)
    np.testing.assert_allclose(got.numpy(), per_scale.numpy(), atol=2e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    _, _, blocks = tg.stack_folded_scales(
        [_port_folded(f) for f in fused_case["folded"]])
    torch.testing.assert_close(
        tg.msg_fused_scales_sparse(_port_folded(stacked), sel_all, act, sections,
                                   nb, blocks),
        tg.msg_fused_scales_sparse_plain(_port_folded(stacked), sel_all, act,
                                         sections, nb), rtol=0, atol=0)


SA1_STYLE = dict(npoint=32, radius_list=(0.2, 0.3, 0.5), nsample_list=(8, 12, 16),
                 mlps=((8, 8, 16), (8, 12, 16), (12, 12, 24)))


def test_set_abstraction_msg_fused_route_matches_jax(monkeypatch):
    """The fused route (all three scales through one fused call, gate forced
    open at this size, 64-point tiles) against JAX's eval
    ``SetAbstractionMsg``, which takes its XLA dense route on the CPU. rtol
    and atol 1e-5: f32 matrix products summed in another order."""
    rng = np.random.RandomState(13)
    B, N, D = 2, 256, 5
    xyz, pts = _cloud(rng, B, N), rng.randn(B, N, D).astype(np.float32)
    jmod = jl.SetAbstractionMsg(**SA1_STYLE)
    variables = numpy_variables(jmod, rng, xyz, pts)
    ref_xyz, ref = jax.jit(lambda v, a, b: jmod.apply(v, a, b, False))(
        variables, xyz, pts)
    port = load_sub(tl.SetAbstractionMsg(
        SA1_STYLE["npoint"], SA1_STYLE["radius_list"], SA1_STYLE["nsample_list"], D,
        SA1_STYLE["mlps"], pallas_nb=64, pallas_fused=True, device="cpu"),
        variables, "sa1")
    monkeypatch.setattr(tl, "SPARSE_MIN_PAIRS", 0)
    calls = {"fused": 0, "per_scale": 0}

    def counted(name, fn):
        def wrapper(*a):
            calls[name] += 1
            return fn(*a)
        return wrapper

    monkeypatch.setattr(tl, "msg_fused_scales_sparse",
                        counted("fused", tl.msg_fused_scales_sparse))
    monkeypatch.setattr(tl, "msg_scale_sparse",
                        counted("per_scale", tl.msg_scale_sparse))
    with torch.no_grad():
        got_xyz, got = port(_t(xyz), _t(pts))
    assert calls == {"fused": 1, "per_scale": 0}
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(ref_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- metrics, camera, collision -------------------------------------------

def test_metrics_match_jax():
    """Every metric and the accumulator over two batches, rtol 1e-6."""
    rng = np.random.RandomState(3)
    batches = [((rng.randn(5, 2, 21, 3) * 40).astype(np.float32),
                (rng.randn(5, 2, 21, 3) * 40).astype(np.float32)) for _ in range(2)]
    pred, gt = batches[0]
    for name in ("absolute_pck3d", "relative_pck3d", "right_root_relative_pck3d"):
        for kw in ({}, {"num_steps": 100, "dist_max_mm": 100.0}):
            np.testing.assert_allclose(
                getattr(tm, name)(_t(pred), _t(gt), **kw).numpy(),
                np.asarray(getattr(jm, name)(pred, gt, **kw)), rtol=1e-6, err_msg=name)
    np.testing.assert_allclose(tm.mpjpe(_t(pred), _t(gt)).numpy(),
                               np.asarray(jm.mpjpe(pred, gt)), rtol=1e-6)
    verts = [(rng.randn(5, 2, 40, 3) * 30).astype(np.float32) for _ in range(2)]
    np.testing.assert_allclose(tm.mpvpe(*map(_t, verts)).numpy(),
                               np.asarray(jm.mpvpe(*verts)), rtol=1e-6)
    acc, jacc = tm.PckAccumulator(), jm.PckAccumulator()
    for p, g in batches:
        acc.update(_t(p), _t(g))
        jacc.update(jnp.asarray(p), jnp.asarray(g))
    (got, score), (ref, ref_score) = acc.result(), jacc.result()
    assert acc.frames == jacc.frames == 10
    assert got["auc"] == ref["auc"] and score == ref_score
    for k in ref["pck3d"]:
        np.testing.assert_allclose(got["pck3d"][k], ref["pck3d"][k], rtol=1e-6)
        assert tm.get_auc(got["pck3d"][k]) == jm.get_auc(ref["pck3d"][k])


@pytest.mark.parametrize("dist", [[-0.3, 0.12, 0.001, -0.002, -0.02],
                                  [0.2, -0.1, 0.003, 0.001]])
def test_undistort_points_matches_cv2(dist):
    """Within 1e-3 px of cv2.undistortPoints plus the JAX package's
    reprojection, at every pixel of a 346 x 260 sensor."""
    W, H = 346, 260
    K = np.array([[320.0, 0, W / 2], [0, 318.0, H / 2 + 3], [0, 0, 1]])
    ys, xs = np.mgrid[0:H, 0:W]
    xy = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    dist = np.asarray(dist)
    ref = cv2.undistortPoints(xy.reshape(-1, 1, 2), K, dist).reshape(-1, 2)
    ref = (np.c_[ref, np.ones_like(ref[:, 0])] @ K.T)[:, :2]
    ref = np.clip(ref, 0, [W - 1, H - 1])
    got = undistort_points(xy, K, dist, W, H)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= 1e-3


@pytest.fixture(scope="module")
def hands_case():
    """Synthetic-MANO meshes of two hands posed into each other (B=2), in mm,
    and both packages' collision contexts."""
    rng = np.random.RandomState(5)
    hands = ttrain.build_hands(DEFAULT_CONFIG, synthetic=True, device="cpu")
    verts = []
    for side, dx in (("left", -0.01), ("right", 0.01)):
        go = (0.3 * rng.randn(2, 3)).astype(np.float32)
        tr = np.float32([[dx, 0, 0.4]] * 2)
        out = mano_forward(
            hands[side], _t(go), _t((0.5 * rng.randn(2, 6)).astype(np.float32)),
            _t((0.5 * rng.randn(2, 10)).astype(np.float32)), _t(tr))
        verts.append(out.vertices * 1000)
    j_hands = create_mano_hands(synthetic_mano_models(0))
    return dict(verts=verts, ctx=ttrain.build_collision_context(hands),
                j_ctx=j_collision_context(j_hands))


def test_collision_percentage_matches_jax(hands_case):
    """Equal, or within one triangle's share (100 / 3076): the confirmed
    pairs can differ where a box overlap rounds differently."""
    vl, vr = hands_case["verts"]
    ctx, j_ctx = hands_case["ctx"], hands_case["j_ctx"]
    got = tc.collision_percentage(vl, vr, ctx.faces, ctx.adjacency, max_pairs=256)
    ref = jc.collision_percentage(vl.numpy(), vr.numpy(), j_ctx.faces,
                                  j_ctx.adjacency, max_pairs=256)
    assert (np.asarray(ref) > 0).all()   # the hands do collide
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=100.0 / ctx.faces.shape[0] + 1e-4)


# --- readers and the real-data transform ----------------------------------

@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """A JAX-written Ev2Hands-S split and Ev2Hands-R recording (with a
    distortion vector set), both small."""
    d = tmp_path_factory.mktemp("eval_data")
    root = js.write_synthetic_ev2hands_s(str(d / "test"), n_events=9000, n_frames=6,
                                         seed=2)
    rec = jrs.write_synthetic_ev2hands_r(str(d / "rec.pickle"), n_events=30000,
                                         n_frames=12, seed=4)
    return dict(root=root, rec=rec)


def _assert_tree_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            _assert_tree_equal(got[k], ref[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=path)


@pytest.mark.parametrize("dataset", ["ev2hands_s", "ev2hands_r"])
def test_readers_match_jax(data_dir, dataset):
    """Windows and batches equal to the JAX package's readers on files the
    JAX package wrote; the in-memory S reader equals the file's."""
    if dataset == "ev2hands_s":
        root, n = data_dir["root"], 256
        ref, got = js.Ev2HandSReader(root, n), ts.Ev2HandSReader(root, n)
        rows, anno = ts.synthetic_ev2hands_s(n_events=9000, n_frames=6, seed=2)
        mem = ts.Ev2HandSReader.from_rows(rows, anno, n)
        np.testing.assert_array_equal(rows, ref.dataset[:])
        for i in (0, 3000, 8990):
            _assert_tree_equal(got.window(i), ref.window(i))
            _assert_tree_equal(mem.window(i), ref.window(i))
        assert got.n_windows(7) == ref.n_windows(7) == 1286
        for (a, na), (b, nb) in zip(got.sequential_batches(3, 7, max_batches=2),
                                    ref.sequential_batches(3, 7, max_batches=2)):
            assert na == nb
            _assert_tree_equal(a, b)
        tail = list(got.sequential_batches(5, stride=1000))
        ref_tail = list(ref.sequential_batches(5, stride=1000))
        assert [t[1] for t in tail] == [t[1] for t in ref_tail] == [5, 4]
        _assert_tree_equal(tail[-1][0], ref_tail[-1][0])
        for a, b in zip(got.batches(4, shuffle=False, max_batches=3),
                        ref.batches(4, shuffle=False, max_batches=3)):
            _assert_tree_equal(a, b)
    else:
        path = data_dir["rec"]
        ref, got = jrs.RealStream(path), trs.RealStream(path)
        # the port keeps undistorted pixels in float32, the windows' type
        np.testing.assert_array_equal(got.events[:, 2:], ref.events[:, 2:])
        np.testing.assert_array_equal(got.events[:, :2],
                                      ref.events[:, :2].astype(np.float32))
        windows = list(zip(got.sliding_windows(), ref.sliding_windows()))
        assert len(windows) > 100
        for a, b in windows[:20] + windows[-3:]:
            _assert_tree_equal(a, b)
        for a, b in zip(trs.sliding_window_batches(got, 8, max_windows=20),
                        jrs.sliding_window_batches(ref, 8, max_windows=20)):
            _assert_tree_equal(a, b)


@pytest.mark.parametrize("max_pixels", [None, 300])
def test_erpc_real_transform_matches_jax(data_dir, max_pixels):
    """Real windows (padded, ms timestamps) through both transforms with the
    JAX package's resample draws; ``max_pixels`` = 300 keeps fewer pixel
    rows than the windows occupy. The tolerances of
    ``test_rasterize_and_transform_match_jax``."""
    stream = trs.RealStream(data_dir["rec"])
    wins = [stream.window_at(s, min_events=600, capacity=1024) for s in (0, 5000)]
    events = np.stack([w["events"] for w in wins])
    valid = np.stack([w["event_valid"] for w in wins])
    assert not valid.all()
    n_out, key = 256, jax.random.PRNGKey(9)
    mp = max_pixels or min(1024, max(2 * n_out, 2048))

    @jax.jit
    def reference(events, valid, key):
        """JAX's transform, its pixel counts and its resample draws."""
        ref = je.erpc_real_batch_transform(events, valid, key, n_out=n_out,
                                           max_pixels=max_pixels)
        _, _, n_valid = jax.vmap(lambda e, v: je.rasterize_erpc(
            e, jnp.zeros(e.shape[0], jnp.int32), 346, 260, event_valid=v,
            time_scale=1.0, max_pixels=mp))(events, valid)
        draws = jax.vmap(lambda k, n: jax.random.randint(
            jax.random.split(k, 3)[2], (n_out,), 0, jnp.maximum(n, 1)))(
            jax.random.split(key, 2), n_valid)
        return ref, n_valid, draws

    ref, n_valid, draws = reference(events, valid, key)
    _, _, t_n_valid = te.rasterize_erpc(
        _t(events), torch.zeros(2, 1024, dtype=torch.int32), 346, 260,
        time_scale=1.0, event_valid=_t(valid), max_pixels=mp)
    np.testing.assert_array_equal(t_n_valid.numpy(), np.asarray(n_valid))
    if max_pixels:
        assert (t_n_valid.numpy() == max_pixels).all()
    got = te.erpc_real_batch_transform(_t(events), _t(valid), draws=_t(draws),
                                       n_out=n_out, max_pixels=max_pixels)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert_erpc_equal(got.events, ref.events, jitted=True)


def test_load_pth_state_dict(tmp_path):
    """A reference-style .pth (trainer blob, DataParallel prefixes, BatchNorm
    counters) loads into TEHNet with strict=True."""
    state = tw.init_weights(torch.Generator().manual_seed(1), ModelConfig(n_points=256))
    blob = {f"module.{k}": v for k, v in state.items()}
    for k in state:
        if k.endswith("running_mean"):
            blob[f"module.{k[:-len('running_mean')]}num_batches_tracked"] = torch.tensor(3)
    path = str(tmp_path / "ckpt.pth")
    torch.save({"state_dict": blob, "epoch": 7}, path)
    got = tw.load_pth_state_dict(path)
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v), k
    TEHNet(ModelConfig(n_points=256), device="cpu").load_state_dict(got, strict=True)


# --- the whole Ev2Hands-S evaluation --------------------------------------

# One chunk per dense layer: the same values, and a JAX program that traces
# and compiles several times faster than the default chunks'.
CHUNKS = dict(dense_chunk=512, regressor_dense_chunk=128)


def test_evaluate_dataset_matches_jax(data_dir, monkeypatch):
    """Two batches of one window through both packages' ``evaluate_dataset``
    with JAX's resample draws and the same weights (the port's seeded state
    dict, converted for JAX by its reference-checkpoint reader); the port on
    its fused grouping route (plain versions), the gate lowered so that, as
    at N = 2048, sa1 alone passes it. frames equal, MPJPE and MPVPE rtol
    1e-4, each PCK step within one joint of one frame (1 / (42 frames)),
    each AUC within 0.01."""
    N, bs = 256, 1
    jcfg = JCFG.replace(
        model=JModelConfig(n_points=N, pallas_fused_msg=True, **CHUNKS),
        train=dataclasses.replace(JCFG.train, eval_batch_size=bs))
    weights = tw.init_weights(torch.Generator().manual_seed(21), ModelConfig(n_points=N))
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in weights.items()})
    net = jt.TEHNet(cfg=jcfg.model)
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    j_hands = {s: h.params for s, h in create_mano_hands(synthetic_mano_models(0)).items()}
    ref = jev.evaluate_dataset(state, net, j_hands, js.Ev2HandSReader(data_dir["root"], N),
                               jcfg, max_frames=2 * bs)

    @jax.jit
    def draws_of(events, labels, key):
        """The resample draws of JAX's ERPC transform for this batch."""
        _, _, n_valid = jax.vmap(lambda e, l: je.rasterize_erpc(e, l, 346, 260))(
            events, labels)
        return jax.vmap(lambda k, n: jax.random.randint(
            jax.random.split(k, 3)[2], (N,), 0, jnp.maximum(n, 1)))(
            jax.random.split(key, bs), n_valid)

    def jax_draws(i, batch):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        return _t(draws_of(batch["events"], batch["labels"], key))

    cfg = DEFAULT_CONFIG.replace(
        model=ModelConfig(n_points=N, pallas_fused_msg=True, **CHUNKS),
        train=dataclasses.replace(DEFAULT_CONFIG.train, eval_batch_size=bs))
    port = TEHNet(cfg.model, device="cpu")
    port.load_state_dict(weights, strict=True)
    monkeypatch.setattr(tl, "SPARSE_MIN_PAIRS", 512 * N)
    calls = []
    real = tl.msg_fused_scales_sparse
    monkeypatch.setattr(tl, "msg_fused_scales_sparse", lambda *a: calls.append(1) or real(*a))
    got = tev.evaluate_dataset(port, ttrain.build_hands(cfg, synthetic=True, device="cpu"),
                               ts.Ev2HandSReader(data_dir["root"], N), cfg,
                               max_frames=2 * bs, device="cpu", draws=jax_draws)
    assert len(calls) == 2   # sa1's, one a batch
    assert got["frames"] == ref["frames"] == 2 * bs
    for k in ("mpjpe_mm", "mpvpe_mm"):
        assert math.isclose(got[k], ref[k], rel_tol=1e-4), (k, got[k], ref[k])
    for k, curve in ref["pck3d"].items():
        np.testing.assert_allclose(got["pck3d"][k], curve, rtol=0,
                                   atol=1.0 / (42 * ref["frames"]) + 1e-7)
        assert abs(got["auc"][k] - ref["auc"][k]) <= 0.01 + 1e-9


def test_eval_entry_points_default_to_the_card(data_dir):
    """Without a ``device`` argument the evaluation steps ask for CUDA and
    raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    from ev2hands_tpu_torch import evaluate_real as tevr

    net = TEHNet(ModelConfig(n_points=256), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.make_full_eval_step(net, {}, DEFAULT_CONFIG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevr.make_real_eval_step(net, {}, None, DEFAULT_CONFIG)
    reader = ts.Ev2HandSReader(data_dir["root"], 256)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tev.evaluate_dataset(net, {}, reader, DEFAULT_CONFIG)
