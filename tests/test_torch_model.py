"""The port's TEHNet layers, weight mapping and whole inference slice
against the JAX package on the CPU.

JAX variables come from ``jax.eval_shape(init)`` filled with numpy draws
(no eager init), and reach the port through ``weights.flax_to_torch``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
from ev2hands_tpu.model import layers as jl
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu.ops import pointnet as jp
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import ModelConfig
from ev2hands_tpu_torch.events import erpc as te
from ev2hands_tpu_torch.mano import layer as tml
from ev2hands_tpu_torch.mano import model_data as tmd
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from ev2hands_tpu_torch.ops import fps as tf
from ev2hands_tpu_torch.ops import pointnet as tp


def numpy_variables(module, rng, *args, **kwargs):
    """Variables of a flax module from eval_shape, filled from ``rng``:
    kernels ~ N(0, 1/fan_in) (the regressors' output layer 100x smaller),
    biases ~ 0.1 N, BN scale ~ 1 + 0.1 N, mean ~ 0.1 N, var ~ U[0.5, 1.5]."""
    shapes = jax.eval_shape(
        lambda *a: module.init({"params": jax.random.PRNGKey(0)}, *a, **kwargs),
        *args)

    def fill(path, leaf):
        name, parent = path[-1].key, path[-2].key if len(path) > 1 else ""
        s = leaf.shape
        if name == "var":
            a = 0.5 + rng.rand(*s)
        elif name == "mean":
            a = 0.1 * rng.randn(*s)
        elif name == "scale":
            a = 1.0 + 0.1 * rng.randn(*s)
        elif name == "bias":
            a = 0.1 * rng.randn(*s)
        else:
            a = rng.randn(*s) / math.sqrt(math.prod(s[:-1]))
            if parent == "fc_1":
                a = a * 0.01
        return np.asarray(a, np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: dict(v) for k, v in tree.items()}


def load_sub(port_module, variables, top):
    """Load a flax sub-module's variables into the matching port module by
    mapping them under the top-level name ``top`` of TEHNet."""
    sd = tw.flax_to_torch({c: {top: variables[c]} for c in variables})
    port_module.load_state_dict(
        {k[len(top) + 1:]: v for k, v in sd.items()}, strict=True)
    return port_module.eval()


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, B, N):
    return np.clip(rng.randn(B, N, 3) * 0.4, -1, 1).astype(np.float32)


MSG = dict(npoint=32, radius_list=(0.2, 0.4), nsample_list=(8, 16),
           mlps=((8, 8, 16), (8, 12, 16)))


@pytest.mark.parametrize("route", ["dense", "sparse"])
def test_set_abstraction_msg_matches_flax(route, monkeypatch):
    """Both routes of the port against JAX's dense eval route (``_dense_scale``
    on the CPU). The sparse route is forced at this small size by lowering
    the port's shape gate, with 64-point tiles. atol/rtol 1e-5: f32 matmuls
    summed in another order."""
    rng = np.random.RandomState(10)
    B, N, D = 2, 256, 5
    xyz, pts = _cloud(rng, B, N), rng.randn(B, N, D).astype(np.float32)
    jmod = jl.SetAbstractionMsg(**MSG)
    variables = numpy_variables(jmod, rng, xyz, pts)
    ref_xyz, ref = jax.jit(lambda v, a, b: jmod.apply(v, a, b, False))(
        variables, xyz, pts)

    port = load_sub(tl.SetAbstractionMsg(
        MSG["npoint"], MSG["radius_list"], MSG["nsample_list"], D, MSG["mlps"],
        pallas_nb=64, device="cpu"), variables, "sa1")
    calls = []
    if route == "sparse":
        monkeypatch.setattr(tl, "SPARSE_MIN_PAIRS", 0)
        real = tl.msg_scale_sparse
        monkeypatch.setattr(tl, "msg_scale_sparse",
                            lambda *a: calls.append(1) or real(*a))
    assert all(port.use_sparse_scale(i, N) == (route == "sparse")
               for i in range(2))
    with torch.no_grad():
        got_xyz, got = port(_t(xyz), _t(pts))
    assert len(calls) == (2 if route == "sparse" else 0)
    np.testing.assert_array_equal(got_xyz.numpy(), np.asarray(ref_xyz))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def _fp_case(rng, broadcast):
    B, N, S = 2, 64, 1 if broadcast else 16
    xyz1, xyz2 = _cloud(rng, B, N), _cloud(rng, B, S)
    p1 = None if broadcast else rng.randn(B, N, 6).astype(np.float32)
    p2 = rng.randn(B, S, 10).astype(np.float32)
    return (xyz1, xyz2, p1, p2), (10 if broadcast else 16)


@pytest.mark.parametrize("layer", ["sa_all", "fp", "fp_broadcast", "query_conv"])
def test_layer_matches_flax(layer):
    """SetAbstractionAll, FeaturePropagation (3-NN and the S == 1
    broadcast) and QueryConv against their flax modules with the same
    weights. atol/rtol 1e-5: f32 matmuls and convolutions summed in
    another order."""
    rng = np.random.RandomState(11)
    if layer == "sa_all":
        args = (_cloud(rng, 2, 32), rng.randn(2, 32, 10).astype(np.float32))
        jmod, top = jl.SetAbstractionAll(mlp=(16, 32)), "sa3"
        port = tl.SetAbstractionAll(13, (16, 32), device="cpu")
    elif layer in ("fp", "fp_broadcast"):
        args, c_in = _fp_case(rng, layer == "fp_broadcast")
        jmod, top = jl.FeaturePropagation(mlp=(16, 8)), "fp2"
        port = tl.FeaturePropagation(c_in, (16, 8), device="cpu")
    else:
        args = (rng.randn(2, 32, 12).astype(np.float32),)
        jmod, top = jl.QueryConv(features=16), "left_query_conv"
        port = tl.QueryConv(12, 16, device="cpu")
    variables = numpy_variables(jmod, rng, *args)
    ref = jax.jit(jmod.apply)(variables, *args)
    load_sub(port, variables, top)
    with torch.no_grad():
        got = port(*(None if a is None else _t(a) for a in args))
    if layer == "sa_all":
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        got, ref = got[1], ref[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_attention_block_and_batchnorm_match_jax():
    rng = np.random.RandomState(12)
    key = rng.randn(2, 32, 4).astype(np.float32)
    value = rng.randn(2, 32, 16).astype(np.float32)
    query = rng.randn(2, 32, 16).astype(np.float32)
    np.testing.assert_allclose(
        tl.attention_block(_t(key), _t(value), _t(query)).numpy(),
        np.asarray(jl.attention_block(key, value, query)), rtol=1e-5, atol=1e-6)
    bn = tl.BatchNorm(16, device="cpu").eval()
    jbn = jl._bn(False, "bn")
    variables = numpy_variables(jbn, rng, value)
    with torch.no_grad():
        bn.weight.copy_(_t(variables["params"]["scale"]))
        bn.bias.copy_(_t(variables["params"]["bias"]))
        bn.running_mean.copy_(_t(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(_t(variables["batch_stats"]["var"]))
        np.testing.assert_allclose(
            bn(_t(value)).numpy(), np.asarray(jbn.apply(variables, value)),
            rtol=1e-6, atol=1e-6)
        # training mode: batch statistics, and flax's running-average update
        # (the biased batch variance, momentum 0.9)
        got = bn.train()(_t(value))
        ref, upd = jl._bn(True, "bn").apply(variables, value,
                                            mutable=["batch_stats"])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        for name, key in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(
                getattr(bn, name).numpy(),
                np.asarray(upd["batch_stats"][key]), rtol=1e-6, atol=1e-6)


# --- the whole slice: ERPC -> TEHNet eval -> MANO, B=2, N=256 -------------

B, N = 2, 256


@pytest.fixture(scope="module")
def slice_run():
    """One JAX run of the slice (TEHNet compiled once) and the port's run on
    the same raw windows, weights and resample draws."""
    rng = np.random.RandomState(0)
    t = np.sort(rng.randint(0, int(5e6), (B, N))).astype(np.float32)
    raw = np.stack([
        rng.randint(0, 346, (B, N)).astype(np.float32),
        rng.randint(0, 260, (B, N)).astype(np.float32),
        t,
        rng.randint(0, 2, (B, N)).astype(np.float32),
    ], axis=-1)
    labels = rng.randint(0, 4, (B, N)).astype(np.int32)
    key = jax.random.PRNGKey(1)

    jcfg = JModelConfig(n_points=N, fps_deterministic=True)
    net = jt.TEHNet(cfg=jcfg)
    variables = numpy_variables(net, rng, jnp.zeros((1, N, 5)),
                                train=False)
    j_erpc = je.erpc_batch_transform(raw, labels, key, n_out=N)
    j_out = jax.jit(lambda v, x: net.apply(v, x, train=False))(
        variables, j_erpc.events)
    hands = {s: h.params for s, h in
             create_mano_hands(synthetic_mano_models(0)).items()}
    j_out = jax.jit(jt.apply_mano)(hands, j_out)

    _, _, n_valid = jax.jit(jax.vmap(
        lambda e, l: je.rasterize_erpc(e, l, 346, 260)))(raw, labels)
    draws = np.stack([
        np.asarray(jax.random.randint(jax.random.split(k, 3)[2], (N,), 0,
                                      jnp.maximum(n_valid[b], 1)))
        for b, k in enumerate(jax.random.split(key, B))])
    sd = tw.flax_to_torch(variables)
    port = tt.TEHNet(ModelConfig(n_points=N), device="cpu")
    port.load_state_dict(sd, strict=True)
    port.eval()
    t_hands = {s: tml.create_mano_params(m, device="cpu")
               for s, m in tmd.synthetic_mano_models(0).items()}
    with torch.no_grad():
        t_erpc = te.erpc_batch_transform(_t(raw), _t(labels), draws=_t(draws),
                                         n_out=N)
        t_out = tt.apply_mano(t_hands, port(t_erpc.events))
    return dict(variables=variables, sd=sd, j_erpc=j_erpc, j_out=j_out,
                t_erpc=t_erpc, t_out=t_out)


def test_weights_match_checkpoint_mapping(slice_run):
    """The port's flax->torch mapping gives the JAX package's keys, shapes
    and values, and the port's TEHNet loads it strictly."""
    ref = jckpt.flax_to_torch(slice_run["variables"])
    got = slice_run["sd"]
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port = tt.TEHNet(ModelConfig(n_points=N), device="cpu")
    port.load_state_dict(got, strict=True)
    seeded = tw.init_weights(torch.Generator().manual_seed(0))
    port.load_state_dict(seeded, strict=True)
    assert all(seeded[k].shape == got[k].shape for k in got)


def _selection_masks(events, fps, index, sqd):
    """Every ball-query mask of the eval path, from one side's ops."""
    l0 = events[..., :3]
    l1 = index(l0, fps(l0, 512))
    l2 = index(l1, fps(l1, 128))
    reg = index(l0, fps(l0, tt.REGRESSOR_NPOINT))
    masks = []
    for c, x, radii in ((l1, l0, (0.1, 0.2, 0.4)), (l2, l1, (0.4, 0.8)),
                        (reg, l0, (0.4, 0.8))):
        d = np.asarray(sqd(c, x))
        masks += [d <= np.float32(r * r) for r in radii]
    return masks


def test_slice_selection_masks_agree(slice_run):
    """Precondition of the slice check: both sides pick the same centroids
    and neighbors, so no ulp flip at a radius boundary decides it (seed 0
    has no such pair)."""
    ref = _selection_masks(np.asarray(slice_run["j_erpc"].events),
                           jp.farthest_point_sample, jp.index_points,
                           jp.square_distance)
    got = _selection_masks(slice_run["t_erpc"].events, tf.fps, tp.index_points,
                           tp.square_distance)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_slice_matches_jax(slice_run):
    """ERPC -> TEHNet eval -> MANO, the port fed JAX's resample draws, within
    1e-4 (atol and rtol, the JAX package's golden tolerance)."""
    j, t = slice_run["j_out"], slice_run["t_out"]
    np.testing.assert_array_equal(slice_run["t_erpc"].labels.numpy(),
                                  np.asarray(slice_run["j_erpc"].labels))
    np.testing.assert_allclose(t["class_logits"].numpy(),
                               np.asarray(j["class_logits"]), atol=1e-4, rtol=1e-4)
    for side in ("left", "right"):
        for k in ("global_orient", "hand_pose", "betas", "transl",
                  "vertices", "j3d"):
            np.testing.assert_allclose(
                t[side][k].numpy(), np.asarray(j[side][k]), atol=1e-4,
                rtol=1e-4, err_msg=f"{side}.{k}")
