"""The port's grouped-neighbor gather (the one-hot gather K8, its
scatter-add backward K9, the differentiable ``grouped_gather``), its ball
queries and the train-mode set abstraction against the JAX package on the
CPU.

The JAX kernels run in interpret mode; the port's wrappers take their
plain versions on CPU tensors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.model import layers as jl
from ev2hands_tpu.ops import pallas_gather as jpg
from ev2hands_tpu.ops import pointnet as jp
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from ev2hands_tpu_torch.ops import gather as tga
from ev2hands_tpu_torch.ops import grouping as tg
from ev2hands_tpu_torch.ops import pointnet as tp
from test_torch_model import load_sub, numpy_variables


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, B, N):
    return np.clip(rng.randn(B, N, 3) * 0.4, -1, 1).astype(np.float32)


# --- K8 / K9 and grouped_gather, at the JAX package's kernel-test shapes ---

B, N, S, K, NB = 2, 256, 16, 24, 64


@pytest.fixture(scope="module", params=[8, 45], ids=["narrow", "wide"])
def gather_case(request):
    """Inputs with clustered, heavily duplicated positions (a backfilled
    ball query), and JAX's grouped_gather with the scatter-add kernel as its
    backward: the forward is _onehot_gather, the gradient
    _onehot_scatter_add, both in interpret mode. C=45 takes the wide
    (3 * C > 128) path."""
    C = request.param
    rng = np.random.RandomState(C)
    src = rng.randn(B, N, C).astype(np.float32)
    idx = np.clip(rng.randint(0, N, (B, S, 1)) + rng.randint(-8, 9, (B, S, K)),
                  0, N - 1).astype(np.int32)
    idx[:, :, K // 2:] = idx[:, :, :1]
    ct = rng.randn(B, S, K, C).astype(np.float32)

    @jax.jit
    def ref(src, idx, ct):
        act = jpg.pos_tile_activity(idx, NB, N)
        out, vjp = jax.vjp(lambda s: jpg.grouped_gather(
            s, idx, act, nb=NB, bwd="pallas", interpret=True), src)
        return act, out, vjp(ct)[0]

    act, out, grad = ref(src, idx, ct)
    return dict(src=src, idx=idx, ct=ct, act=np.asarray(act),
                out=np.asarray(out), grad=np.asarray(grad))


def test_pos_tile_activity_matches_jax(gather_case):
    got = tga.pos_tile_activity(_t(gather_case["idx"]), NB, N)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), gather_case["act"])


def test_onehot_gather_plain_matches_interpret(gather_case):
    """K8's plain version is bitwise equal to the kernel in interpret mode."""
    c = gather_case
    launches = tga.onehot_gather.launches
    got = tga.onehot_gather(_t(c["src"]), _t(c["idx"]), _t(c["act"]), nb=NB)
    assert tga.onehot_gather.launches == launches   # CPU: plain version
    np.testing.assert_array_equal(got.numpy(), c["out"])


def test_onehot_scatter_add_plain_matches_interpret(gather_case):
    """K9's plain version within 1e-5 of the kernel in interpret mode (f32
    sums in another order)."""
    c = gather_case
    launches = tga.onehot_scatter_add.launches
    got = tga.onehot_scatter_add(_t(c["ct"]), _t(c["idx"]), _t(c["act"]), N, nb=NB)
    assert tga.onehot_scatter_add.launches == launches
    np.testing.assert_allclose(got.numpy(), c["grad"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("bwd", ["xla", "pallas"])
def test_grouped_gather_grad_matches_jax_vjp(gather_case, bwd):
    """The autograd.Function under both backward modes: the forward bitwise
    and the gradient within 1e-5 of jax.vjp of JAX's grouped_gather."""
    c = gather_case
    src = _t(c["src"]).requires_grad_(True)
    out = tga.grouped_gather(src, _t(c["idx"]), _t(c["act"]), nb=NB, bwd=bwd)
    np.testing.assert_array_equal(out.detach().numpy(), c["out"])
    (out * _t(c["ct"])).sum().backward()
    np.testing.assert_allclose(src.grad.numpy(), c["grad"], rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        tga.grouped_gather(src, _t(c["idx"]), _t(c["act"]), nb=NB, bwd="other")


# --- ball queries ---------------------------------------------------------

def test_query_ball_point_matches_jax():
    """Both selection forms equal JAX's exactly, including a query with no
    in-radius point (clamped to N - 1) and nsample > N (backfilled)."""
    rng = np.random.RandomState(5)
    Bq, Nq, Sq = 2, 96, 20
    xyz = _cloud(rng, Bq, Nq)
    new_xyz = xyz[:, :Sq].copy()
    new_xyz[:, 4] = 9.0
    sq = np.asarray(jp.square_distance(new_xyz, xyz))
    r, k = 0.5, 100   # k > N: the top-k form pads
    refs = jax.jit(lambda sq: [jp.query_ball_point(r, k, xyz, new_xyz, sqrdists=sq,
                                                   rank=rank) for rank in (True, False)])(sq)
    for rank, ref in zip((True, False), refs):
        ref = np.asarray(ref)
        got = tp.query_ball_point(r, k, _t(sq), rank=rank)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"rank={rank}")
        assert (got[:, 4] == Nq - 1).all()


def test_query_ball_point_permuted_matches_jax():
    """Positions into the Morton-permuted axis equal JAX's exactly, and map
    back to query_ball_point's original indices."""
    rng = np.random.RandomState(6)
    Bq, Nq, Sq = 2, 128, 16
    xyz = _cloud(rng, Bq, Nq)
    new_xyz = xyz[:, :Sq]
    perm = tg.morton_perm(_t(xyz))
    xyz_p = tp.index_points(_t(xyz), perm)
    sq_p = tp.square_distance(_t(new_xyz), xyz_p)
    r, k = 0.5, 150   # k > N: backfilled past N
    ref = np.asarray(jp.query_ball_point_permuted(
        r, k, jnp.asarray(perm.numpy()), jnp.asarray(sq_p.numpy())))
    got = tp.query_ball_point_permuted(r, k, perm, sq_p)
    np.testing.assert_array_equal(got.numpy(), ref)
    orig = torch.gather(perm.long()[:, None, :].expand(-1, Sq, -1), 2, got)
    np.testing.assert_array_equal(
        orig.numpy(), tp.query_ball_point(
            r, k, tp.square_distance(_t(new_xyz), _t(xyz))).numpy())


# --- the train-mode set abstraction ---------------------------------------

MSG = dict(npoint=16, radius_list=(0.2, 0.4), nsample_list=(8, 16),
           mlps=((16, 16, 32), (16, 16, 32)))
D = 45   # 3 * (45 + 3) > 128: the wide path


@pytest.fixture(scope="module")
def sa_case():
    """JAX's SetAbstractionMsg in train mode through its pgather branch
    (gate forced on, grouped_gather in interpret mode with the scatter-add
    kernel as backward), as the JAX package's own layer test runs it:
    outputs, BatchNorm updates and the gradients of a scalar loss."""
    rng = np.random.RandomState(8)
    Bs, Ns = 2, 256
    xyz, pts = _cloud(rng, Bs, Ns), rng.randn(Bs, Ns, D).astype(np.float32)
    wts = rng.randn(Bs, MSG["npoint"], 64).astype(np.float32)
    jmod = jl.SetAbstractionMsg(grouping="gather", pallas_gather=True,
                                pallas_gather_nb=64, pallas_gather_bwd=True,
                                rank_ball_query=True, **MSG)
    variables = numpy_variables(jmod, rng, xyz, pts, train=True)

    def loss(params, f):
        (_, out), upd = jmod.apply({**variables, "params": params}, xyz, f, True,
                                   mutable=["batch_stats"])
        return jnp.sum(out * wts), (out, upd["batch_stats"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jl.SetAbstractionMsg, "_use_pallas_gather",
                   lambda self, n, d: True)
        mp.setattr(jpg, "grouped_gather",
                   functools.partial(jpg.grouped_gather, interpret=True))
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(variables["params"], pts)
    return dict(xyz=xyz, pts=pts, wts=wts, variables=variables,
                out=np.asarray(out), stats=stats, grads=grads)


def assert_close_scaled(got, ref, tol, name=""):
    """max |got - ref| <= tol * max |ref| over the tensor."""
    got, ref = np.asarray(got), np.asarray(ref)
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{name}: max abs diff {err} > {tol} * {scale}"


@pytest.mark.parametrize("pallas_gather", [False, True], ids=["index", "onehot"])
def test_set_abstraction_msg_train_matches_jax(sa_case, pallas_gather):
    """Both gather routes of the port in train mode against JAX's pgather
    branch. f32 matrix products sum in another order than XLA's and the
    batch normalisation divides by the batch spread, so each tensor is held
    to a bound relative to its largest entry: outputs and BatchNorm running
    statistics 5e-6, parameter and input gradients 1e-5 (measured: 1.4e-6,
    8e-7 and 3.4e-6), except the BatchNorm-cancelled conv biases."""
    c = sa_case
    port = load_sub(tl.SetAbstractionMsg(
        MSG["npoint"], MSG["radius_list"], MSG["nsample_list"], D, MSG["mlps"],
        grouping="gather", pallas_gather=pallas_gather, pallas_gather_nb=64,
        pallas_gather_bwd=True, device="cpu"), c["variables"], "sa1").train()
    assert port.use_pallas_gather(256, D) == pallas_gather
    pts = _t(c["pts"]).requires_grad_(True)
    _, out = port(_t(c["xyz"]), pts)
    (out * _t(c["wts"])).sum().backward()
    assert_close_scaled(out.detach(), c["out"], 5e-6, "output")

    ref = tl_state(c["variables"]["params"], c["stats"])
    for name, buf in port.named_buffers():
        assert_close_scaled(buf, ref[name], 5e-6, name)
    gref = tl_state(c["grads"][0], c["stats"])
    # the conv biases that feed a train-mode BatchNorm have a zero gradient:
    # both sides give rounding noise there
    cancelled = tt.batchnorm_cancelled_biases(port)
    assert len(cancelled) == sum(map(len, MSG["mlps"]))
    for name, p in port.named_parameters():
        if name not in cancelled:
            assert_close_scaled(p.grad, gref[name], 1e-5, name)
    assert_close_scaled(pts.grad, c["grads"][1], 1e-5, "points")


def tl_state(params, stats):
    """A flax layer's params and batch stats as the port's state dict."""
    from ev2hands_tpu_torch import weights as tw

    tree = jax.tree.map(np.array, {"params": {"sa1": params},
                                   "batch_stats": {"sa1": stats}})
    sd = tw.flax_to_torch(tree)
    return {k[len("sa1."):]: v.numpy() for k, v in sd.items()}
