"""The port's dense grouping ops (one MSG scale over every point, original
point order) against their Pallas functions in interpret mode, on the CPU
(the plain versions of ``csrc/msg_ball.cu``'s two modes).

Inputs come from numpy seeds and go to both sides, at the shapes of the JAX
package's own kernel tests (B=2, S=32, N=256, widths (16, 16, 32), r=0.3,
K=8), each function with its own block sizes. atol 2e-5: f32 matrix
products summed in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.ops import pallas_grouping as jg
from ev2hands_tpu_torch.ops import grouping as tg

B, S, N = 2, 32, 256
R, K = 0.3, 8
FAR = 3   # a centroid at (7, 7, 7): an empty ball


def _t(a):
    return torch.from_numpy(np.array(a))


def _scale_params(rng, d_in, widths=(16, 16, 32)):
    conv, bn = [], []
    last = d_in
    for C in widths:
        conv.append({"kernel": rng.randn(last, C).astype(np.float32) * 0.2,
                     "bias": rng.randn(C).astype(np.float32) * 0.1})
        bn.append({"scale": (1 + 0.1 * rng.randn(C)).astype(np.float32),
                   "bias": (0.1 * rng.randn(C)).astype(np.float32),
                   "mean": (0.1 * rng.randn(C)).astype(np.float32),
                   "var": (np.abs(rng.randn(C)) + 0.5).astype(np.float32)})
        last = C
    return conv, bn


@pytest.fixture(scope="module")
def case():
    """A clustered cloud, 5 point features, centroids on the first S points
    but one far away; the scale folded by the JAX package."""
    rng = np.random.RandomState(4321)
    xyz = np.clip(rng.randn(B, N, 3) * 0.4, -1, 1).astype(np.float32)
    feats = rng.randn(B, N, 5).astype(np.float32)
    new_xyz = xyz[:, :S].copy()
    new_xyz[:, FAR] = 7.0
    conv, bn = _scale_params(rng, 8)
    folded = jg.fold_scale_params(feats, xyz, new_xyz, conv, bn)
    t_folded = tg.FoldedScale(*(_t(x) for x in folded))
    return xyz, new_xyz, folded, t_folded


def _point0_chain(folded, s):
    """[B, C3] the chain of point 0 for centroid s, in numpy."""
    f = [np.asarray(x) for x in folded]
    h = np.maximum(f[0][:, 0] - f[1][:, s], 0)
    h = np.maximum(h @ f[2] + f[3], 0)
    return np.maximum(h @ f[4] + f[5], 0)


MASK_OPS = [("dense_msg_scale_2d", jg.dense_msg_scale_pallas_2d, 8),
            ("dense_msg_scale_2d_batched", jg.dense_msg_scale_pallas_2d_batched, 4)]
BALL_OPS = [("fused_msg_scale", jg.fused_msg_scale_pallas, 8, 64),
            ("dense_msg_scale", jg.dense_msg_scale_pallas, 16, 128)]


# the edited mask's row that selects nothing and its row that selects every point
EMPTY, FULL = 5, 9


@pytest.mark.parametrize("mask", ["dense", "edited"])
@pytest.mark.parametrize("name,pallas,sb", MASK_OPS, ids=[o[0] for o in MASK_OPS])
def test_mask_op_matches_pallas_interpret(case, name, pallas, sb, mask):
    """K5 and K7: the mask of ``dense_selection_mask`` (its point-0
    fallback included) given to both sides; "edited", the same mask with
    row EMPTY zeroed (-1e30 on both sides) and row FULL set on every point,
    the two inputs the kernel's mask mode adds logic for (a centroid with
    no row; one with more rows than a pass holds)."""
    xyz, new_xyz, folded, t_folded = case
    sel = jg.dense_selection_mask(jnp.asarray(xyz), jnp.asarray(new_xyz), R, K)
    if mask == "edited":
        sel = sel.at[:, EMPTY].set(0.0).at[:, FULL].set(1.0)
    ref = np.asarray(pallas(folded, sel, sb=sb, interpret=True))
    op = getattr(tg, name)
    launches = op.launches
    got = op(t_folded, _t(sel), sb=sb).numpy()
    assert op.launches == launches   # CPU: the plain version
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got[:, FAR], _point0_chain(folded, FAR), atol=2e-5)
    if mask == "edited":
        assert (ref[:, EMPTY] == np.float32(-1e30)).all()
        assert (got[:, EMPTY] == np.float32(-1e30)).all()
    # other centroid chunks give other matmul shapes (BLAS kernels): 1e-6
    np.testing.assert_allclose(
        tg.dense_msg_scale_2d_plain(t_folded, _t(sel), chunk=5).numpy(), got, atol=1e-6)


@pytest.mark.parametrize("name,pallas,sb,nb", BALL_OPS, ids=[o[0] for o in BALL_OPS])
def test_ball_op_matches_pallas_interpret(case, name, pallas, sb, nb):
    """K4 and K6: the selection made from the coordinates on both sides; the
    far centroid's empty ball pools point 0's chain."""
    xyz, new_xyz, folded, t_folded = case
    ref = np.asarray(pallas(jnp.asarray(xyz), jnp.asarray(new_xyz), folded, R, K,
                            sb=sb, nb=nb, interpret=True))
    op = getattr(tg, name)
    launches = op.launches
    got = op(_t(xyz), _t(new_xyz), t_folded, R, K, sb=sb, nb=nb).numpy()
    assert op.launches == launches   # CPU: the plain version
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got[:, FAR], _point0_chain(folded, FAR), atol=2e-5)
    # the same function as the mask ops on the same selection
    sel = tg.ball_selection_mask(_t(xyz), _t(new_xyz), R, K)
    np.testing.assert_array_equal(got, tg.dense_msg_scale_2d_plain(t_folded, sel).numpy())


def _numpy_selection(xyz, new_xyz, radius, nsample):
    """Elementwise f32 distances in _kernel_fused's order, a loop over the
    points in index order."""
    d = new_xyz[:, :, None, :] - xyz[:, None, :, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    inside = d2 <= np.float32(radius * radius)
    sel = np.zeros(inside.shape, np.float32)
    for b in range(inside.shape[0]):
        for s in range(inside.shape[1]):
            hits = np.flatnonzero(inside[b, s])
            sel[b, s, hits[:nsample] if len(hits) else [0]] = 1.0
    return sel


def _ulps(x, n):
    """x moved n ulps in f32."""
    for _ in range(abs(n)):
        x = np.nextafter(x, np.float32(np.inf if n > 0 else 0))
    return x


def _near_radius(radius):
    """Offsets (x, y, 0) in f32 from a centroid at 0 whose f32 squared
    distance lies within 2 ulps of ``radius * radius`` rounded to f32: some
    exactly on it, some just inside and outside."""
    r2 = np.float32(radius * radius)
    lo, hi = _ulps(r2, -2), _ulps(r2, 2)
    x0 = np.float32(radius)
    y0 = np.float32(radius / np.sqrt(2.0))
    cands = [(_ulps(x0, i), np.float32(0)) for i in range(-8, 9)]
    cands += [(_ulps(y0, i), _ulps(y0, j)) for i in range(-8, 9) for j in range(-8, 9)]
    out = []
    for x, y in cands:
        d2 = np.float32(x * x) + np.float32(y * y)
        if lo <= d2 <= hi:
            out.append((x, y, np.float32(0), d2 == r2))
    return out


@pytest.mark.parametrize("radius", [0.25, 0.3, 0.1, 0.4])
def test_ball_selection_mask_exact_on_the_radius(radius):
    """Points whose f32 squared distance from a centroid at 0 is exactly
    radius^2 in f32, or within two ulps of it, the same offsets around
    shifted centroids, more in-radius points than nsample, duplicates, and a
    centroid with an empty ball: equal to a numpy reference, and the points
    exactly on the radius selected."""
    rng = np.random.RandomState(int(radius * 100))
    near = _near_radius(radius)
    on = [o for o in near if o[3]]
    near = on[:8] + [o for o in near if not o[3]][:8]
    assert on   # some points exactly on the radius
    centres = np.asarray([[0, 0, 0], [0.5, -0.25, 0.125], [-0.3, 0.7, 0.1]], np.float32)
    pts = []
    for c in centres:
        for x, y, z, _ in near:
            for sign in (1, -1):
                pts.append(c + sign * np.asarray([x, y, z], np.float32))
                pts.append(c + sign * np.asarray([z, x, y], np.float32))
    pts = np.asarray(pts, np.float32)
    n_fill = 256 - len(pts)
    fill = np.clip(rng.randn(n_fill, 3) * 0.4, -1, 1).astype(np.float32)
    xyz = np.concatenate([pts, fill])[rng.permutation(256)]
    xyz[200:210] = xyz[10]   # duplicates of one point
    xyz = np.stack([xyz, xyz[::-1].copy()])
    new_xyz = np.concatenate([centres, [[7, 7, 7]], xyz[0, :4]]).astype(np.float32)
    new_xyz = np.stack([new_xyz, new_xyz])
    for nsample in (4, 16, 300):
        got = tg.ball_selection_mask(_t(xyz), _t(new_xyz), radius, nsample).numpy()
        np.testing.assert_array_equal(got, _numpy_selection(xyz, new_xyz, radius, nsample))
    assert got[:, 3, 0].tolist() == [1.0, 1.0] and got[:, 3].sum() == 2
    d2 = (xyz[0] * xyz[0]).sum(-1, dtype=np.float32)   # exact for these offsets
    exact = np.flatnonzero(np.all(xyz[0] == xyz[0] * [[1, 1, 0]], -1)
                           & (d2 == np.float32(radius * radius)))
    assert len(exact) and (got[0, 0, exact] == 1).all()


def test_wrappers_raise_where_pallas_asserts():
    """S % sb and N % nb as the Pallas functions assert them, nsample >= 1,
    and no device but the CPU (plain version) or CUDA (kernel)."""
    rng = np.random.RandomState(0)
    shapes = [(1, 64, 4), (1, 8, 4), (4, 6), (6,), (6, 5), (5,)]
    f = tg.FoldedScale(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                         for s in shapes))
    xyz, new_xyz = torch.rand(1, 64, 3), torch.rand(1, 8, 3)
    sel = torch.ones(1, 8, 64)
    for sb in (3, 0):
        with pytest.raises(ValueError):
            tg.dense_msg_scale_2d(f, sel, sb=sb)
        with pytest.raises(ValueError):
            tg.dense_msg_scale_2d_batched(f, sel, sb=sb)
    for sb, nb in ((3, 32), (8, 48), (8, 0)):
        with pytest.raises(ValueError):
            tg.fused_msg_scale(xyz, new_xyz, f, 0.3, 4, sb=sb, nb=nb)
        with pytest.raises(ValueError):
            tg.dense_msg_scale(xyz, new_xyz, f, 0.3, 4, sb=sb, nb=nb)
    with pytest.raises(ValueError):
        tg.fused_msg_scale(xyz, new_xyz, f, 0.3, 0, nb=32)
    with pytest.raises(ValueError):
        tg.dense_msg_scale(xyz, new_xyz, f, 0.3, 0, sb=8, nb=32)
    meta = tg.FoldedScale(*(t.to("meta") for t in f))
    with pytest.raises(ValueError):
        tg.dense_msg_scale_2d(meta, sel.to("meta"))
    with pytest.raises(ValueError):
        tg.dense_msg_scale_2d_batched(meta, sel.to("meta"))
    with pytest.raises(ValueError):
        tg.fused_msg_scale(xyz.to("meta"), new_xyz.to("meta"), meta, 0.3, 4, nb=32)
    with pytest.raises(ValueError):
        tg.dense_msg_scale(xyz.to("meta"), new_xyz.to("meta"), meta, 0.3, 4, sb=8, nb=32)
    # the block sizes that do divide run the plain version
    assert tg.dense_msg_scale_2d(f, sel, sb=4).shape == (1, 8, 5)
    assert tg.dense_msg_scale(xyz, new_xyz, f, 0.3, 4, sb=8, nb=32).shape == (1, 8, 5)
