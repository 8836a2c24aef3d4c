"""The port's CUDA kernels against their plain versions on the card, and
the training step's bits run to run.

Marked ``cuda``: without a CUDA device every test skips. On the H100 run
``python -m pytest tests/test_torch_kernels.py`` (the first call builds the
kernels with nvcc).
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.ops import fps as tf
from ev2hands_tpu_torch.ops import gather as tga
from ev2hands_tpu_torch.ops import grouping as tg
from ev2hands_tpu_torch.ops import pointnet as tp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cloud(rng, B, N, n_base):
    """Points in [-1, 1] drawn with replacement from n_base distinct ones:
    duplicates make equal distances, where ties must go to the lowest index."""
    base = np.clip(rng.randn(B, n_base, 3) * 0.4, -1, 1).astype(np.float32)
    idx = rng.randint(0, n_base, (B, N))
    return torch.from_numpy(np.take_along_axis(base, idx[..., None], axis=1))


FPS_SHAPES = [(2048, 512), (2048, 128), (512, 128), (300, 400), (33, 40),
              (8192, 512)]


@pytest.mark.parametrize("B", [1, 8, 16, 32])
@pytest.mark.parametrize("N,npoint", FPS_SHAPES)
@pytest.mark.parametrize("distinct", ["most", "five"])
def test_fps_kernel_matches_plain(cuda, N, npoint, B, distinct):
    """Bitwise-equal indices at the serving, training and evaluation batch
    sizes, N from 33 to the kernel's 8192, npoint above N, random starts
    with the last row's at N - 1, on clouds drawn with replacement from 3/4
    N distinct points or from five (ties everywhere after five steps)."""
    rng = np.random.RandomState(N + npoint + B)
    xyz = _cloud(rng, B, N, max(8, N * 3 // 4) if distinct == "most" else 5).to(cuda)
    start = rng.randint(0, N, B).astype(np.int32)
    start[-1] = N - 1
    start = torch.from_numpy(start).to(cuda)
    launches = tf.fps.launches
    got = tf.fps(xyz, npoint, start)
    torch.cuda.synchronize()
    assert tf.fps.launches == launches + 1
    ref = tf.fps_plain(xyz, npoint, start)
    assert torch.equal(got, ref)
    assert torch.equal(tf.fps_unchecked(xyz, npoint, start), ref)


@pytest.mark.parametrize("N", [2048, 512, 300])
def test_fps_kernel_every_instantiation_matches_plain(cuda, N):
    """Every built (threads, points a thread) that holds N, with the two
    redux.sync and with the 64-bit butterfly: the same indices."""
    rng = np.random.RandomState(N)
    B, npoint = 4, 160
    xyz = _cloud(rng, B, N, N * 3 // 4).to(cuda)
    start = torch.from_numpy(rng.randint(0, N, B).astype(np.int32)).to(cuda)
    ref = tf.fps_plain(xyz, npoint, start)
    tried = 0
    for threads, most in tf.CONFIGS.items():
        ppt = 1
        while ppt <= most:
            if threads * ppt >= N:
                for redux in (True, False):
                    got = tf.fps_unchecked(xyz, npoint, start, config=(threads, ppt),
                                           redux=redux)
                    assert torch.equal(got, ref), (threads, ppt, redux)
                    tried += 1
            ppt *= 2
    assert tried >= 8


def _folded(rng, B, S, N, widths, device):
    C1, C2, C3 = widths
    t = lambda *s, scale=1.0: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(device)
    return tg.FoldedScale(u=t(B, N, C1), v=t(B, S, C1, scale=0.5),
                          W2=t(C1, C2, scale=C1 ** -0.5), b2=t(C2, scale=0.1),
                          W3=t(C2, C3, scale=C2 ** -0.5), b3=t(C3, scale=0.1))


@pytest.mark.parametrize("widths", [(32, 32, 64), (64, 64, 128), (64, 96, 128),
                                    (8, 12, 16)])
def test_msg_sparse_kernel_matches_plain(cuda, widths):
    """Random masks with up to K selected points per centroid, some empty
    centroids (result -1e30) and S not a multiple of 8. atol 1e-4: f32
    sums in another order than cuBLAS."""
    rng = np.random.RandomState(sum(widths))
    B, S, N, nb, K = 2, 61, 2048, 256, 128
    folded = _folded(rng, B, S, N, widths, cuda)
    sel = np.zeros((B, S, N), np.float32)
    for b in range(B):
        for s in range(S):
            if s % 13 == 7:
                continue  # empty
            c = rng.randint(0, N)
            span = rng.randint(1, 600)
            pts = rng.randint(max(0, c - span), min(N, c + span), K)
            sel[b, s, pts] = 1.0
    sel_p = torch.from_numpy(sel).to(cuda)
    act = tg.tile_activity(sel_p, nb)
    launches = tg.msg_scale_sparse.launches
    got = tg.msg_scale_sparse(folded, sel_p, act, nb)
    torch.cuda.synchronize()
    assert tg.msg_scale_sparse.launches == launches + 1
    ref = tg.msg_scale_sparse_plain(folded, sel_p, act, nb)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert (got[:, 7] == -1e30).all()


def _fused_case(rng, B, S, N, nb, widths, device):
    """Stacked scales of the given (C1, C2, C3) widths and random per-scale
    masks of up to 128 points each, clustered so that tiles go unused, with
    an empty centroid (7) in every scale and one (11) empty in scale 0 only."""
    folded = [_folded(rng, B, S, N, w, "cpu") for w in widths]
    stacked, sections, blocks = tg.stack_folded_scales(folded)
    R = len(widths)
    sel = np.zeros((B, R, S, N), np.float32)
    for b in range(B):
        for s in range(S):
            if s % 13 == 7:
                continue
            c = rng.randint(0, N)
            for r in range(R):
                if s % 13 == 11 and r == 0:
                    continue
                span = rng.randint(1, 300 * (r + 1))
                pts = rng.randint(max(0, c - span), min(N, c + span), 32 << r)
                sel[b, r, s, pts] = 1.0
    sel_all = torch.from_numpy(sel).to(device)
    act = torch.stack([tg.tile_activity(sel_all[:, r], nb) for r in range(R)],
                      dim=1).amax(dim=1)
    stacked = tg.FoldedScale(*(t.to(device) for t in stacked))
    folded = [tg.FoldedScale(*(t.to(device) for t in f)) for f in folded]
    return stacked, sel_all, act, sections, blocks, folded


# sa1's three scales, and a narrow set of two
FUSED_WIDTHS = [((32, 32, 64), (64, 64, 128), (64, 96, 128)),
                ((8, 12, 16), (4, 8, 24))]


@pytest.mark.parametrize("widths", FUSED_WIDTHS)
def test_msg_fused_sparse_kernel_matches_plain(cuda, widths):
    """All scales in one launch against the plain version (atol 1e-4, f32
    sums in another order than cuBLAS) and against ``msg_scale_sparse`` run
    on each scale with its own tile activity (equal: the same rows, each
    through the same arithmetic). Empty sections stay at -1e30."""
    rng = np.random.RandomState(len(widths))
    B, S, N, nb = 2, 61, 2048, 256
    stacked, sel_all, act, sections, blocks, folded = _fused_case(
        rng, B, S, N, nb, widths, cuda)
    assert act.float().mean() < 1
    launches = tg.msg_fused_scales_sparse.launches
    got = tg.msg_fused_scales_sparse(stacked, sel_all, act, sections, nb, blocks)
    torch.cuda.synchronize()
    assert tg.msg_fused_scales_sparse.launches == launches + 1
    ref = tg.msg_fused_scales_sparse_plain(stacked, sel_all, act, sections, nb)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert (got[:, 7] == -1e30).all()
    assert (got[:, 11, :sections[0]] == -1e30).all()
    assert (got[:, 11, sections[0]:] > -1e30).all()
    per_scale = torch.cat([
        tg.msg_scale_sparse(f, sel_all[:, r], tg.tile_activity(sel_all[:, r], nb), nb)
        for r, f in enumerate(folded)], dim=-1)
    assert torch.equal(got, per_scale)


def test_msg_fused_sparse_wrapper_rejects_what_it_cannot_take(cuda):
    rng = np.random.RandomState(0)
    B, S, N, nb = 1, 16, 512, 256
    stacked, sel_all, act, sections, blocks, _ = _fused_case(
        rng, B, S, N, nb, ((8, 8, 16), (8, 12, 16)), cuda)
    fused = tg.msg_fused_scales_sparse
    with pytest.raises(ValueError):   # blocks do not add up to u's channels
        fused(stacked, sel_all, act, sections, nb, [(8, 8), (4, 12)])
    with pytest.raises(ValueError):   # a section too many
        fused(stacked, sel_all, act, sections + (4,), nb, blocks + ((8, 8),))
    with pytest.raises(ValueError):   # mask of the wrong shape
        fused(stacked, sel_all[:, :1], act, sections, nb, blocks)
    with pytest.raises(ValueError):   # nb does not divide N
        fused(stacked, sel_all, act, sections, 200, blocks)
    with pytest.raises(ValueError):   # float64 mask
        fused(stacked, sel_all.double(), act, sections, nb, blocks)
    with pytest.raises(ValueError):   # int64 activity
        fused(stacked, sel_all, act.long(), sections, nb, blocks)
    with pytest.raises(ValueError):   # the mask on the CPU, u on the card
        fused(stacked, sel_all.cpu(), act, sections, nb, blocks)
    wide = _fused_case(rng, B, S, N, nb, ((8, 8, 257),), cuda)
    with pytest.raises(ValueError):   # a section wider than the block's threads
        fused(*wide[:4], nb, wide[4])
    four = _fused_case(rng, B, S, N, nb, ((4, 4, 8),) * 4, cuda)
    with pytest.raises(ValueError):   # more scales than the kernel takes
        fused(*four[:4], nb, four[4])


def test_kernel_wrappers_reject_what_they_cannot_take(cuda):
    with pytest.raises(ValueError):
        tf.fps(torch.zeros(2, 64, 4, device=cuda), 8)
    with pytest.raises(ValueError):
        tf.fps(torch.zeros(2, 64, 3, device=cuda), 8,
               torch.tensor([0, 64], dtype=torch.int32, device=cuda))
    folded = _folded(np.random.RandomState(0), 1, 8, 512, (8, 8, 512), cuda)
    sel = torch.ones(1, 8, 512, device=cuda)
    with pytest.raises(ValueError):
        tg.msg_scale_sparse(folded, sel, tg.tile_activity(sel, 256), 256)
    idx = torch.zeros(1, 8, 4, dtype=torch.int32, device=cuda)
    act = tga.pos_tile_activity(idx, 128, 256)
    with pytest.raises(ValueError):   # float64 source
        tga.onehot_gather(torch.zeros(1, 256, 3, dtype=torch.float64,
                                      device=cuda), idx, act)
    with pytest.raises(ValueError):   # N not a multiple of nb
        tga.onehot_gather(torch.zeros(1, 200, 3, device=cuda), idx, act)


def _gather_case(rng, B, N, S, K, C, device):
    """Clustered, heavily duplicated int64 positions (the backfill pattern
    and the index type of a ball query) and a source of C channels."""
    src = torch.from_numpy(rng.randn(B, N, C).astype(np.float32)).to(device)
    base = rng.randint(0, N, (B, S, 1))
    idx = np.clip(base + rng.randint(-40, 41, (B, S, K)), 0, N - 1)
    idx[:, :, K // 2:] = idx[:, :, :1]
    return src, torch.from_numpy(idx.astype(np.int64)).to(device)


# (B, N, S, K, C): one small shape; the training path's sa1, sa2 and
# regressor heads' sa1; one whose B*S*K*C (825) is not a multiple of 4,
# which takes the gather's scalar tail (S=5 with a centroid block of 1);
# and N = 12,288, whose row counts fill the scatter's 48 KB of default
# shared memory, so its scan kernel (128 bytes of static shared memory
# besides) needs the raised limit
GATHER_SHAPES = [(2, 256, 16, 24, 45), (8, 2048, 512, 224, 8),
                 (8, 512, 128, 192, 323), (8, 2048, 128, 192, 7),
                 (3, 256, 5, 11, 5), (1, 12288, 64, 32, 4)]


def _sb(S):
    """The largest centroid block up to 8 that divides S."""
    return math.gcd(S, 8)


@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_onehot_gather_kernel_bitwise(cuda, shape):
    B, N, S, K, C = shape
    src, idx = _gather_case(np.random.RandomState(C), B, N, S, K, C, cuda)
    act = tga.pos_tile_activity(idx, 128, N)
    launches = tga.onehot_gather.launches
    got = tga.onehot_gather(src, idx, act, sb=_sb(S))
    torch.cuda.synchronize()
    assert tga.onehot_gather.launches == launches + 1
    assert torch.equal(got, tga.onehot_gather_plain(src, idx))


def _scatter_case(shape, device):
    B, N, S, K, C = shape
    rng = np.random.RandomState(C + 1)
    _, idx = _gather_case(rng, B, N, S, K, C, device)
    g = torch.from_numpy(rng.randn(B, S, K, C).astype(np.float32)).to(device)
    return g, idx, tga.pos_tile_activity(idx, 128, N)


@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_onehot_scatter_add_kernel_matches_plain(cuda, shape):
    """Within 1e-5 * (1 + the sum of |contributions|) per element: the
    kernel sums each row in ascending slot order, index_add_ in another."""
    B, N, S, K, C = shape
    g, idx, act = _scatter_case(shape, cuda)
    launches = tga.onehot_scatter_add.launches
    got = tga.onehot_scatter_add(g, idx, act, N, sb=_sb(S))
    torch.cuda.synchronize()
    assert tga.onehot_scatter_add.launches == launches + 1
    ref = tga.onehot_scatter_add_plain(g, idx, N)
    bound = 1e-5 * (1 + tga.onehot_scatter_add_plain(g.abs(), idx, N))
    assert ((got - ref).abs() <= bound).all()


@pytest.mark.parametrize("shape", GATHER_SHAPES)
def test_onehot_scatter_add_kernel_deterministic(cuda, shape):
    """Two launches on the same inputs give the same bits, also where the
    backfill puts half of every centroid's slots on one row (the sum order
    is fixed by the inputs, not by the schedule)."""
    B, N, S, K, C = shape
    g, idx, act = _scatter_case(shape, cuda)
    first = tga.onehot_scatter_add(g, idx, act, N, sb=_sb(S))
    torch.cuda.synchronize()
    second = tga.onehot_scatter_add(g, idx, act, N, sb=_sb(S))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_grouped_gather_kernel_backward_matches_plain(cuda):
    """grouped_gather's gradient with the scatter-add kernel against the
    plain scatter-add, within 1e-5 * (1 + the sum of |contributions|)
    (summation order)."""
    src, idx = _gather_case(np.random.RandomState(3), 2, 512, 64, 96, 11, cuda)
    act = tga.pos_tile_activity(idx, 128, 512)
    ct = torch.randn(2, 64, 96, 11, device=cuda)
    grads = {}
    for bwd in ("xla", "pallas"):
        s = src.clone().requires_grad_(True)
        (tga.grouped_gather(s, idx, act, bwd=bwd) * ct).sum().backward()
        grads[bwd] = s.grad
    bound = 1e-5 * (1 + tga.onehot_scatter_add_plain(ct.abs(), idx, 512))
    assert ((grads["pallas"] - grads["xla"]).abs() <= bound).all()


def test_grouped_gather_kernel_backward_deterministic(cuda):
    """grouped_gather's backward through the scatter-add kernel gives the
    same gradient bits on two runs."""
    src, idx = _gather_case(np.random.RandomState(4), 2, 512, 64, 96, 11, cuda)
    act = tga.pos_tile_activity(idx, 128, 512)
    ct = torch.randn(2, 64, 96, 11, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(4))
    grads = []
    for _ in range(2):
        s = src.clone().requires_grad_(True)
        (tga.grouped_gather(s, idx, act, bwd="pallas") * ct).sum().backward()
        torch.cuda.synchronize()
        grads.append(s.grad)
    assert torch.equal(grads[0], grads[1])


# sa1's three scales and the regressor heads' two, each with its radius and K
DENSE_SCALES = [((32, 32, 64), 0.1, 32), ((64, 64, 128), 0.2, 64),
                ((64, 96, 128), 0.4, 128), ((128, 128, 256), 0.4, 64),
                ((128, 196, 256), 0.8, 128)]
DENSE_IDS = ["x".join(map(str, w)) for w, _, _ in DENSE_SCALES]


def _dense_case(rng, widths, device, B=2, S=64, N=2048):
    """A cloud with duplicated points, centroids on its first points but
    centroid 5 far away (an empty ball), and a random folded scale."""
    xyz = _cloud(rng, B, N, N * 3 // 4)
    new_xyz = xyz[:, :S].clone()
    new_xyz[:, 5] = 7.0
    return xyz.to(device), new_xyz.to(device), _folded(rng, B, S, N, widths, device)


@pytest.mark.parametrize("widths,radius,k", DENSE_SCALES, ids=DENSE_IDS)
def test_msg_dense_mask_kernels_match_plain(cuda, widths, radius, k):
    """K5 and K7 (one kernel) against the plain version on the mask of
    ``dense_selection_mask``, with a row that selects nothing (-1e30) and
    one that selects 1500 points. atol 1e-4: f32 sums in another order
    than cuBLAS."""
    rng = np.random.RandomState(widths[1] + k)
    xyz, new_xyz, folded = _dense_case(rng, widths, cuda)
    sel = tg.dense_selection_mask(tp.square_distance(new_xyz, xyz), radius, k)
    sel[:, 9] = 0.0
    sel[:, 11, torch.from_numpy(rng.choice(2048, 1500, replace=False)).to(cuda)] = 1.0
    ref = tg.dense_msg_scale_2d_plain(folded, sel)
    outs = []
    for op in (tg.dense_msg_scale_2d, tg.dense_msg_scale_2d_batched):
        launches = op.launches
        outs.append(op(folded, sel))
        torch.cuda.synchronize()
        assert op.launches == launches + 1
        torch.testing.assert_close(outs[-1], ref, atol=1e-4, rtol=0)
    assert torch.equal(outs[0], outs[1])
    assert (outs[0][:, 9] == -1e30).all()


@pytest.mark.parametrize("widths,radius,k", DENSE_SCALES, ids=DENSE_IDS)
def test_msg_dense_mask_kernels_bitwise_the_ball_kernel(cuda, widths, radius, k):
    """K5 and K7 given ``ball_selection_mask``'s mask: K4's bits. Both are
    modes of one kernel with one chain, and at these widths the mask mode
    takes the ball mode's layout (resident or streamed weights, rows of a
    row tile)."""
    rng = np.random.RandomState(widths[0] + k)
    xyz, new_xyz, folded = _dense_case(rng, widths, cuda)
    B, S, N = folded.v.shape[0], folded.v.shape[1], folded.u.shape[1]
    mask_plan, ball_plan = tg.ball_plan(widths, B, S, N, 0), tg.ball_plan(widths, B, S, N, k)
    assert (mask_plan["streamed"], mask_plan["rows"]) == (ball_plan["streamed"],
                                                          ball_plan["rows"])
    sel = tg.ball_selection_mask(xyz, new_xyz, radius, k)
    want = tg.fused_msg_scale(xyz, new_xyz, folded, radius, k)
    for op in (tg.dense_msg_scale_2d, tg.dense_msg_scale_2d_batched):
        got = op(folded, sel)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


def _overflow_mask(rng, B, S, N, device):
    """A 0/1 mask whose rows overflow a tile's row list: rows that select
    all N points and rows of a random 700-1,400 of them (each over a
    segment's rows at 32 centroids a CTA, so a centroid's rows span several
    passes), empty rows between them, the rest a random 0-40."""
    sel = np.zeros((B, S, N), np.float32)
    for b in range(B):
        for s in range(S):
            kind = (s + b) % 7
            n = (N if kind in (0, 4) else 0 if kind in (2, 5)
                 else rng.randint(700, 1400) if kind == 3 else rng.randint(0, 41))
            sel[b, s, rng.choice(N, n, replace=False)] = 1.0
    return torch.from_numpy(sel).to(device)


@pytest.mark.parametrize("widths,radius,k", DENSE_SCALES, ids=DENSE_IDS)
def test_msg_dense_mask_kernel_overflow_tiles_agree(cuda, widths, radius, k):
    """Masks whose rows overflow the list (whole rows, empty rows mixed in,
    rows spanning several passes): within 1e-4 of the plain version (-1e30
    where a row selects nothing), the same bits at every tile of 4 to 32
    centroids a CTA, on two launches, and from both wrappers."""
    rng = np.random.RandomState(widths[1] + widths[2])
    _, _, folded = _dense_case(rng, widths, cuda)
    B, S, N = folded.v.shape[0], folded.v.shape[1], folded.u.shape[1]
    sel = _overflow_mask(rng, B, S, N, cuda)
    assert tg.ball_plan(widths, B, S, N, 0, 32)["capacity"] < 700
    ref = tg.dense_msg_scale_2d_plain(folded, sel)
    outs = [tg._launch_mask("mask", folded, sel, tile=t) for t in (4, 8, 16, 32, 32)]
    outs += [tg.dense_msg_scale_2d(folded, sel), tg.dense_msg_scale_2d_batched(folded, sel)]
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], ref, atol=1e-4, rtol=0)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    empty = sel.sum(-1) == 0
    assert empty.any() and (outs[0][empty] == -1e30).all()
    assert (outs[0][~empty] >= 0).all()


@pytest.mark.parametrize("N", [203, 50001])
def test_msg_dense_mask_kernel_takes_any_n(cuda, N):
    """N not a multiple of 4 (the mask read a float at a time), and N = 50,001
    at the widest widths, over the 43,904 that the previous mask kernel's
    shared memory held (the mask mode's does not grow with N): within 1e-4
    of the plain version, an empty row -1e30."""
    rng = np.random.RandomState(N)
    widths = (128, 256, 256)
    B, S = 1, 8
    folded = _folded(rng, B, S, N, widths, cuda)
    sel = torch.from_numpy((rng.rand(B, S, N) < 0.3).astype(np.float32)).to(cuda)
    sel[:, 2] = 0.0
    sel[:, 5] = 1.0
    got = tg.dense_msg_scale_2d(folded, sel)
    ref = tg.dense_msg_scale_2d_plain(folded, sel, chunk=1)
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert (got[:, 2] == -1e30).all()


@pytest.mark.parametrize("widths,radius,k", DENSE_SCALES, ids=DENSE_IDS)
def test_msg_dense_ball_kernels_match_plain(cuda, widths, radius, k):
    """K4 and K6 (one kernel, equal outputs) against the plain version,
    atol 1e-4; the far centroid pools point 0's chain."""
    rng = np.random.RandomState(widths[2] + k)
    xyz, new_xyz, folded = _dense_case(rng, widths, cuda)
    ref = tg.dense_msg_scale_plain(xyz, new_xyz, folded, radius, k)
    outs = []
    for op in (tg.fused_msg_scale, tg.dense_msg_scale):
        launches = op.launches
        outs.append(op(xyz, new_xyz, folded, radius, k))
        torch.cuda.synchronize()
        assert op.launches == launches + 1
        torch.testing.assert_close(outs[-1], ref, atol=1e-4, rtol=0)
    assert torch.equal(outs[0], outs[1])
    one = tg.FoldedScale(folded.u[:, :1], *folded[1:])
    point0 = tg.dense_msg_scale_2d_plain(one, torch.ones_like(folded.v[..., :1]))
    torch.testing.assert_close(outs[0][:, 5], point0[:, 5], atol=1e-4, rtol=0)


def _on_radius_cloud(rng, radius, B=2, N=2048):
    """Centroid 0 at the origin with only points within a few ulps of its
    radius in f32 (x^2 + y^2 with some exactly radius^2), in random index
    order; every other point far from it."""
    r2 = np.float32(radius * radius)
    x0 = np.float32(radius / np.sqrt(2.0))
    steps = [np.float32(x0 + i * np.spacing(x0)) for i in range(-6, 7)]
    near = [(x, y) for x in steps for y in steps
            if abs(np.float32(x * x) + np.float32(y * y) - r2) <= 2 * np.spacing(r2)]
    assert any(np.float32(x * x) + np.float32(y * y) == r2 for x, y in near)
    xyz = rng.uniform(2 * radius + 0.1, 1.0, (B, N, 3)).astype(np.float32)
    xyz *= rng.choice([-1, 1], (B, N, 3))
    for b in range(B):
        at = rng.choice(np.arange(1, N), len(near), replace=False)
        xyz[b, at] = [[x, y, 0.0] for x, y in near]
    return torch.from_numpy(xyz)


def test_msg_dense_ball_kernel_exact_on_the_radius(cuda):
    """Points within two ulps of the radius, some exactly on it, in a ball
    that holds nothing else: the kernel selects the plain version's points
    (a flipped point changes the max of some channel by far more than 1e-4),
    and the plain selection on the card is the CPU's."""
    rng = np.random.RandomState(7)
    for radius, k in ((0.3, 8), (0.4, 64)):
        xyz = _on_radius_cloud(rng, radius)
        new_xyz = torch.zeros(2, 8, 3)
        new_xyz[:, 1:] = xyz[:, 1:8]
        sel = tg.ball_selection_mask(xyz, new_xyz, radius, k)
        assert (sel[:, 0].sum(-1) > 1).all()   # points in the ball, not the fallback
        xyz_d, new_xyz_d = xyz.to(cuda), new_xyz.to(cuda)
        assert torch.equal(tg.ball_selection_mask(xyz_d, new_xyz_d, radius, k).cpu(), sel)
        folded = _folded(rng, 2, 8, 2048, (64, 96, 128), cuda)
        folded = folded._replace(u=folded.u * 3)
        ref = tg.dense_msg_scale_plain(xyz_d, new_xyz_d, folded, radius, k)
        got = tg.fused_msg_scale(xyz_d, new_xyz_d, folded, radius, k)
        torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
        assert torch.equal(got, tg.dense_msg_scale(xyz_d, new_xyz_d, folded, radius, k,
                                                   sb=8))


def _ball_counts_case(rng, counts, widths, device, N=2048, radius=0.2, B=2):
    """Centroid s at (s, 0, 0) with counts[s] points (b's rows shuffled)
    inside its ball at random indices, every other point far from all
    centroids, and a random folded scale."""
    S = len(counts)
    new_xyz = np.zeros((B, S, 3), np.float32)
    new_xyz[..., 0] = np.arange(S, dtype=np.float32)
    xyz = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    xyz[..., 1:] += 5.0
    for b in range(B):
        order = rng.permutation(S)
        at = rng.permutation(N)
        used = 0
        for s in order:
            n = counts[s]
            d = rng.randn(n, 3)
            d *= (rng.uniform(0, 0.9 * radius, n) / np.linalg.norm(d, axis=1))[:, None]
            xyz[b, at[used:used + n]] = new_xyz[b, s] + d.astype(np.float32)
            used += n
    return (torch.from_numpy(xyz).to(device), torch.from_numpy(new_xyz).to(device),
            _folded(rng, B, S, N, widths, device))


# the ball kernel's layouts: rows of one centroid across a 64-row tile, full
# and empty balls in one tile of centroids, S not a multiple of the tile, N
# of 200 (nb = 8) and 8192, widths that are not multiples of 8 (or 4), and
# the padded (128, 196, 256); each (widths, N, nsample, counts)
BALL_CASES = {
    "across_tiles": ((64, 96, 128), 2048, 64, [70, 40, 40, 64, 63, 65, 1, 100] * 4),
    "full_and_empty": ((32, 32, 64), 2048, 32, [0, 32, 0, 200, 5, 0, 31, 33] * 4),
    "S37": ((64, 64, 128), 2048, 64, [0, 64, 13, 90, 30] * 7 + [64, 2]),
    "N200": ((24, 36, 52), 200, 16, [0, 16, 3, 40, 9, 17, 1, 0] * 2),
    "N8192": ((64, 96, 128), 8192, 128, [129, 0, 300, 64, 7, 128, 2, 500] * 4),
    "odd": ((13, 21, 37), 2048, 32, [0, 40, 31, 32, 5, 1, 33, 64] * 3),
    "padded": ((128, 196, 256), 2048, 128, [0, 128, 300, 64, 127, 129, 1, 200] * 2),
}


@pytest.mark.parametrize("case", list(BALL_CASES))
def test_msg_ball_kernel_layouts_match_plain(cuda, case):
    """K4 and K6 against the plain version at atol 1e-4 (3xTF32 products
    summed in another order than cuBLAS's f32), equal to each other, and
    bitwise equal on a second launch."""
    widths, N, k, counts = BALL_CASES[case]
    radius = 0.2
    rng = np.random.RandomState(len(case) + N)
    xyz, new_xyz, folded = _ball_counts_case(rng, counts, widths, cuda, N, radius)
    sel = tg.ball_selection_mask(xyz, new_xyz, radius, k)
    want = torch.tensor([min(c, k) or 1 for c in counts], device=cuda)
    assert torch.equal(sel.sum(-1).long(), want.expand(2, -1).long())
    ref = tg.dense_msg_scale_plain(xyz, new_xyz, folded, radius, k)
    got = tg.fused_msg_scale(xyz, new_xyz, folded, radius, k, sb=1, nb=8)
    again = tg.dense_msg_scale(xyz, new_xyz, folded, radius, k, sb=1, nb=8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    assert torch.equal(got, again)
    assert torch.equal(got, tg.fused_msg_scale(xyz, new_xyz, folded, radius, k, sb=1, nb=8))


@pytest.mark.parametrize("case", ["across_tiles", "S37", "padded"])
def test_msg_ball_kernel_tiles_agree(cuda, case):
    """Every tile of centroids a CTA (1 to 32) gives the same bits: a row's
    chain does not depend on the rows packed beside it, and the max is
    exact."""
    widths, N, k, counts = BALL_CASES[case]
    rng = np.random.RandomState(3)
    xyz, new_xyz, folded = _ball_counts_case(rng, counts, widths, cuda, N)
    outs = [tg._launch_ball("ball", xyz, new_xyz, folded, 0.2, k, tile=t)
            for t in (1, 4, 8, 16, 32)]
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    torch.testing.assert_close(
        outs[0], tg.dense_msg_scale_plain(xyz, new_xyz, folded, 0.2, k), atol=1e-4, rtol=0)


def test_msg_dense_wrappers_reject_what_they_cannot_take(cuda):
    rng = np.random.RandomState(1)
    xyz, new_xyz, folded = _dense_case(rng, (8, 8, 16), cuda, B=1, S=8, N=512)
    sel = torch.ones(1, 8, 512, device=cuda)
    for widths in ((129, 8, 16), (8, 257, 16), (8, 8, 257)):
        wide = _folded(rng, 1, 8, 512, widths, cuda)
        with pytest.raises(ValueError):
            tg.dense_msg_scale_2d(wide, sel)
        with pytest.raises(ValueError):
            tg.fused_msg_scale(xyz, new_xyz, wide, 0.2, 8)
    with pytest.raises(ValueError):   # mask of the wrong shape
        tg.dense_msg_scale_2d_batched(folded, sel[:, :4], sb=4)
    with pytest.raises(ValueError):   # float64 mask
        tg.dense_msg_scale_2d(folded, sel.double())
    with pytest.raises(ValueError):   # the mask on the CPU, u on the card
        tg.dense_msg_scale_2d(folded, sel.cpu())
    with pytest.raises(ValueError):   # xyz of the wrong shape
        tg.dense_msg_scale(xyz[..., :2], new_xyz, folded, 0.2, 8, sb=8)
    with pytest.raises(ValueError):   # centroids on the CPU
        tg.fused_msg_scale(xyz, new_xyz.cpu(), folded, 0.2, 8)


# --- the training step's bits run to run ------------------------------------
# The backwards of three_nn_interpolate (ops/pointnet._Interpolate3) and of
# the query heads' convolution (model/layers._ConvK3) sum in an order fixed
# by their inputs; tests/test_torch_determinism.py holds them to autograd
# and to JAX on the CPU.

def _gather_interpolate(points2, idx, weight):
    """three_nn_interpolate's weighted sum with torch.gather's own
    backward."""
    out = weight[..., 0:1] * tp.index_points(points2, idx[..., 0])
    for j in (1, 2):
        out = out + weight[..., j:j + 1] * tp.index_points(points2, idx[..., j])
    return out


def _twice(fn):
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return a, b


def test_step_backwards_deterministic(cuda):
    """At fp1's and the query heads' training shapes (B=8, N=2048): each
    backward twice gives the same bits, and stays within float32 rounding
    (1e-5 of the largest element) of the autograd backward it replaces."""
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(0)
    x1 = torch.rand(8, 2048, 3, device=cuda, generator=gen)
    x2 = torch.rand(8, 512, 3, device=cuda, generator=gen)
    p2 = torch.randn(8, 512, 128, device=cuda, generator=gen)
    g = torch.randn(8, 2048, 128, device=cuda, generator=gen)

    def interp():
        leaf = p2.clone().requires_grad_(True)
        tp.three_nn_interpolate(x1, x2, leaf).backward(g)
        return leaf.grad

    a, b = _twice(interp)
    assert torch.equal(a, b)
    leaf = p2.clone().requires_grad_(True)
    _gather_interpolate(leaf, *tp.three_nn(x1, x2)).backward(g)
    assert (a - leaf.grad).abs().max() <= 1e-5 * leaf.grad.abs().max()

    conv = tl.Conv1dK3(256, 256, device=cuda)
    with torch.no_grad():
        conv.weight.normal_(0.0, 256 ** -0.5, generator=gen)
        conv.bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(8, 2048, 256, device=cuda, generator=gen)
    gy = torch.randn(8, 2048, 256, device=cuda, generator=gen)

    def conv_grads():
        leaf = x.clone().requires_grad_(True)
        conv.zero_grad(set_to_none=True)
        conv(leaf).backward(gy)
        return torch.cat([leaf.grad.ravel(), conv.weight.grad.ravel(),
                          conv.bias.grad.ravel()])

    a, b = _twice(conv_grads)
    assert torch.equal(a, b)
    leaves = [t.detach().clone().requires_grad_(True) for t in (x, conv.weight, conv.bias)]
    F.conv1d(leaves[0].transpose(1, 2), leaves[1], leaves[2],
             padding=1).transpose(1, 2).backward(gy)
    want = torch.cat([t.grad.ravel() for t in leaves])
    n = x.numel()
    for sl in (slice(0, n), slice(n, -256), slice(-256, None)):
        assert (a[sl] - want[sl]).abs().max() <= 1e-5 * want[sl].abs().max()


def _train_batch(rng, B, N, width=346, height=260):
    """Raw windows and MANO ground truth like the JAX package's synthetic
    training batches."""
    def hand():
        return {k: (rng.randn(B, n) * 0.1).astype(np.float32)
                for k, n in (("global_orient", 3), ("hand_pose", 45),
                             ("shape", 10), ("trans", 3))} | {
            "valid": np.ones(B, np.float32)}

    t = np.sort(rng.randint(0, int(5e6), (B, N))).astype(np.float32)
    events = np.stack([rng.randint(0, width, (B, N)).astype(np.float32),
                       rng.randint(0, height, (B, N)).astype(np.float32), t,
                       rng.randint(0, 2, (B, N)).astype(np.float32)], axis=-1)
    return {"events": events, "labels": rng.randint(0, 4, (B, N)).astype(np.int32),
            "left": hand(), "right": hand(),
            "handedness": np.ones((B, 2), np.int32)}


def test_two_training_steps_bitwise_equal(cuda):
    """Two kernel-route training steps (make_train_step at full TEHNet
    width, B=2, N=2048, the one-hot gather and its scatter-add kernels)
    from the same weights and draws: every loss term, gradient, parameter
    after Adam and BatchNorm statistic bitwise equal."""
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.erpc import noise_draws, rasterize_erpc, resample_draws
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.weights import init_weights

    B, N = 2, 2048
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, fps_deterministic=True, pallas_gather=True,
        pallas_gather_bwd=True, dropout_classifier=0.0, dropout_query=0.0,
        dropout_regressor=0.0))
    state = init_weights(torch.Generator().manual_seed(0), cfg.model)
    hands = ttr.build_hands(cfg, synthetic=True, device=cuda)
    ctx = ttr.build_collision_context(hands)
    batch = _train_batch(np.random.RandomState(3), B, N)
    s = cfg.sensor
    _, _, n_valid = rasterize_erpc(torch.from_numpy(batch["events"]),
                                   torch.from_numpy(batch["labels"]), s.width, s.height)
    g = torch.Generator().manual_seed(4)
    noise = noise_draws(n_valid, N // 32, s.width, s.height, g)
    total = n_valid + torch.where(noise.gate, N // 32, 0).to(n_valid.dtype)
    draws = resample_draws(total, N, g)

    def run():
        net = TEHNet(cfg.model, device=cuda)
        net.load_state_dict(state, strict=True)
        opt = ttr.make_optimizer(net.parameters(), cfg.train)
        step = ttr.make_train_step(net, hands, ctx, cfg, opt, device=cuda)
        losses = step(batch, draws=draws, noise=noise)
        return (losses, {k: p.grad.clone() for k, p in net.named_parameters()},
                {k: v.clone() for k, v in net.state_dict().items()})

    (la, ga, sa), (lb, gb, sb) = _twice(run)
    assert la == lb
    assert la["loss_interpen"] > 0
    assert [k for k in ga if not torch.equal(ga[k], gb[k])] == []
    assert [k for k in sa if not torch.equal(sa[k], sb[k])] == []


# --- the training loop on the card ------------------------------------------

def test_resume_two_steps_bitwise_on_card(cuda, tmp_path):
    """The loop's resume on the card (full TEHNet width, B=2, N=2048, the
    gather and scatter-add kernels, the loop's seeded draws: random FPS
    starts, dropout, augmentation): two steps, a checkpoint, two more
    steps; a fresh model and Adam restored from the checkpoint on the card
    take the same two steps to the same bits in every parameter, BatchNorm
    statistic and Adam state tensor."""
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch.checkpoint import Checkpointer
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.model.tehnet import TEHNet
    from ev2hands_tpu_torch.weights import init_weights

    B, N = 2, 2048
    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(
        n_points=N, pallas_gather=True, pallas_gather_bwd=True))
    hands = ttr.build_hands(cfg, synthetic=True, device=cuda)
    ctx = ttr.build_collision_context(hands)
    rng = np.random.RandomState(5)
    batches = [_train_batch(rng, B, N) for _ in range(4)]

    def model():
        net = TEHNet(cfg.model, device=cuda)
        net.load_state_dict(init_weights(torch.Generator().manual_seed(0), cfg.model))
        opt = ttr.make_optimizer(net.parameters(), cfg.train)
        return net, opt, ttr.make_train_step(net, hands, ctx, cfg, opt, device=cuda)

    def run(step, its):
        for it in its:
            step(batches[it], ttr.seeded_generator(cfg.train.seed + 1, it, cuda))

    net, opt, step = model()
    run(step, (0, 1))
    ckptr = Checkpointer(str(tmp_path / "ckpt"))
    ckptr.save(2, net, opt)
    run(step, (2, 3))
    net2, opt2, step2 = model()
    assert ckptr.restore_into(net2, opt2)["step"] == 2
    run(step2, (2, 3))
    torch.cuda.synchronize()
    a, b = net.state_dict(), net2.state_dict()
    assert [k for k in a if not torch.equal(a[k], b[k])] == []
    sa, sb = opt.state_dict()["state"], opt2.state_dict()["state"]
    assert [(i, k) for i in sa for k in sa[i]
            if not torch.equal(sa[i][k], sb[i][k])] == []


def test_native_loader_through_the_prefetcher(cuda):
    """The loop's batch source (the native loader over rows in memory,
    through the Prefetcher) gives the loader's fill_random batches 0, 1, 2
    in order."""
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
    from ev2hands_tpu_torch.events.native_loader import NativeEv2HandSLoader
    from ev2hands_tpu_torch.events.streams import Prefetcher, synthetic_ev2hands_s

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=2048))
    rows, annotations = synthetic_ev2hands_s(n_events=65536, n_frames=16)
    source, name = ttr.open_train_source(cfg, (rows, annotations))
    assert name == "native"
    loader = NativeEv2HandSLoader.from_rows(rows, annotations, 2048, seed=cfg.train.seed)
    for step, batch in zip(range(3), Prefetcher(source)):
        want = loader.fill_batch(cfg.train.batch_size, step=step)
        for key in ("events", "labels", "handedness"):
            np.testing.assert_array_equal(batch[key], want[key])
        for side in ("left", "right"):
            for key, value in want[side].items():
                np.testing.assert_array_equal(batch[side][key], value)


# --- the serving export and the demo's rasterizer ----------------------------

def test_exported_program_launches_the_kernels_on_the_card(cuda):
    """Exported on the card at full width, the loaded program launches 3 FPS
    and 3 block-sparse grouping kernels a request and gives the live
    function's bits."""
    import tempfile

    from ev2hands_tpu_torch import export as tex
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch import weights as tw
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG
    from ev2hands_tpu_torch.model import tehnet as tt

    cfg = DEFAULT_CONFIG
    net = tt.TEHNet(cfg.model, device="cuda")
    net.load_state_dict(tw.init_weights(torch.Generator().manual_seed(0), cfg.model))
    hands = ttr.build_hands(cfg, synthetic=True, device="cuda")
    n_ev = 4096
    rng = np.random.RandomState(1)
    ev = np.stack([rng.randint(0, 346, (2, n_ev)), rng.randint(0, 260, (2, n_ev)),
                   np.sort(rng.uniform(0, 2, (2, n_ev))), rng.randint(0, 2, (2, n_ev))],
                  -1).astype(np.float32)
    inputs = (torch.from_numpy(ev).cuda(), torch.ones(2, n_ev, dtype=torch.bool).cuda(),
              torch.from_numpy(rng.rand(2, cfg.model.n_points)).cuda())
    with tempfile.TemporaryDirectory() as d:
        program = tex.export_serving(net, hands, cfg, 2, n_ev, path=f"{d}/s.pt2")
        loaded = tex.load_serving(f"{d}/s.pt2")
    assert tex.op_counts(program) == {"fps": 3, "msg_scale_sparse": 3}
    with torch.no_grad():
        live = tex.make_serving_fn(net, hands, cfg)(*inputs)
    launches = (tf.fps.launches, tg.msg_scale_sparse.launches)
    got = loaded(*inputs)
    torch.cuda.synchronize()
    assert (tf.fps.launches - launches[0], tg.msg_scale_sparse.launches - launches[1]) == (3, 3)
    for k, v in live.items():
        assert torch.equal(got[k], v), k


def test_rasterize_mesh_on_the_card_matches_cpu(cuda):
    """The card's rasterizer against the CPU's on the same vertices: class
    ids equal (ties to the lowest triangle on both), intensity and depth
    within 1e-5."""
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, SensorConfig
    from ev2hands_tpu_torch.datagen import rasterizer as tr
    from ev2hands_tpu_torch.train import build_hands

    W, H = 64, 48
    cfg = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H))
    hands = build_hands(cfg, synthetic=True, device="cpu")
    # both hands 0.4 m in front of the camera, 3 cm apart, in mm
    verts = torch.cat([hands["left"].v_template + torch.tensor([-0.03, 0.0, -0.4]),
                       hands["right"].v_template + torch.tensor([0.03, 0.0, -0.4])]) * 1e3
    n_f = len(hands["left"].faces)
    faces = torch.cat([hands["left"].faces, hands["right"].faces + 778])
    materials = torch.cat([torch.ones(n_f, dtype=torch.int32),
                           torch.full((n_f,), 2, dtype=torch.int32)])
    proj = torch.as_tensor(cfg.camera.projection_matrix(W, H), dtype=torch.float32)
    proj = proj * torch.tensor([[-1.0], [1.0], [1.0], [1.0]])
    ref = tr.rasterize_mesh(verts, faces, materials, proj, W, H)
    got = tr.rasterize_mesh(*(t.cuda() for t in (verts, faces, materials, proj)), W, H)
    assert torch.equal(got.class_id.cpu(), ref.class_id)
    torch.testing.assert_close(got.intensity.cpu(), ref.intensity, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.depth.cpu(), ref.depth, rtol=1e-5, atol=0)


# --- data generation on the card ---------------------------------------------

def _datagen_scene(W=64, H=48):
    """Both synthetic hands 0.45 m in front of the camera with forearms, as
    the generator's realistic scene lays them out."""
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG, SensorConfig
    from ev2hands_tpu_torch.datagen import generate as tg
    from ev2hands_tpu_torch.datagen import meshes as tm
    from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models

    cfg = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H))
    models = synthetic_mano_models(0)
    faces, materials, n_total, _ = tg.scene_topology(models["left"].faces, cfg)
    verts = []
    for side, x0 in (("left", -0.06), ("right", 0.06)):
        v = models[side].v_template + np.float32([x0, 0.0, -0.45])
        verts += [v, tm.forearm_mesh(v[0].astype(np.float64), np.array([0.0, -1.0, 0.2]))[0]]
    colors = tm.random_skin_vertex_colors(n_total, np.random.RandomState(0))
    return cfg, models, [torch.from_numpy(np.asarray(a)) for a in (
        np.concatenate(verts).astype(np.float32), faces, materials, colors,
        cfg.camera.projection_matrix(W, H).astype(np.float32))]


@pytest.mark.parametrize("W,H", [(64, 48), (346, 260)])
def test_rasterize_scene_on_the_card_matches_cpu(cuda, W, H):
    """The shaded rasteriser on the card against the CPU on the same scene
    and lights: class ids differ on at most 0.1% of the pixels, RGB within
    1e-5 and depth within rtol 1e-5 where they agree."""
    from ev2hands_tpu_torch.datagen import rasterizer as tr

    _, _, (verts, faces, materials, colors, proj) = _datagen_scene(W, H)
    lp, li = tr.sample_train_lights(torch.Generator().manual_seed(0))
    ref = tr.rasterize_scene(verts, faces, materials, colors, lp, li, proj, W, H)
    got = tr.rasterize_scene(*(t.to(cuda) for t in (verts, faces, materials, colors,
                                                    lp, li, proj)), W, H)
    cls = got.class_id.cpu()
    same = cls == ref.class_id
    assert (~same).float().mean().item() <= 1e-3
    assert (ref.class_id > 0).sum() > 100
    torch.testing.assert_close(got.rgb.cpu()[same], ref.rgb[same], rtol=0, atol=1e-5)
    torch.testing.assert_close(got.depth.cpu()[same], ref.depth[same], rtol=1e-5, atol=0)


@pytest.mark.parametrize("refractory_ns", [0.0, 0.35e6])
def test_esim_step_on_the_card_bitwise(cuda, refractory_ns):
    """esim_step on the card from the CPU's log frames: every compact field
    and every state tensor bitwise equal to the CPU's at each of 5 steps
    (plain IEEE arithmetic: any difference is a fault)."""
    from ev2hands_tpu_torch.ops import esim as te

    rng = np.random.RandomState(0)
    frames = torch.from_numpy(rng.randn(5, 260, 346).astype(np.float32) * 1.5)
    s_cpu, s_gpu = te.esim_init(260, 346, device="cpu"), te.esim_init(260, 346, device=cuda)
    for f in range(len(frames)):
        t = np.float32(f * 1e6)
        s_cpu, e_cpu = te.esim_step(s_cpu, frames[f], t, refractory_period_ns=refractory_ns)
        s_gpu, e_gpu = te.esim_step(s_gpu, frames[f].to(cuda), t,
                                    refractory_period_ns=refractory_ns)
        for a, b in zip((*e_cpu, *s_cpu), (*e_gpu, *s_gpu)):
            assert torch.equal(a, b.cpu())
    assert int(e_cpu.count.sum()) > 0


def test_simulate_sequence_on_the_card(cuda):
    """A 3-frame realistic sequence at 64x48 on the card and on the CPU with
    the same draws: a frame's event count within 1%, labels in {0, 1, 2},
    the same annotation entries."""
    from ev2hands_tpu_torch.datagen import generate as tg

    cfg, models, _ = _datagen_scene()
    frames = []
    for i in range(3):
        pose = np.zeros(48, np.float32)
        pose[:3] = [0, 0.2 * i / 3, 0]
        frames.append([{"hand_type": side, "pose": pose, "shape": np.zeros(10, np.float32),
                        "trans": np.float32([x0 + 0.01 * i, 0, -0.45])}
                       for side, x0 in (("left", -0.06), ("right", 0.06))])
    ref = list(tg.simulate_sequence(frames, models, cfg, seed=0, device="cpu"))
    got = list(tg.simulate_sequence(frames, models, cfg, seed=0, device=cuda))
    assert sum(len(f["events"]) for f in ref) > 100
    for a, b in zip(got, ref):
        assert abs(len(a["events"]) - len(b["events"])) <= 0.01 * len(b["events"])
        assert set(np.unique(a["event_labels"])) <= {0, 1, 2}
        for side in b["camera_hand_info"]:
            for k, v in b["camera_hand_info"][side].items():
                np.testing.assert_array_equal(a["camera_hand_info"][side][k], v)
