"""The training step's backward sums in an order fixed by its inputs.

Two ops of the step had backwards that add with atomics on the card, in
an order that changes from run to run: the gather of
``three_nn_interpolate`` (fp1, fp2) and cuDNN's backward of the query
heads' k=3 convolution. Each now has a backward of its own
(``ops/pointnet._Interpolate3``, ``model/layers._ConvK3``). On the CPU
each is held, in float64 on seeded inputs, against the autograd gradient
of the plain op it replaces and against ``jax.vjp`` of the JAX package's
function. On the card, ``tests/test_torch_kernels.py`` runs each twice at
the training step's shapes, and two whole training steps, for the same
bits.

On the CPU the collision term's gathers (advanced indexing, whose
backward ``index_put`` accumulates with atomics across threads there) take
rows with ``ops/collision.take_rows`` (``torch.gather`` on the CPU, whose
backward sums each row serially): its gradients are held for the same
bits run to run.
"""

import os

import flax.linen as fnn
import jax
import numpy as np
import torch
import torch.nn.functional as F

from ev2hands_tpu.ops import pointnet as jp
from ev2hands_tpu_torch.mano.model_data import synthetic_mano_models
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.ops import collision as tc
from ev2hands_tpu_torch.ops import pointnet as tp

# float64 on both sides; the sums run in other orders (a matrix product
# against a gather's scatter, XLA's convolution against cuDNN's or the
# CPU's), so agreement is to rounding: rtol 1e-10 of the largest element
RTOL = 1e-10


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= RTOL * scale, what


def _jax_vjp(f, args, cotangent):
    """(f(*args), its vjp of ``cotangent``), in one jit."""
    def both(args, cotangent):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(cotangent)
    return jax.jit(both)(args, cotangent)


def _interp_case(rng, B=2, N=40, S=12, D=5):
    return (rng.rand(B, N, 3), rng.rand(B, S, 3), rng.randn(B, S, D),
            rng.randn(B, N, D))


def _plain_interpolate(points2, idx, weight):
    """The gather formulation with autograd's own backward."""
    out = weight[..., 0:1] * tp.index_points(points2, idx[..., 0])
    for j in (1, 2):
        out = out + weight[..., j:j + 1] * tp.index_points(points2, idx[..., j])
    return out


def test_interpolate3_backward_matches_autograd_and_jax():
    """three_nn_interpolate's gradients to xyz1, xyz2 and points2 against
    the gather formulation's autograd gradients and jax.vjp of the JAX
    package's three_nn_interpolate (its dense-weight product), float64."""
    x1, x2, p2, g = _interp_case(np.random.RandomState(0))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x1, x2, p2)]
    out = tp.three_nn_interpolate(*leaves)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    plain_leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x1, x2, p2)]
    plain = _plain_interpolate(plain_leaves[2], *tp.three_nn(*plain_leaves[:2]))
    assert torch.equal(out.detach(), plain.detach())   # the same forward
    want = torch.autograd.grad(plain, plain_leaves, torch.from_numpy(g))

    with jax.enable_x64(True):
        ref, ref_grads = _jax_vjp(jp.three_nn_interpolate, (x1, x2, p2), g)
    _close(out.detach().numpy(), ref, "forward vs JAX")
    for name, a, b, c in zip(("xyz1", "xyz2", "points2"), got, want, ref_grads):
        _close(a.numpy(), b.numpy(), f"{name} vs autograd")
        _close(a.numpy(), c, f"{name} vs jax.vjp")
    assert np.abs(got[2].numpy()).max() > 0


def test_conv_k3_backward_matches_autograd_and_jax():
    """Conv1dK3's gradients to its input, weight and bias against
    F.conv1d's autograd gradients and jax.vjp of the JAX package's query
    conv (flax Conv, kernel 3, SAME), float64, with zero padding at both
    ends of the point axis exercised."""
    rng = np.random.RandomState(1)
    B, N, C, O = 2, 17, 6, 5
    x, w, b, g = (rng.randn(B, N, C), rng.randn(O, C, 3), rng.randn(O),
                  rng.randn(B, N, O))
    conv = tl.Conv1dK3(C, O, device="cpu").double()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = conv(xt)
    got = torch.autograd.grad(out, [xt, conv.weight, conv.bias], torch.from_numpy(g))

    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    plain = F.conv1d(leaves[0].transpose(1, 2), leaves[1], leaves[2],
                     padding=1).transpose(1, 2)
    assert torch.equal(out.detach(), plain.detach())
    want = torch.autograd.grad(plain, leaves, torch.from_numpy(g))

    layer = fnn.Conv(O, kernel_size=(3,), padding="SAME")
    with jax.enable_x64(True):
        def f(x, kernel, bias):
            return layer.apply({"params": {"kernel": kernel, "bias": bias}}, x)

        ref, (gx, gk, gb) = _jax_vjp(f, (x, np.transpose(w, (2, 1, 0)), b), g)
    _close(out.detach().numpy(), ref, "forward vs JAX")
    ref_grads = (gx, np.transpose(np.asarray(gk), (2, 1, 0)), gb)
    for name, a, bb, c in zip(("x", "weight", "bias"), got, want, ref_grads):
        assert a.shape == bb.shape, name
        _close(a.numpy(), bb.numpy(), f"{name} vs autograd")
        _close(a.numpy(), c, f"{name} vs jax.vjp")


def test_collision_loss_backward_same_bits_on_cpu():
    """The collision loss's vertex gradients on the CPU (float32, B=2, the
    synthetic hands overlapping, T = 3076 triangles, every thread of the
    host) give the same bits in ten runs (through plain advanced indexing
    about seven runs in ten differ from the first), and match the gradients with the
    triangles gathered by plain advanced indexing to float32 rounding."""
    models = synthetic_mano_models(0)
    faces = tc.build_two_hand_faces(models["left"].faces, models["right"].faces)
    adj = torch.from_numpy(tc.build_adjacency_mask(faces))
    faces = torch.from_numpy(faces)
    rng = np.random.RandomState(9)
    vl = (models["left"].v_template[None] + 0.01 * rng.randn(2, 778, 3)).astype(np.float32)
    vr = (models["right"].v_template[None] + 0.01 * rng.randn(2, 778, 3)).astype(np.float32)

    def grads(loss_fn):
        leaves = [torch.from_numpy(v).requires_grad_(True) for v in (vl, vr)]
        loss_fn(*leaves).backward()
        return torch.cat([leaf.grad.ravel() for leaf in leaves])

    threads = torch.get_num_threads()
    torch.set_num_threads(max(4, os.cpu_count()))
    try:
        runs = [grads(lambda a, b: tc.collision_loss(a, b, faces, adj)) for _ in range(10)]
    finally:
        torch.set_num_threads(threads)
    assert runs[0].abs().max() > 0
    assert all(torch.equal(runs[0], r) for r in runs[1:])

    def indexed(a, b):
        tris = torch.cat([a, b], dim=1)[:, faces]
        cp = tc.find_collision_pairs(tris.detach(), adj, 128)
        pen = tc.penetration_penalty(tris, cp.pairs, cp.intersecting)
        return pen.sum() / (pen > 0).sum().to(pen.dtype) * 1e2

    want = grads(indexed)
    assert (runs[0] - want).abs().max() <= 1e-5 * want.abs().max()
