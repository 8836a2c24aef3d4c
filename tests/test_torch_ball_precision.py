"""The arithmetic of the ball kernel's chain (``csrc/msg_ball.cu``),
emulated on the CPU.

The kernel runs both layers of the MSG chain on tensor cores in TF32 with
the 3xTF32 split: each operand ``a = hi + lo`` with ``hi`` rounded to TF32
to nearest with ties away from zero (the rule of ``cvt.rna.tf32.f32``) and
``lo = a - hi`` exactly in float32, of which the MMA reads the top 19 bits
(``lo`` truncated to TF32), and ``acc += lo * hi' + hi * lo' + hi * hi'`` in
float32, 8 input channels at a time (one m16n8k8 MMA step). A product of two
TF32 values is exact in float32, so float32 matrix products of the split
parts, summed in that order, emulate the kernel's products. Held against a
float64 chain at sa1's three widths and the regressor heads' two, the error
must stay at least 10x under the 1e-4 that the card tests and
``chip_smoke.py`` ask of the kernel; one TF32 product alone does not.
"""

import numpy as np
import pytest
import torch

# sa1's three scales and the regressor heads' two (C1, C2, C3)
WIDTHS = [(32, 32, 64), (64, 64, 128), (64, 96, 128), (128, 128, 256), (128, 196, 256)]
ROWS = 2048
TOL = 1e-4


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as the kernel does it: add half of the dropped
    13 bits' weight to the magnitude's bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` with the 13 bits below TF32's mantissa cleared."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, truncate(x - hi)


def pad8(t: torch.Tensor, dims) -> torch.Tensor:
    """Zero padding of the given dimensions to multiples of 8, as the kernel
    pads its widths."""
    pads = []
    for d in reversed(range(t.dim())):
        pads += [0, (-t.shape[d]) % 8 if d in dims else 0]
    return torch.nn.functional.pad(t, pads)


def mm_3xtf32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w as the kernel computes it: 8 channels a step, each step adding
    lo * hi', hi * lo', hi * hi' to a float32 accumulator."""
    ah, al = split(a)
    wh, wl = split(w)
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        acc = acc + al[:, s] @ wh[s]
        acc = acc + ah[:, s] @ wl[s]
        acc = acc + ah[:, s] @ wh[s]
    return acc


def chain(z, W2, b2, W3, b3, mm):
    """The chain on widths padded to multiples of 8 with zeros, as the
    kernel runs it, with the matrix product ``mm``."""
    h = torch.relu(mm(pad8(z, (1,)), pad8(W2, (0, 1))) + pad8(b2, (0,)))
    return torch.relu(mm(h, pad8(W3, (0, 1))) + pad8(b3, (0,)))[:, :W3.shape[1]]


def folded(rng, widths):
    """z = relu(u - v) of ROWS pairs and the weights of a folded scale,
    seeded and scaled as tests/test_torch_kernels.py's ``_folded``."""
    C1, C2, C3 = widths
    f = lambda *s, scale=1.0: torch.from_numpy((rng.randn(*s) * scale).astype(np.float32))
    z = torch.relu(f(ROWS, C1) - f(ROWS, C1, scale=0.5))
    return z, f(C1, C2, scale=C1 ** -0.5), f(C2, scale=0.1), f(C2, C3, scale=C2 ** -0.5), \
        f(C3, scale=0.1)


def test_tf32_rounding_is_round_half_away():
    """The integer rule against float64 arithmetic: random values, exact
    ties (either sign) and a carry into the exponent."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * np.exp2(rng.randint(-20, 20, 4096))).astype(np.float32)
    ties = np.float32([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 3 + 2.0 ** -10,
                       1 + 3 * 2.0 ** -11, 2 - 2.0 ** -12, 1 + 2.0 ** -11 - 2.0 ** -23])
    x = np.concatenate([x, ties, np.float32([0.0])])
    e = np.floor(np.log2(np.abs(x.astype(np.float64)), where=x != 0, out=np.zeros(x.size)))
    q = np.abs(x.astype(np.float64)) / np.exp2(e - 10)
    want = (np.sign(x) * np.floor(q + 0.5) * np.exp2(e - 10)).astype(np.float32)
    got = tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[-7:-1], np.float32(
        [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 3 + 2.0 ** -9, 1 + 2.0 ** -9, 2.0, 1.0]))


@pytest.mark.parametrize("widths", WIDTHS, ids=["x".join(map(str, w)) for w in WIDTHS])
def test_3xtf32_chain_within_a_tenth_of_the_tolerance(widths):
    z, W2, b2, W3, b3 = folded(np.random.RandomState(sum(widths)), widths)
    ref = chain(z.double(), W2.double(), b2.double(), W3.double(), b3.double(),
                lambda a, w: a @ w)
    got = chain(z, W2, b2, W3, b3, mm_3xtf32)
    one = chain(z, W2, b2, W3, b3, lambda a, w: tf32(a) @ tf32(w))
    err = (got.double() - ref).abs().max().item()
    assert err <= TOL / 10, f"3xTF32 chain off by {err}"
    assert (one.double() - ref).abs().max().item() > TOL   # why the split
