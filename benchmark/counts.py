"""The yardstick's arithmetic: the H100's peaks, the published algorithm's
operations per window, and the block-sparse grouping kernel's operations
and bytes.

Operations are the published algorithm's, counted from the configuration's
widths, so they read the same whatever implements them: a multi-scale
layer feeds each centroid's K ball-query slots (S x K pairs, backfilled
slots included, as the published ball query feeds its convs) through its
conv chain; every 1x1 conv, k=3 conv, linear layer and attention product
counts 2 operations a multiply-add. FPS, ERPC, BatchNorm, the pooling, the
elementwise work and MANO (under 0.1% of a window) are not counted.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit
PEAKS = {
    "tf32_flop_per_s": 495e12,    # tensor cores, one TF32 product an f32 operation
    "f32_flop_per_s": 67e12,      # CUDA cores, outside the tensor cores
    "hbm_byte_per_s": 3.35e12,
}


def chain_flops(cin: int, widths: Sequence[int]) -> int:
    """Operations of one row through a chain of pointwise layers."""
    total, last = 0, cin
    for w in widths:
        total += 2 * last * w
        last = w
    return total


def msg_flops(npoint: int, nsamples: Sequence[int], cin: int,
              mlps: Sequence[Sequence[int]]) -> int:
    """A multi-scale layer: S x K pairs of [features, xyz] a scale."""
    return sum(npoint * k * chain_flops(cin + 3, mlp) for k, mlp in zip(nsamples, mlps))


def forward_flops(model: Dict) -> int:
    """Operations of one window's forward pass of the configuration's
    TEHNet (``model`` is the configuration file's 'model' group)."""
    n = model["n_points"]
    c_in = 5 if model["erpc"] else 4
    sa1 = msg_flops(512, (32, 64, 128), c_in, ((32, 32, 64), (64, 64, 128), (64, 96, 128)))
    sa2 = msg_flops(128, (64, 128), 320, ((128, 128, 256), (128, 196, 256)))
    sa3 = 128 * chain_flops(512 + 3, (256, 512, 1024))
    fp = (128 * chain_flops(512 + 1024, (256, 256)) + 512 * chain_flops(320 + 256, (256, 128))
          + n * chain_flops(128, (128, 128, 256)))
    classifier = n * chain_flops(256, (256, model["num_classes"]))
    queries = 2 * n * 2 * (2 * 3 * 256 * 256)
    attention = 2 * 2 * (2 * n * model["num_classes"] * 256)
    head = (msg_flops(128, (64, 128), model["num_classes"], ((128, 128, 256), (128, 196, 256)))
            + 128 * chain_flops(512 + 3, (256, 512)) + chain_flops(512, (1024, 22)))
    return sa1 + sa2 + sa3 + fp + classifier + queries + attention + 2 * head


def train_flops(model: Dict) -> int:
    """A training step's operations a window: forward and backward, three
    times the forward."""
    return 3 * forward_flops(model)


# sa1's scales: (radius, K, (C1, C2, C3)) with the layer's S and N
SA1_SCALES: Tuple[Tuple[float, int, Tuple[int, int, int]], ...] = (
    (0.1, 32, (32, 32, 64)), (0.2, 64, (64, 64, 128)), (0.4, 128, (64, 96, 128)))


def sparse_pair_flops(widths: Tuple[int, int, int]) -> int:
    """The block-sparse kernel's operations a selected pair: the pair's
    first layer is a difference of per-point and per-centroid rows made
    before the kernel, so the kernel's products are layers 2 and 3."""
    c1, c2, c3 = widths
    return 2 * (c1 * c2 + c2 * c3)


def sparse_bytes(B: int, S: int, N: int, nb: int, fused: bool,
                 scales=SA1_SCALES) -> int:
    """Bytes the sa1 grouping needs, each input read once and each output
    written once, float32 and int32: per-point rows u [B, N, C1], centroid
    rows v [B, S, C1], the selection masks [B, S, N], the tile activity
    [B, S, N / nb], the folded weights and biases of layers 2 and 3, the
    pooled output [B, S, C3]. One launch a scale shares nothing; the fused
    launch reads one activity map for all scales."""
    def weights(c1, c2, c3):
        return c1 * c2 + c2 + c2 * c3 + c3

    act = B * S * (N // nb)
    total = 0
    for _, _, (c1, c2, c3) in scales:
        total += B * N * c1 + B * S * c1 + B * S * N + weights(c1, c2, c3) + B * S * c3
        if not fused:
            total += act
    if fused:
        total += act
    return 4 * total


def roofline_seconds(flops: float, nbytes: float) -> float:
    """The least time on the card: operations at the TF32 tensor-core
    peak or bytes at the HBM rate, whichever is longer."""
    return max(flops / PEAKS["tf32_flop_per_s"], nbytes / PEAKS["hbm_byte_per_s"])
