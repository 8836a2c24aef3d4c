"""The yardstick's operation and byte counts against hand sums and
against a count of the reference's own products."""

import pytest
import torch

import counts


def test_chain_and_msg_by_hand():
    assert counts.chain_flops(3, (4, 5)) == 2 * (3 * 4 + 4 * 5)
    # 2 centroids x 3 slots, [1 feature, xyz] -> 4 -> 4
    assert counts.msg_flops(2, (3,), 1, ((4, 4),)) == 2 * 3 * 2 * (4 * 4 + 4 * 4)


def test_sparse_counts_by_hand():
    scales = ((0.1, 2, (2, 3, 4)), (0.2, 4, (1, 2, 2)))
    B, S, N, nb = 1, 2, 8, 4
    act = B * S * (N // nb)
    per = [B * N * c1 + B * S * c1 + B * S * N + (c1 * c2 + c2 + c2 * c3 + c3) + B * S * c3
           for _, _, (c1, c2, c3) in scales]
    assert counts.sparse_bytes(B, S, N, nb, False, scales) == 4 * (sum(per) + 2 * act)
    assert counts.sparse_bytes(B, S, N, nb, True, scales) == 4 * (sum(per) + act)
    assert counts.sparse_pair_flops((2, 3, 4)) == 2 * (2 * 3 + 3 * 4)


def test_roofline_takes_the_longer_bound():
    p = counts.PEAKS
    assert counts.roofline_seconds(p["tf32_flop_per_s"], 0) == pytest.approx(1.0)
    assert counts.roofline_seconds(0, 2 * p["hbm_byte_per_s"]) == pytest.approx(2.0)


def test_forward_flops_count_the_reference_products(monkeypatch):
    """Every product the reference computes for one window, counted where
    it is made, sums to ``forward_flops``: the published ball query feeds
    S x K pairs to each scale's convs."""
    from reference import model, ops

    seen = []
    linear, conv_k3 = ops.linear, ops.conv_k3

    def count_linear(x, w, b):
        seen.append(2 * x[..., 0].numel() * w.shape[0] * w[0].numel())
        return linear(x, w, b)

    def count_conv(x, w, b):
        seen.append(2 * x[..., 0].numel() * w.numel())
        return conv_k3(x, w, b)

    einsum = torch.einsum

    def count_einsum(eq, a, b):
        out = einsum(eq, a, b)
        if eq in ("bnk,bnc->bkc", "bkc,bnc->bnk"):
            seen.append(2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[-1]
                        if eq == "bnk,bnc->bkc" else 2 * out.numel() * a.shape[2])
        return out

    monkeypatch.setattr(ops, "linear", count_linear)
    monkeypatch.setattr(ops, "conv_k3", count_conv)
    monkeypatch.setattr(model.torch, "einsum", count_einsum)
    n = 256
    P = model.init_state(1, "cpu")
    events = torch.rand(1, n, 5) * 2 - 1
    with torch.no_grad():
        model.Net(P)(events)
    assert sum(seen) == counts.forward_flops({"n_points": n, "erpc": True, "num_classes": 4})


def test_forward_flops_at_the_published_size():
    """About 19.8 GFLOP a window at N = 2048 (sa1's S x K pairs)."""
    f = counts.forward_flops({"n_points": 2048, "erpc": True, "num_classes": 4})
    assert 19.7e9 < f < 19.9e9
    assert counts.train_flops({"n_points": 2048, "erpc": True, "num_classes": 4}) == 3 * f
