"""The ERPC event-window transform (Millerdurai et al., 3DV 2024) in plain
PyTorch.

Raw windows [B, N, 4] of (x, y, t in ns, polarity) become per-pixel rows
(x, y, mean t in ms, #positive, #negative) in row-major pixel order, each
labelled with the largest label of its events. Training appends n_out // 32
noise rows to windows whose gate fires; the rows are then resampled
uniformly with replacement to n_out and normalised (x, y by the sensor, t
by the window's min and max, the counts raw). A pixel's time sum is taken in
float64 and rounded once.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rasterize(events: torch.Tensor, labels: torch.Tensor, width: int, height: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (rows [B, N, 5] zero-padded, labels [B, N], occupied pixels [B])."""
    B, N, _ = events.shape
    dev = events.device
    pix = (events[..., 1].long() * width + events[..., 0].long())
    order = torch.argsort(pix * N + torch.arange(N, device=dev), dim=-1)
    pix_s = torch.gather(pix, 1, order)
    t_s = torch.gather(events[..., 2], 1, order).double()
    p_s = torch.gather(events[..., 3], 1, order)
    lab_s = torch.gather(labels.long(), 1, order)
    new = torch.ones((B, N), dtype=torch.long, device=dev)
    new[:, 1:] = (pix_s[:, 1:] != pix_s[:, :-1]).long()
    seg = torch.cumsum(new, -1) - 1
    flat = (seg + N * torch.arange(B, device=dev)[:, None]).reshape(-1)

    def seg_sum(v, dtype):
        return torch.zeros(B * N, dtype=dtype, device=dev).index_add_(
            0, flat, v.reshape(-1).to(dtype)).view(B, N)

    cnt = seg_sum(torch.ones_like(t_s), torch.float32)
    t_avg = (seg_sum(t_s, torch.float64).float() / torch.clamp(cnt, min=1.0)) * 1e-6
    pos = seg_sum((p_s == 1).float(), torch.float32)
    neg = seg_sum((p_s != 1).float(), torch.float32)
    lab = torch.zeros(B * N, dtype=torch.long, device=dev).scatter_reduce_(
        0, flat, lab_s.reshape(-1), reduce="amax", include_self=False).view(B, N)
    pid = torch.zeros(B * N, dtype=torch.long, device=dev).scatter_(
        0, flat, pix_s.reshape(-1)).view(B, N)
    valid = cnt > 0
    rows = torch.stack([(pid % width).float(), (pid // width).float(), t_avg, pos, neg], -1)
    rows = torch.where(valid[..., None], rows, 0.0)
    return rows, torch.where(valid, lab, 0), valid.sum(-1)


def noise_rows(rows, labels, n_valid, n_noise, width, height, g):
    """Append the noise augmentation's rows, drawn from ``g`` (gate, pixel
    x, pixel y, source row, t offset, polarity side, two counts, in that
    order) -> (rows, labels, noise count [B])."""
    B, dev = rows.shape[0], rows.device
    shape = (B, n_noise)

    def unit(dtype=torch.float32):
        return torch.rand(shape, generator=g, device=g.device, dtype=dtype).to(dev)

    def ints(high):
        high = torch.as_tensor(high, device=dev)
        return torch.minimum((unit(torch.float64) * high).long(), high - 1)

    gate = torch.rand((B,), generator=g, device=g.device).to(dev) < 0.5
    xs, ys = ints(width), ints(height)
    src = ints(torch.clamp(n_valid.long(), min=1)[:, None])
    t, ps = unit(), unit() < 0.5
    n_pe, n_ne = ints(8), ints(8)
    ts = torch.gather(rows[..., 2], 1, src) + t * 1e3
    psl = ps.long()
    new = torch.stack([xs.float(), ys.float(), ts, (n_pe + psl).float(),
                       (n_ne + 1 - psl).float()], -1)
    new = torch.where(gate[:, None, None], new, 0.0)
    new_labels = torch.where(gate[:, None], 3, 0).expand(-1, n_noise)
    count = torch.where(gate, n_noise, 0)
    return (torch.cat([rows, new], 1), torch.cat([labels, new_labels.to(labels.dtype)], 1),
            count)


def transform(events: torch.Tensor, labels: torch.Tensor, g, width: int, height: int,
              n_out: int, augment: bool = False, uniforms=None):
    """Raw windows -> (normalised ERPC clouds [B, n_out, 5], labels [B,
    n_out]); the draws come from ``g``, or the resample's from ``uniforms``
    [B, n_out] float64 (the generator's draws for these windows)."""
    rows, lab, n_valid = rasterize(events, labels, width, height)
    B, P = rows.shape[:2]
    n_noise = n_out // 32
    if augment:
        rows, lab, count = noise_rows(rows, lab, n_valid, n_noise, width, height, g)
    else:
        rows = torch.cat([rows, rows.new_zeros(B, n_noise, 5)], 1)
        lab = torch.cat([lab, lab.new_zeros(B, n_noise)], 1)
        count = torch.zeros_like(n_valid)
    total = torch.clamp((n_valid + count).long(), min=1)[:, None]
    u = uniforms if uniforms is not None else torch.rand(
        (B, n_out), generator=g, device=g.device, dtype=torch.float64)
    r = torch.minimum((u.to(total.device) * total).long(), total - 1)
    nv = n_valid.long()[:, None]
    idx = torch.where(r < nv, r, P + (r - nv))
    out = torch.gather(rows, 1, idx[..., None].expand(-1, -1, 5))
    x = 2.0 * (out[..., 0] / torch.full_like(out[..., 0], width)) - 1.0
    y = 2.0 * (out[..., 1] / torch.full_like(out[..., 1], height)) - 1.0
    t = out[..., 2]
    lo, hi = t.amin(-1, keepdim=True), t.amax(-1, keepdim=True)
    t = 2.0 * (t - lo) / torch.clamp(hi - lo, min=1e-9) - 1.0
    return torch.cat([torch.stack([x, y, t], -1), out[..., 3:]], -1), torch.gather(lab, 1, idx)
