"""ERPC event-window transform in PyTorch, batched.

Counterpart of ``ev2hands_tpu/events/erpc.py``: raw windows [B, N, 4] =
(x, y, t, p) are rasterised into per-pixel ERPC rows (x, y, mean t in ms,
#positive, #negative) in row-major pixel order, optionally augmented with
``n_out // 32`` noise rows (training), resampled uniformly with replacement
to ``n_out`` rows, and normalised (x, y by sensor size, t by the window's
min/max; the counts stay raw). A pixel's label is the largest label of its
events. Every random draw comes from a ``torch.Generator`` or is given, so
a test can hand the port the JAX package's draws. Real recordings
(``erpc_real_batch_transform``) come as padded windows with a validity
mask, timestamps in ms and no labels. ``erpc_preraster_batch_transform``
takes rows already rasterised, and ``raw_window_transform`` is the
4-channel input of ``ModelConfig(erpc=False)``, with no rasterisation.

Device independence: the per-pixel time sum is taken in float64, exact for
float32 inputs, and rounded once, so the CPU and the card give the same
bits whatever order the card's atomics add in. The JAX package sums in
float32 in event order, which can differ from it in the last place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ev2hands_tpu_torch.parallel.mesh import global_rand


class ErpcWindow(NamedTuple):
    events: torch.Tensor  # [B, n_out, 5] normalised ERPC cloud
    labels: torch.Tensor  # [B, n_out] int32 per-event class labels


def rasterize_erpc(
    events: torch.Tensor,   # [B, N, 4] float32: x, y, t, p (1 / not 1)
    labels: torch.Tensor,   # [B, N] int
    width: int,
    height: int,
    time_scale: float = 1e-6,   # ns -> ms; 1.0 for timestamps in ms
    event_valid: Optional[torch.Tensor] = None,   # [B, N] bool: real events
    max_pixels: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (feats [B, P, 5], pixel_labels [B, P] int32, n_valid [B] int32):
    the first P = ``max_pixels`` (default N) occupied pixels of each window
    in row-major order, zero-padded. Events that ``event_valid`` marks as
    padding go to a dummy pixel past the sensor and are dropped.

    Events are sorted by the packed key pixel * 2^ceil(log2 N) + index (ties
    keep event order), runs of equal pixel become rows."""
    B, N, _ = events.shape
    P = N
    num_pixels = width * height
    dev = events.device
    shift = 1
    while shift < N:
        shift *= 2
    if (num_pixels + 1) * shift >= 2 ** 31:
        raise ValueError(f"{num_pixels} pixels x N={N} overflow the int32 sort key")

    x = events[..., 0].to(torch.int32)
    y = events[..., 1].to(torch.int32)
    pix = y * width + x
    if event_valid is not None:
        pix = torch.where(event_valid.to(dev), pix, num_pixels)  # sorts last
    packed = pix * shift + torch.arange(N, dtype=torch.int32, device=dev)
    spacked = torch.sort(packed, dim=-1).values
    perm = (spacked & (shift - 1)).long()
    pix_s = spacked // shift

    t_s = torch.gather(events[..., 2], 1, perm)
    p_s = torch.gather(events[..., 3], 1, perm)
    lab_s = torch.gather(labels.to(torch.float32), 1, perm)

    new_seg = torch.ones((B, N), dtype=torch.int32, device=dev)
    new_seg[:, 1:] = (pix_s[:, 1:] != pix_s[:, :-1]).to(torch.int32)
    seg_id = torch.cumsum(new_seg, dim=-1) - 1          # [B, N] in [0, N)
    gid = (seg_id + P * torch.arange(B, device=dev)[:, None]).reshape(-1)

    def seg_sum(vals, dtype=torch.float32):
        out = torch.zeros(B * P, dtype=dtype, device=dev)
        return out.index_add_(0, gid, vals.reshape(-1).to(dtype)).view(B, P)

    t_sum = seg_sum(t_s, torch.float64).to(torch.float32)
    pos_sum = seg_sum((p_s == 1).to(torch.float32))
    neg_sum = seg_sum((p_s != 1).to(torch.float32))
    cnt = seg_sum(torch.ones_like(t_s))
    lab = torch.zeros(B * P, dtype=torch.float32, device=dev).scatter_reduce_(
        0, gid, lab_s.reshape(-1), reduce="amax", include_self=False
    ).view(B, P)
    # every event of a run has the run's pixel id: a plain scatter suffices
    pid = torch.full((B * P,), -1, dtype=torch.int32, device=dev).scatter_(
        0, gid, pix_s.reshape(-1)).view(B, P)

    valid = (cnt > 0) & (pid >= 0) & (pid < num_pixels)
    pid_safe = torch.clamp(pid, 0, num_pixels - 1)
    t_avg_ms = (t_sum / torch.clamp(cnt, min=1.0)) * time_scale
    feats = torch.stack(
        [
            (pid_safe % width).to(torch.float32),
            (pid_safe // width).to(torch.float32),
            t_avg_ms,
            pos_sum,
            neg_sum,
        ],
        dim=-1,
    )
    feats = torch.where(valid[..., None], feats, 0.0)
    pixel_labels = torch.where(valid, lab.to(torch.int32), 0)
    if max_pixels is not None and max_pixels < N:
        # the first max_pixels pixel runs, as the reference's nonzero slice
        feats, pixel_labels, valid = (
            feats[:, :max_pixels], pixel_labels[:, :max_pixels], valid[:, :max_pixels])
    n_valid = valid.sum(dim=-1, dtype=torch.int32)
    return feats, pixel_labels, n_valid


def sample_fixed(
    feats: torch.Tensor,     # [B, P, 5]; valid rows [0, n_valid)
    labels: torch.Tensor,    # [B, P]
    n_valid: torch.Tensor,   # [B]
    noise_base: int,         # first noise row
    draws: torch.Tensor,     # [B, n_out] ints in [0, max(n_valid + n_noise, 1))
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform with-replacement resample over the valid pixel rows and the
    noise rows after them, from the given draws."""
    r = draws.long()
    nv = n_valid.long()[:, None]
    idx = torch.where(r < nv, r, noise_base + (r - nv))
    out = torch.gather(feats, 1, idx[..., None].expand(-1, -1, feats.shape[-1]))
    return out, torch.gather(labels, 1, idx)


def normalize_erpc(feats: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """x, y -> [-1, 1] by sensor size; t -> [-1, 1] by the window's min/max;
    the other columns (the ERPC polarity counts, or a raw event's polarity)
    stay raw. feats [B, n, C], C >= 3.

    The sensor size is divided as a tensor: PyTorch's CUDA division by a
    Python scalar multiplies by the reciprocal, one ulp off the CPU's true
    division."""
    x = 2.0 * (feats[..., 0] / torch.full_like(feats[..., 0], width)) - 1.0
    y = 2.0 * (feats[..., 1] / torch.full_like(feats[..., 1], height)) - 1.0
    t = feats[..., 2]
    t_min = torch.amin(t, dim=-1, keepdim=True)
    t_max = torch.amax(t, dim=-1, keepdim=True)
    t = 2.0 * (t - t_min) / torch.clamp(t_max - t_min, min=1e-9) - 1.0
    return torch.cat([torch.stack([x, y, t], dim=-1), feats[..., 3:]], dim=-1)


def draws_from_uniforms(uniforms: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """[B, n_out] float64 uniforms in [0, 1) -> [B, n_out] resample indices
    in [0, max(n_valid, 1)), on ``n_valid``'s device: ``floor(u * total)``,
    clamped below ``total``."""
    total = torch.clamp(n_valid.long(), min=1)[:, None]
    r = (uniforms.to(total.device) * total).long()
    return torch.minimum(r, total - 1)


def resample_draws(n_valid: torch.Tensor, n_out: int,
                   generator: torch.Generator, mesh=None) -> torch.Tensor:
    """[B, n_out] uniform draws in [0, max(n_valid, 1)) from ``generator``
    (on its own device), returned on ``n_valid``'s device:
    ``draws_from_uniforms`` of the generator's float64 uniforms. Under a
    data mesh (``parallel.mesh``) the uniforms are drawn at the global
    batch's shape and this rank's rows kept."""
    u = global_rand((n_valid.shape[0], n_out), generator, mesh, dtype=torch.float64)
    return draws_from_uniforms(u, n_valid)


def _resample_indices(total: torch.Tensor, n_out: int,
                      generator: Optional[torch.Generator],
                      draws: Optional[torch.Tensor],
                      uniforms: Optional[torch.Tensor], what: str,
                      mesh=None) -> torch.Tensor:
    """The resample indices over ``total`` [B] rows: ``draws`` as given,
    else from ``uniforms``, else from ``generator``; on ``total``'s
    device."""
    if draws is None:
        if uniforms is not None:
            draws = draws_from_uniforms(uniforms, total)
        elif generator is not None:
            draws = resample_draws(total, n_out, generator, mesh)
        else:
            raise ValueError(f"{what}: pass a generator, uniforms or draws")
    B = total.shape[0]
    if tuple(draws.shape) != (B, n_out):
        raise ValueError(f"draws must be [{B}, {n_out}], got {tuple(draws.shape)}")
    return draws.to(total.device)


class NoiseDraws(NamedTuple):
    """The draws of the noise augmentation, per window (n = n_out // 32)."""

    gate: torch.Tensor   # [B] bool: the augmentation fires
    xs: torch.Tensor     # [B, n] ints in [0, width)
    ys: torch.Tensor     # [B, n] ints in [0, height)
    src: torch.Tensor    # [B, n] ints in [0, max(n_valid, 1)): row whose t is copied
    t: torch.Tensor      # [B, n] float32 in [0, 1): t offset / 1e3 ms
    ps: torch.Tensor     # [B, n] bool: the +1 goes to the positive count
    n_pe: torch.Tensor   # [B, n] ints in [0, 8): positive count
    n_ne: torch.Tensor   # [B, n] ints in [0, 8): negative count


def _uniform_ints(high: torch.Tensor, shape, generator, mesh=None) -> torch.Tensor:
    """Ints uniform in [0, high) with ``high`` broadcast over ``shape``."""
    u = global_rand(shape, generator, mesh, dtype=torch.float64).to(high.device)
    return torch.minimum((u * high).long(), high - 1)


def noise_draws(n_valid: torch.Tensor, n_noise: int, width: int, height: int,
                generator: torch.Generator, mesh=None) -> NoiseDraws:
    """NoiseDraws from ``generator`` (on its own device), on ``n_valid``'s
    device; under a data mesh, this rank's rows of the global batch's."""
    B = n_valid.shape[0]
    dev = n_valid.device
    shape = (B, n_noise)

    def ints(high):
        return _uniform_ints(torch.as_tensor(high, device=dev), shape, generator, mesh)

    def unit():
        return global_rand(shape, generator, mesh).to(dev)

    return NoiseDraws(
        gate=global_rand((B,), generator, mesh).to(dev) < 0.5,
        xs=ints(width), ys=ints(height),
        src=ints(torch.clamp(n_valid.long(), min=1)[:, None]),
        t=unit(), ps=unit() < 0.5, n_pe=ints(8), n_ne=ints(8))


def append_noise(feats: torch.Tensor, labels: torch.Tensor,
                 noise: NoiseDraws) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Append the noise rows after the P pixel rows -> (feats [B, P + n, 5],
    labels [B, P + n], noise_count [B]). A window whose gate fires gets
    rows labelled 3: a random pixel, the t of a random valid row plus
    U[0, 1) * 1e3 ms, polarity counts randint(0, 8) with a +1 on one side;
    the others get zero rows labelled 0 and count no noise."""
    n = noise.xs.shape[1]
    ts = torch.gather(feats[..., 2], 1, noise.src.long()) + noise.t * 1e3
    ps = noise.ps.long()
    rows = torch.stack([
        noise.xs.to(feats.dtype), noise.ys.to(feats.dtype), ts,
        (noise.n_pe.long() + ps).to(feats.dtype),
        (noise.n_ne.long() + 1 - ps).to(feats.dtype),
    ], dim=-1)
    gate = noise.gate.to(feats.device)
    rows = torch.where(gate[:, None, None], rows, 0.0)
    noise_labels = torch.where(gate[:, None], 3, 0).to(labels.dtype).expand(-1, n)
    count = torch.where(gate, n, 0).to(torch.int32)
    return (torch.cat([feats, rows], dim=1),
            torch.cat([labels, noise_labels], dim=1), count)


def erpc_preraster_batch_transform(
    feats: torch.Tensor,     # [B, P, 5] ERPC rows: x, y, t in ms, #pos, #neg
    labels: torch.Tensor,    # [B, P] int per-row class labels
    n_valid: torch.Tensor,   # [B] real rows (the rest is padding)
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    width: int = 346,
    height: int = 260,
    n_out: int = 2048,
    augment: bool = False,
    noise: Optional[NoiseDraws] = None,
    uniforms: Optional[torch.Tensor] = None,
    mesh=None,
) -> ErpcWindow:
    """ERPC rows already rasterised (the reference's pre-rasterised dataset
    format) -> normalised clouds [B, n_out, 5]: the noise augmentation, the
    fixed-size resample and the normalisation of ``erpc_batch_transform``.

    ``augment`` appends the noise rows of ``noise`` (or of draws from
    ``generator``) to windows whose gate fires. The resample over the valid
    rows and the active noise rows takes ``draws`` [B, n_out] (ints in
    [0, max(n_valid + noise_count, 1)), e.g. the JAX package's ``randint``
    draws), or ``uniforms`` [B, n_out] float64 in [0, 1) through
    ``draws_from_uniforms``, or draws from ``generator``. Under a data mesh
    (``mesh``; the batch is this rank's rows) the generator's draws are the
    global batch's, this rank's rows kept."""
    B, P, _ = feats.shape
    n_noise = n_out // 32
    if augment:
        if noise is None:
            if generator is None:
                raise ValueError("erpc transform: pass a generator or noise draws")
            noise = noise_draws(n_valid, n_noise, width, height, generator, mesh)
        noise = NoiseDraws(*(t.to(feats.device) for t in noise))
        if tuple(noise.xs.shape) != (B, n_noise):
            raise ValueError(f"noise draws must be [{B}, {n_noise}]")
        feats, labels, noise_count = append_noise(feats, labels, noise)
    else:
        # the augmentation's noise rows are present but inactive, as in JAX
        feats = torch.cat([feats, feats.new_zeros(B, n_noise, 5)], dim=1)
        labels = torch.cat([labels, labels.new_zeros(B, n_noise)], dim=1)
        noise_count = torch.zeros_like(n_valid)
    draws = _resample_indices(n_valid + noise_count, n_out, generator, draws,
                              uniforms, "erpc transform", mesh)
    sampled, sampled_labels = sample_fixed(feats, labels, n_valid, P, draws)
    return ErpcWindow(events=normalize_erpc(sampled, width, height),
                      labels=sampled_labels)


def erpc_preraster_window_transform(
    feats: torch.Tensor, labels: torch.Tensor, n_valid, **kwargs
) -> ErpcWindow:
    """One pre-rasterised window (feats [P, 5], labels [P], n_valid a
    scalar) through ``erpc_preraster_batch_transform`` -> [n_out, 5]; draws,
    uniforms and noise draws given for the window carry no batch axis."""
    for key in ("draws", "uniforms"):
        if kwargs.get(key) is not None:
            kwargs[key] = kwargs[key][None]
    if kwargs.get("noise") is not None:
        kwargs["noise"] = NoiseDraws(*(t[None] for t in kwargs["noise"]))
    out = erpc_preraster_batch_transform(
        feats[None], labels[None], torch.as_tensor(n_valid).reshape(1), **kwargs)
    return ErpcWindow(events=out.events[0], labels=out.labels[0])


def erpc_batch_transform(
    events: torch.Tensor,   # [B, N, 4] raw windows: x, y, t, p
    labels: torch.Tensor,   # [B, N] int
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    width: int = 346,
    height: int = 260,
    n_out: int = 2048,
    time_scale: float = 1e-6,
    augment: bool = False,
    noise: Optional[NoiseDraws] = None,
    event_valid: Optional[torch.Tensor] = None,
    max_pixels: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
    mesh=None,
) -> ErpcWindow:
    """Raw windows -> normalised ERPC clouds [B, n_out, 5]:
    ``rasterize_erpc`` (``event_valid`` and ``max_pixels`` go there), then
    ``erpc_preraster_batch_transform`` with the draws (and the data mesh)
    as it takes them."""
    feats, pix_labels, n_valid = rasterize_erpc(
        events, labels, width, height, time_scale=time_scale,
        event_valid=event_valid, max_pixels=max_pixels)
    return erpc_preraster_batch_transform(
        feats, pix_labels, n_valid, generator, draws, width, height, n_out,
        augment, noise, uniforms, mesh)


def erpc_real_batch_transform(
    events: torch.Tensor,        # [B, N, 4] padded windows: x, y, t in ms, p
    event_valid: torch.Tensor,   # [B, N] bool
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    width: int = 346,
    height: int = 260,
    n_out: int = 2048,
    max_pixels: Optional[int] = None,
    uniforms: Optional[torch.Tensor] = None,
    mesh=None,
) -> ErpcWindow:
    """Real-data transform: masked variable-length windows with millisecond
    timestamps, no labels and no augmentation. ``max_pixels`` bounds the
    occupied pixels kept per window (default ``min(N, max(2 * n_out,
    2048))``, the JAX package's)."""
    B, N, _ = events.shape
    mp = max_pixels or min(N, max(n_out * 2, 2048))
    labels = torch.zeros((B, N), dtype=torch.int32, device=events.device)
    return erpc_batch_transform(
        events, labels, generator, draws=draws, width=width, height=height,
        n_out=n_out, time_scale=1.0, event_valid=event_valid, max_pixels=mp,
        uniforms=uniforms, mesh=mesh)


def raw_window_transform(
    events: torch.Tensor,   # [B, N, 4] raw windows: x, y, t, p
    labels: torch.Tensor,   # [B, N] int
    generator: Optional[torch.Generator] = None,
    draws: Optional[torch.Tensor] = None,
    width: int = 346,
    height: int = 260,
    n_out: int = 2048,
    augment: bool = False,
    noise: Optional[NoiseDraws] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> ErpcWindow:
    """The 4-channel input of ``ModelConfig(erpc=False)``: no
    rasterisation. Each window's raw (x, y, t, p) events are resampled with
    replacement to ``n_out`` rows, x and y normalised by the sensor size, t
    by the window's min/max, the polarity left raw -> [B, n_out, 4].

    ``augment`` appends ``n_out // 32`` noise events labelled 3 to windows
    whose gate fires (``noise``, or draws from ``generator``): a random
    pixel, the t of a random event of the window plus U[0, 1) * 1e3, and
    polarity ``ps``; ``noise.n_pe`` and ``noise.n_ne`` are not read. The
    resample over the N events and the active noise rows takes ``draws``
    (ints in [0, N + noise_count)), ``uniforms`` or draws from
    ``generator``, as ``erpc_preraster_batch_transform`` does."""
    B, N, _ = events.shape
    full = torch.full((B,), N, dtype=torch.int32, device=events.device)
    count = torch.zeros_like(full)
    if augment:
        n_noise = n_out // 32
        if noise is None:
            if generator is None:
                raise ValueError("raw_window_transform: pass a generator or noise draws")
            noise = noise_draws(full, n_noise, width, height, generator)
        noise = NoiseDraws(*(t.to(events.device) for t in noise))
        if tuple(noise.xs.shape) != (B, n_noise):
            raise ValueError(f"noise draws must be [{B}, {n_noise}]")
        ts = torch.gather(events[..., 2], 1, noise.src.long()) + noise.t * 1e3
        rows = torch.stack([noise.xs.to(events.dtype), noise.ys.to(events.dtype),
                            ts, noise.ps.to(events.dtype)], dim=-1)
        gate = noise.gate
        events = torch.cat([events, torch.where(gate[:, None, None], rows, 0.0)], 1)
        labels = torch.cat([labels, torch.where(gate[:, None], 3, 0).to(
            labels.dtype).expand(-1, n_noise)], 1)
        count = torch.where(gate, n_noise, 0).to(torch.int32)
    draws = _resample_indices(full + count, n_out, generator, draws, uniforms,
                              "raw_window_transform").long()
    sampled = torch.gather(events, 1, draws[..., None].expand(-1, -1, 4))
    return ErpcWindow(events=normalize_erpc(sampled, width, height),
                      labels=torch.gather(labels, 1, draws))
