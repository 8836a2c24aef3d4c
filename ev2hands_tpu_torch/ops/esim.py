"""ESIM event simulation in plain PyTorch: the data generator's per-frame
threshold-crossing integration.

Counterpart of ``ev2hands_tpu/ops/esim.py``. Between two frames the log
intensity is linear in time, so the crossings of one pixel are evenly
spaced, and the events of a frame pair are four numbers a pixel:
(count, polarity, t_first, t_step). ``esim_step`` computes them as
elementwise torch on [H, W] tensors on the state's device; the host
expands them to an event list (``expand_compact_events``, numpy).

Dtypes are the JAX package's: timestamps are float32 (``last_t_ns``,
``t_first``, ``t_step``, ``last_event_t``). Float-to-int conversions are
clamped in float first: JAX's ``astype(int32)`` saturates, CUDA's does
too, and the CPU's gives INT_MIN for a value past 2^31. Every divisor is a
tensor: PyTorch's CUDA division by a Python scalar multiplies by the
reciprocal, one ulp off the CPU's true division.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

# float32(2^31): JAX's saturated int32 maximum, 2147483647, as a float32
_INT32_MAX_AS_F32 = 2.0 ** 31


def bayer_mask(height: int, width: int) -> np.ndarray:
    """RGGB colour filter array, [H, W, 3] one-hot float32."""
    m = np.zeros((height, width, 3), np.float32)
    m[0::2, 0::2, 0] = 1  # R
    m[0::2, 1::2, 1] = 1  # G
    m[1::2, 0::2, 1] = 1  # G
    m[1::2, 1::2, 2] = 1  # B
    return m


def log_intensity(rgb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RGB [H, W, 3] in [0, 255] -> mosaiced log intensity [H, W]:
    gamma 2.2, the Bayer mask, log(I + 1e-4)."""
    rgb = rgb.to(torch.float32)
    linear = (rgb / torch.full_like(rgb, 255.0)) ** 2.2
    mono = torch.sum(linear * mask, dim=-1)
    return torch.log(mono + 1e-4)


class EsimState(NamedTuple):
    ref: torch.Tensor           # [H, W] log-intensity reference level
    last_log: torch.Tensor      # [H, W] the previous frame's log intensity
    last_t_ns: torch.Tensor     # [] float32 time of the previous frame
    initialized: torch.Tensor   # [] bool
    last_event_t: torch.Tensor  # [H, W] float32 time of the last emitted event


class CompactEvents(NamedTuple):
    """The events of one frame pair, run-length coded a pixel."""

    count: torch.Tensor     # [H, W] int32 number of events
    polarity: torch.Tensor  # [H, W] int32 +1 / -1
    t_first: torch.Tensor   # [H, W] float32 ns of the first event
    t_step: torch.Tensor    # [H, W] float32 ns between successive events


def esim_init(height: int, width: int, background: Optional[float] = None,
              device="cuda") -> EsimState:
    """A fresh state on ``device``. With ``background`` the reference level
    starts at log(bg^2.2 + 0.01); otherwise the first frame sets it."""
    if background is not None:
        ref0 = torch.full((height, width), float(np.log(background ** 2.2 + 0.01)),
                          dtype=torch.float32, device=device)
        init = True
    else:
        ref0 = torch.zeros((height, width), dtype=torch.float32, device=device)
        init = False
    return EsimState(
        ref=ref0,
        last_log=ref0,
        last_t_ns=torch.zeros((), dtype=torch.float32, device=device),
        initialized=torch.tensor(init, device=device),
        # far in the past, so the first crossing is never suppressed
        last_event_t=torch.full((height, width), -1e30, dtype=torch.float32,
                                device=device),
    )


def _to_int32(x: torch.Tensor, high: float) -> torch.Tensor:
    """``x`` (integral float32) clamped into [0, high] and cast to int32."""
    return torch.clamp(x, min=0.0, max=high).to(torch.int32)


def esim_step(
    state: EsimState,
    log_frame: torch.Tensor,   # [H, W] float32
    t_ns,                      # scalar frame time (ns)
    pos_threshold: float = 0.4,
    neg_threshold: float = 0.4,
    max_events_per_pixel: int = 25,
    refractory_period_ns: float = 0.0,
) -> Tuple[EsimState, CompactEvents]:
    """One frame of ESIM integration -> (new state, the compact events of
    the previous frame -> this frame). The first frame of an uninitialised
    state gives no events.

    ``refractory_period_ns`` > 0 drops the emission (not the integration)
    of crossings earlier than the last emitted event plus the dead time:
    the survivors are evenly spaced too (first index ``k0``, stride
    ``s = ceil(r / t_step)``), and the last emitted time carries across
    frames in ``last_event_t``.

    The float-to-int casts give JAX's results for every input: ``n`` is
    capped at ``max_events_per_pixel`` and ``k0`` clamped into
    [0, max_events_per_pixel] in float (JAX saturates, then takes the
    minimum or maximum, and uses ``k0`` only where ``k0 < n``); the
    stride's integer, used only in ``(n - 1 - k0) // s``, is clamped into
    [1, max_events_per_pixel], and its float, which scales ``t_step``, is
    ``min(ceil(r / t_step), 2^31)``: JAX's saturated 2147483647 as a
    float32."""
    dev = log_frame.device
    cap = float(max_events_per_pixel)
    delta = log_frame - state.ref
    rising = delta >= 0
    th = torch.where(rising, torch.tensor(pos_threshold, dtype=torch.float32, device=dev),
                     torch.tensor(neg_threshold, dtype=torch.float32, device=dev))
    n = _to_int32(torch.floor(torch.abs(delta) / th), cap)
    n = torch.where(state.initialized, n, 0)

    # linear interpolation between the previous and this frame: level
    # ref + k * th * sign is crossed at
    # t_prev + (t - t_prev) * (level - last_log) / (frame - last_log)
    denom = log_frame - state.last_log
    safe_denom = torch.where(torch.abs(denom) < 1e-12, 1.0, denom)
    t_now = torch.as_tensor(t_ns, dtype=torch.float32, device=dev)
    dt = t_now - state.last_t_ns
    sign = torch.where(rising, 1.0, -1.0)
    level1 = state.ref + sign * th
    t_first = state.last_t_ns + dt * (level1 - state.last_log) / safe_denom
    t_step = dt * th / torch.clamp(torch.abs(safe_denom), min=1e-12)
    active = n > 0
    t_first = torch.where(active, t_first, 0.0)
    t_step = torch.where(active, t_step, 0.0)

    n_cross = n  # the reference level integrates every crossing
    last_event_t = state.last_event_t
    if refractory_period_ns > 0:
        r = torch.full_like(t_step, float(refractory_period_ns))
        safe_step = torch.clamp(t_step, min=1e-6)
        k0 = _to_int32(torch.ceil((last_event_t + r - t_first) / safe_step), cap)
        s_float = torch.clamp(torch.ceil(r / safe_step), min=1.0, max=_INT32_MAX_AS_F32)
        s = _to_int32(s_float, cap).clamp(min=1)
        n_emit = torch.where(k0 < n, torch.div(n - 1 - k0, s, rounding_mode="floor") + 1, 0)
        emit = n_emit > 0
        t_first = torch.where(emit, t_first + k0.to(torch.float32) * t_step, 0.0)
        t_step = torch.where(emit, s_float * t_step, 0.0)
        last_event_t = torch.where(
            emit, t_first + (n_emit - 1).to(torch.float32) * t_step, last_event_t)
        n = n_emit.to(torch.int32)
    else:
        last_event_t = torch.where(
            active, t_first + (n - 1).to(torch.float32) * t_step, last_event_t)

    new_ref = torch.where(state.initialized,
                          state.ref + sign * th * n_cross.to(torch.float32), log_frame)
    events = CompactEvents(
        count=n.to(torch.int32),
        polarity=torch.where(rising, 1, -1).to(torch.int32),
        t_first=t_first,
        t_step=t_step,
    )
    new_state = EsimState(
        ref=new_ref,
        last_log=log_frame,
        last_t_ns=t_now,
        initialized=torch.ones((), dtype=torch.bool, device=dev),
        last_event_t=last_event_t,
    )
    return new_state, events


def esim_video(
    log_frames: torch.Tensor,   # [F, H, W]
    t_ns: torch.Tensor,         # [F]
    state: EsimState,
    pos_threshold: float = 0.4,
    neg_threshold: float = 0.4,
    max_events_per_pixel: int = 25,
    refractory_period_ns: float = 0.0,
) -> Tuple[EsimState, CompactEvents]:
    """``esim_step`` over the frames in order -> (final state, compact
    events with each field stacked [F, H, W])."""
    t_ns = torch.as_tensor(t_ns).to(torch.float32)
    steps = []
    for f in range(log_frames.shape[0]):
        state, ev = esim_step(state, log_frames[f], t_ns[f], pos_threshold,
                              neg_threshold, max_events_per_pixel, refractory_period_ns)
        steps.append(ev)
    return state, CompactEvents(*(torch.stack(field) for field in zip(*steps)))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def expand_compact_events(ev: CompactEvents) -> np.ndarray:
    """One frame's compact events (tensors on any device, or numpy) -> an
    event list [N, 4] float64 (x, y, t_ns, p in {1, -1}), pixels in
    row-major order, each pixel's events in time order."""
    count = _host(ev.count)
    ys, xs = np.nonzero(count)
    if len(ys) == 0:
        return np.zeros((0, 4), np.float64)
    ns = count[ys, xs]
    pol = _host(ev.polarity)[ys, xs]
    t0 = _host(ev.t_first)[ys, xs].astype(np.float64)
    dt = _host(ev.t_step)[ys, xs].astype(np.float64)

    total = int(ns.sum())
    out = np.empty((total, 4), np.float64)
    idx = np.repeat(np.arange(len(ys)), ns)
    # each event's index within its pixel: 0 .. count - 1
    k = np.arange(total) - np.repeat(np.cumsum(ns) - ns, ns)
    out[:, 0] = xs[idx]
    out[:, 1] = ys[idx]
    out[:, 2] = t0[idx] + k * dt[idx]
    out[:, 3] = pol[idx]
    return out
