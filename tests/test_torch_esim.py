"""The port's ESIM (``ev2hands_tpu_torch/ops/esim.py``) against the JAX
package's on the same log frames, and both against a per-pixel while-loop
oracle.

``count`` and ``polarity`` are equal; ``t_first``, ``t_step``, ``ref`` and
``last_event_t`` agree within rtol 1e-6 (the jitted JAX scan may contract
a multiply and an add into one FMA: one ulp). ``expand_compact_events`` is
bitwise and ``log_intensity`` within 1e-6. Small sizes: 6x8 frames, a
handful of steps, one JAX compile a test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.ops import esim as je
from ev2hands_tpu_torch.ops import esim as te


def esim_oracle(frames, times, pos_th, neg_th, cap=25, refractory_ns=0.0):
    """Per-pixel while-loop ESIM with linear time interpolation; a crossing
    earlier than ``last_emitted + refractory_ns`` on the same pixel still
    moves the reference level but emits no event."""
    H, W = frames[0].shape
    ref = frames[0].copy()
    last_emit = np.full((H, W), -np.inf)
    events = []
    for f in range(1, len(frames)):
        L0, L1 = frames[f - 1], frames[f]
        t0, t1 = times[f - 1], times[f]
        for i in range(H):
            for j in range(W):
                n = 0
                while L1[i, j] - ref[i, j] >= pos_th and n < cap:
                    ref[i, j] += pos_th
                    ts = t0 + (t1 - t0) * (ref[i, j] - L0[i, j]) / (L1[i, j] - L0[i, j])
                    if ts >= last_emit[i, j] + refractory_ns:
                        events.append((j, i, ts, 1))
                        last_emit[i, j] = ts
                    n += 1
                while L1[i, j] - ref[i, j] <= -neg_th and n < cap:
                    ref[i, j] -= neg_th
                    ts = t0 + (t1 - t0) * (ref[i, j] - L0[i, j]) / (L1[i, j] - L0[i, j])
                    if ts >= last_emit[i, j] + refractory_ns:
                        events.append((j, i, ts, -1))
                        last_emit[i, j] = ts
                    n += 1
    return np.array(events, np.float64).reshape(-1, 4), ref


def _frames(seed, F=6, H=6, W=8, scale=1.5):
    rng = np.random.RandomState(seed)
    return (rng.randn(F, H, W).astype(np.float32) * scale,
            np.arange(F, dtype=np.float64) * 1e6)


def _assert_close_to_jax(t_ev, j_ev, t_state, j_state):
    np.testing.assert_array_equal(t_ev.count.numpy(), np.asarray(j_ev.count))
    np.testing.assert_array_equal(t_ev.polarity.numpy(), np.asarray(j_ev.polarity))
    for name in ("t_first", "t_step"):
        np.testing.assert_allclose(getattr(t_ev, name).numpy(),
                                   np.asarray(getattr(j_ev, name)), rtol=1e-6, atol=0)
    for name in ("ref", "last_event_t", "last_log", "last_t_ns"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)), rtol=1e-6, atol=0)
    assert bool(t_state.initialized) == bool(j_state.initialized)


def _expand_all(ev, F):
    return np.concatenate([
        te.expand_compact_events(te.CompactEvents(*(x[f] for x in ev))) for f in range(F)])


def _counts(events):
    d = {}
    for x, y, _, p in events:
        d[(int(x), int(y), int(p))] = d.get((int(x), int(y), int(p)), 0) + 1
    return d


@pytest.mark.parametrize("refractory_ns", [0.0, 0.35e6])
def test_esim_video_matches_jax_and_oracle(refractory_ns):
    """esim_video on 6 frames of 6x8, without and with a dead time that
    suppresses crossings within and across frames: equal to JAX's scan, and
    both give the oracle's events and reference levels."""
    frames, times = _frames(0)
    F = len(frames)
    j_state, j_ev = je.esim_video(jnp.asarray(frames), jnp.asarray(times),
                                  je.esim_init(6, 8), refractory_period_ns=refractory_ns)
    t_state, t_ev = te.esim_video(torch.from_numpy(frames), torch.from_numpy(times),
                                  te.esim_init(6, 8, device="cpu"),
                                  refractory_period_ns=refractory_ns)
    _assert_close_to_jax(t_ev, j_ev, t_state, j_state)

    got = _expand_all(t_ev, F)
    ref_events, ref_level = esim_oracle(frames.astype(np.float64), times, 0.4, 0.4,
                                        refractory_ns=refractory_ns)
    if refractory_ns:
        assert len(ref_events) < len(esim_oracle(frames.astype(np.float64), times,
                                                 0.4, 0.4)[0])
    assert _counts(got) == _counts(ref_events)
    np.testing.assert_allclose(t_state.ref.numpy(), ref_level, atol=1e-4)
    order = lambda e: np.lexsort((e[:, 2], e[:, 1], e[:, 0]))  # noqa: E731
    np.testing.assert_allclose(got[order(got)][:, 2], ref_events[order(ref_events)][:, 2],
                               rtol=1e-3, atol=40.0)


def test_esim_step_background_start_matches_jax():
    """The ``background`` start (the reference level at log(bg^2.2 + 0.01),
    initialised): the first frame already emits, stepwise as JAX does."""
    frames, times = _frames(1, F=3, scale=0.8)
    j_state = je.esim_init(6, 8, background=159 / 255)
    t_state = te.esim_init(6, 8, background=159 / 255, device="cpu")
    np.testing.assert_array_equal(t_state.ref.numpy(), np.asarray(j_state.ref))
    for f in range(len(frames)):
        j_state, j_ev = je.esim_step(j_state, jnp.asarray(frames[f]),
                                     jnp.float32(times[f] + 1e6))
        t_state, t_ev = te.esim_step(t_state, torch.from_numpy(frames[f]),
                                     np.float32(times[f] + 1e6))
        _assert_close_to_jax(t_ev, j_ev, t_state, j_state)
        if f == 0:
            assert int(t_ev.count.sum()) > 0


def test_esim_step_saturating_stride_cast_matches_jax():
    """Frames 1 ns apart with a 1 s dead time: r / t_step is ~2.5e10, past
    2^31. JAX's int32 cast saturates (the stride is 2147483647: one event a
    pixel, t_step scaled by 2^31); an unclamped CPU cast would give INT_MIN,
    a stride of 1 and every crossing."""
    H, W = 2, 3
    lo = np.zeros((H, W), np.float32)
    hi = np.full((H, W), 10.0, np.float32)
    hi[0, 0] = -10.0
    j_state, t_state = je.esim_init(H, W), te.esim_init(H, W, device="cpu")
    got = []
    for frame, t in ((lo, 0.0), (hi, 1.0), (lo, 2.0)):
        before = t_state
        j_state, j_ev = je.esim_step(j_state, jnp.asarray(frame), jnp.float32(t),
                                     refractory_period_ns=1e9)
        t_state, t_ev = te.esim_step(t_state, torch.from_numpy(frame), np.float32(t),
                                     refractory_period_ns=1e9)
        _assert_close_to_jax(t_ev, j_ev, t_state, j_state)
        got.append((before, t_ev))
    # the second frame: one event a pixel of 25 crossings, its t_step scaled
    # by the stride's float 2^31
    before, ev = got[1]
    unfiltered = te.esim_step(before, torch.from_numpy(hi), np.float32(1.0))[1]
    assert (unfiltered.count.numpy() == 25).all()
    assert (ev.count.numpy() == 1).all()
    np.testing.assert_array_equal(ev.t_step.numpy(),
                                  np.float32(2.0 ** 31) * unfiltered.t_step.numpy())
    # the third falls inside the dead time of the second's events
    assert int(got[2][1].count.sum()) == 0


def test_expand_and_log_intensity_match_jax():
    """expand_compact_events bitwise on one frame of esim_video's output
    (tensors and numpy alike); log_intensity within 1e-6 on uint8 RGB."""
    frames, times = _frames(2, F=3)
    _, j_ev = je.esim_video(jnp.asarray(frames), jnp.asarray(times), je.esim_init(6, 8))
    compact = je.CompactEvents(*(np.array(x[2]) for x in j_ev))
    ref = je.expand_compact_events(compact)
    assert len(ref) > 10
    got = te.expand_compact_events(te.CompactEvents(*(torch.from_numpy(x) for x in compact)))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(te.expand_compact_events(compact), ref)
    empty = te.CompactEvents(*(np.zeros_like(x) for x in compact))
    assert te.expand_compact_events(empty).shape == (0, 4)

    rng = np.random.RandomState(3)
    rgb = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
    mask = je.bayer_mask(6, 8)
    np.testing.assert_array_equal(te.bayer_mask(6, 8), mask)
    want = np.asarray(je.log_intensity(jnp.asarray(rgb), jnp.asarray(mask)))
    got = te.log_intensity(torch.from_numpy(rgb), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
