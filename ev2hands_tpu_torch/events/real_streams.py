"""Host-side Ev2Hands-R recordings: padded sliding windows of real events
with their ground-truth joints.

Counterpart of ``ev2hands_tpu/events/real_streams.py``: the sliding windows
of evaluation and the random windows of finetuning (``Ev2HandRReader``). The
host decodes a
recording (the reference's pickle export, or a live ``.aedat4`` through the
optional ``dv`` package), undistorts the event coordinates once with the
port's own ``camera.undistort_points`` (no OpenCV), converts timestamps to
ms and serves fixed-capacity windows; the ERPC transform runs on the device
(``events.erpc.erpc_real_batch_transform``).

Window semantics (the reference's):
  * ``window_at(start)`` takes events until their time span exceeds
    ``window_ms`` and at least ``min_events`` are in;
  * evaluation slides 2 ms windows by 1 ms;
  * a window's ground truth is its first frame's joints (the reference's
    sequential evaluator); ``frame_index`` is the majority frame;
  * finetuning draws a recording, a start and a window length of 1 or 2 ms
    per sample, its ground truth the majority frame's joints.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np

from ev2hands_tpu_torch.camera import undistort_points
from ev2hands_tpu_torch.events.streams import stack_samples

WINDOW_MS = 2.0
OVERLAP_MS = 1.0
MIN_EVENTS = 2048


class RealStream:
    """One recording: events [N, 4|5] (x, y, t in ms, p[, frame_index]),
    ground-truth joints [F, 2, 21, 3] in m, and the camera dict."""

    def __init__(self, file_path: str, width: int = 346, height: int = 260):
        if file_path.endswith("pickle"):
            with open(file_path, "rb") as f:
                data = pickle.load(f)
            events = np.asarray(data["events"], np.float64)
            self.joints = np.asarray(data["joints"], np.float64) / 1000.0  # mm -> m
            self.camera = data["camera"]
            events[:, :2] = undistort_points(
                events[:, :2].astype(np.float32), self.camera["camera_matrix"],
                self.camera["dist"], width, height)
        else:  # a live AEDAT4 recording
            events = self._load_aedat(file_path)
            self.joints = np.zeros((1, 2, 21, 3))
            self.camera = {"projection_matrix": np.eye(4)[:3, :]}
        events = events.copy()
        events[:, 2] = events[:, 2] * 1e-3  # us -> ms
        self.events = events
        self.has_frame_index = events.shape[1] == 5

    @staticmethod
    def _load_aedat(file_path: str) -> np.ndarray:
        try:
            from dv import AedatFile
        except ImportError as e:
            raise ImportError("reading .aedat4 needs the 'dv' package") from e
        with AedatFile(file_path) as f:
            packets = np.hstack([packet for packet in f["events"].numpy()])
        return np.stack(
            [packets["x"], packets["y"], packets["timestamp"], packets["polarity"]], 1
        ).astype(np.float64)

    def __len__(self) -> int:
        return len(self.events)

    def window_at(
        self, start: int, window_ms: float = WINDOW_MS,
        min_events: int = MIN_EVENTS, capacity: int = 4 * MIN_EVENTS,
    ) -> Optional[Dict[str, np.ndarray]]:
        """A window of at most ``capacity`` events from event ``start``,
        padded to ``capacity``, its times relative to its first event; None
        when the stream is exhausted."""
        ev = self.events
        if start >= len(ev) - 1:
            return None
        t0 = ev[start, 2]
        end_time = np.searchsorted(ev[:, 2], t0 + window_ms, side="right")
        end = min(max(end_time, start + min_events), len(ev), start + capacity)
        if end - start < 2:
            return None
        chunk = ev[start:end]
        n = end - start
        out = np.zeros((capacity, 4), np.float32)
        out[:n, 0] = chunk[:, 0]
        out[:n, 1] = chunk[:, 1]
        out[:n, 2] = chunk[:, 2] - chunk[0, 2]
        out[:n, 3] = chunk[:, 3]
        valid = np.zeros(capacity, bool)
        valid[:n] = True
        if self.has_frame_index:
            values, counts = np.unique(chunk[:, 4].astype(np.int64), return_counts=True)
            frame_index = int(values[np.argmax(counts)])
            first_frame_index = int(values[0])
        else:
            frame_index = first_frame_index = -1
        return {
            "events": out,
            "event_valid": valid,
            "n_events": np.int32(n),
            "frame_index": np.int64(frame_index),
            "first_frame_index": np.int64(first_frame_index),
            "end": int(end),
        }

    def joints_3d(self, frame_index: int) -> np.ndarray:
        """[2, 21, 3] in m; IndexError past the motion-capture range."""
        if frame_index >= len(self.joints) or frame_index < 0:
            raise IndexError(frame_index)
        return np.asarray(self.joints[frame_index], np.float32)

    def joints_2d(self, frame_index: int) -> np.ndarray:
        """[2, 21, 2] float32 pixels through the pinhole camera matrix."""
        j3d = self.joints_3d(frame_index) * 1000.0
        p = j3d @ np.asarray(self.camera["camera_matrix"], np.float32).T
        return (p[..., :2] / p[..., 2:3]).astype(np.float32)

    def sliding_windows(
        self, window_ms: float = WINDOW_MS, advance_ms: float = OVERLAP_MS,
        capacity: int = 4 * MIN_EVENTS,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """``window_ms`` windows whose starts advance by ``advance_ms`` (at
        least one event), each with its first frame's joints as 'j3d'; ends
        at the stream's or the motion capture's end."""
        ev = self.events
        start = 0
        while True:
            w = self.window_at(start, window_ms, MIN_EVENTS, capacity)
            if w is None:
                return
            try:
                w["j3d"] = self.joints_3d(int(w["first_frame_index"]))
            except IndexError:
                return
            yield w
            nxt = int(np.searchsorted(ev[:, 2], ev[start, 2] + advance_ms, side="right"))
            start = max(nxt, start + 1)


class Ev2HandRReader:
    """Random training windows over a recording or a directory of them:
    per sample a recording, a start event and a window length of 1 or 2 ms
    from one ``np.random.RandomState(seed)``, drawn in the JAX package's
    order, so both readers give the same batches for the same seed. The
    ground truth is the majority frame's joints in 3-D (m) and 2-D
    (pixels)."""

    def __init__(self, root: str, seed: int = 0, capacity: int = 4 * MIN_EVENTS):
        paths = [root] if not os.path.isdir(root) else [
            os.path.join(root, f) for f in sorted(os.listdir(root))]
        self.streams: List[RealStream] = [RealStream(p) for p in paths]
        self.capacity = capacity
        self.rng = np.random.RandomState(seed)

    def sample(self) -> Dict[str, np.ndarray]:
        while True:
            stream = self.streams[self.rng.randint(len(self.streams))]
            start = self.rng.randint(0, max(len(stream) - MIN_EVENTS, 1))
            window_ms = float(self.rng.randint(1, int(WINDOW_MS) + 1))
            w = stream.window_at(start, window_ms, MIN_EVENTS, self.capacity)
            if w is None:
                continue
            try:
                j3d = stream.joints_3d(int(w["frame_index"]))
                j2d = stream.joints_2d(int(w["frame_index"]))
            except IndexError:
                continue
            return {
                "events": w["events"],
                "event_valid": w["event_valid"],
                "left": {"j3d": j3d[0], "j2d": j2d[0], "valid": np.float32(1.0)},
                "right": {"j3d": j3d[1], "j2d": j2d[1], "valid": np.float32(1.0)},
                "handedness": np.ones(2, np.int32),
            }

    def batches(self, batch_size: int, max_batches: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        count = 0
        while max_batches is None or count < max_batches:
            yield stack_samples([self.sample() for _ in range(batch_size)])
            count += 1


def sliding_window_batches(
    stream: RealStream, batch_size: int, max_windows: Optional[int] = None,
    with_gt: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """``stream.sliding_windows()`` in batches of ``batch_size`` ('events',
    'event_valid', 'n_valid' and, ``with_gt``, 'j3d'). The last batch is
    padded with its last window; 'n_valid' counts the real ones. Stops once
    ``max_windows`` windows are collected and scores what it holds."""
    buf: List[Dict[str, np.ndarray]] = []
    produced = 0

    def batch() -> Dict[str, np.ndarray]:
        padded = buf + [buf[-1]] * (batch_size - len(buf))
        out = {
            "events": np.stack([w["events"] for w in padded]),
            "event_valid": np.stack([w["event_valid"] for w in padded]),
            "n_valid": len(buf),
        }
        if with_gt:
            out["j3d"] = np.stack([w["j3d"] for w in padded])
        return out

    for w in stream.sliding_windows():
        buf.append(w)
        if len(buf) == batch_size:
            yield batch()
            produced += batch_size
            buf = []
        if max_windows and produced + len(buf) >= max_windows:
            break
    if buf:
        yield batch()


def write_synthetic_ev2hands_r(
    path: str, n_events: int = 100_000, n_frames: int = 50,
    width: int = 346, height: int = 260, seed: int = 0,
) -> str:
    """A synthetic Ev2Hands-R recording in the reference's pickle export
    format (events in us with a frame index, joints in mm, a camera with a
    distortion vector), drawn as the JAX package's writer draws it."""
    rng = np.random.RandomState(seed)
    t_us = np.sort(rng.randint(0, n_frames * 40_000, n_events))  # ~25 fps mocap
    frame_index = np.clip(t_us // 40_000, 0, n_frames - 1)
    events = np.stack([
        rng.randint(0, width, n_events),
        rng.randint(0, height, n_events),
        t_us,
        rng.randint(0, 2, n_events),
        frame_index,
    ], 1).astype(np.float64)
    joints = rng.randn(n_frames, 2, 21, 3) * 30 + np.array([0, 0, 400.0])  # mm
    camera_matrix = np.array([[320.0, 0, width / 2], [0, 320.0, height / 2], [0, 0, 1]])
    data = {
        "events": events,
        "joints": joints,
        "camera": {
            "camera_matrix": camera_matrix,
            "dist": np.zeros(5),
            "projection_matrix": camera_matrix @ np.eye(4)[:3],
        },
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path
