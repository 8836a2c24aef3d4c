"""Host-side Ev2Hands-S reader: raw event windows and MANO ground truth as
fixed-shape numpy batches, and a background prefetcher.

Counterpart of ``ev2hands_tpu/events/streams.py``. The file format is the
reference generator's: ``{root}.h5`` with an ``event`` dataset of rows
[x, y, t, p, annotation_index, event_label] and ``{root}_anno.pickle``, a
list of per-frame ``{hand_type: {global_orient, hand_pose, shape, trans}}``
dicts. ``h5py`` is imported only to open or write such a file: a reader
built from rows in memory (``Ev2HandSReader.from_rows``) needs none, so a
machine without ``h5py`` can evaluate synthetic data
(``synthetic_ev2hands_s``).
"""

from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

N_POSE_GT = 45  # the generator stores 45 PCA pose components


class Ev2HandSReader:
    """Window reader over Ev2Hands-S event rows: a window is ``n_events``
    consecutive rows, its ground truth the annotation of its last row."""

    def __init__(self, root: str, n_events: int = 2048, seed: int = 0):
        """Opens ``{root}.h5`` (read lazily) and ``{root}_anno.pickle``."""
        import h5py

        with open(f"{root}_anno.pickle", "rb") as f:
            annotations = pickle.load(f)
        self.file = h5py.File(f"{root}.h5", "r")
        self._init(self.file["event"], annotations, n_events, seed)
        self.root = root

    @classmethod
    def from_rows(cls, rows: np.ndarray, annotations: List[Dict],
                  n_events: int = 2048, seed: int = 0) -> "Ev2HandSReader":
        """A reader over event rows [n, 6] held in memory."""
        reader = cls.__new__(cls)
        reader._init(np.asarray(rows), annotations, n_events, seed)
        reader.root = None
        return reader

    def _init(self, dataset, annotations, n_events, seed):
        self.dataset = dataset
        self.annotations = annotations
        self.n_events = n_events
        self.n_samples = len(dataset)
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return self.n_samples

    def window(self, index: int) -> Dict[str, np.ndarray]:
        """One raw window starting at event ``index`` (moved back to stay
        full near the end)."""
        index = min(index, self.n_samples - self.n_events)
        rows = np.asarray(self.dataset[index:index + self.n_events], np.float64)
        return {
            "events": rows[:, :4].astype(np.float32),       # x, y, t, p
            "labels": rows[:, 5].astype(np.int32),
            **pack_mano_gt(self.annotations[int(rows[-1, 4])]),
        }

    def batches(
        self, batch_size: int, shuffle: bool = True, max_batches: Optional[int] = None
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches: random window starts, or with ``shuffle=False``
        starts ``n_events`` apart from where the previous batch stopped."""
        count = 0
        limit = max(self.n_samples - self.n_events, 1)
        while max_batches is None or count < max_batches:
            if shuffle:
                starts = self.rng.randint(0, limit, size=batch_size)
            else:
                base = (count * batch_size * self.n_events) % limit
                starts = (base + np.arange(batch_size) * self.n_events) % limit
            yield stack_samples([self.window(int(s)) for s in starts])
            count += 1

    def n_windows(self, stride: int = 1) -> int:
        """Window starts at ``stride``: the reference indexes a window at
        every event row, which ``stride=1`` reproduces."""
        return (self.n_samples + stride - 1) // stride

    def sequential_batches(
        self, batch_size: int, stride: int = 1, max_batches: Optional[int] = None
    ) -> Iterator[Tuple[Dict[str, np.ndarray], int]]:
        """Every window start 0, stride, 2 * stride, ... in order ->
        ``(batch, n_real)``. The last batch is padded with its last window
        to the full size; only its first ``n_real`` entries are new."""
        total = self.n_windows(stride)
        for count, b0 in enumerate(range(0, total, batch_size)):
            if max_batches is not None and count >= max_batches:
                return
            idx = [min(b0 + j, total - 1) * stride for j in range(batch_size)]
            yield (stack_samples([self.window(int(i)) for i in idx]),
                   min(batch_size, total - b0))


def pack_mano_gt(camera_hand_info: Dict) -> Dict[str, np.ndarray]:
    """Fixed-shape MANO ground truth of one frame. A missing hand copies the
    present one with valid=0.

    This keeps the JAX package's deliberate fix of a reference quirk: the
    reference aliases the present hand's dict into the missing slot and then
    marks it invalid, which invalidates both hands of a one-hand frame; here
    the copy is independent, so the present hand stays valid."""
    handedness = np.zeros(2, np.int32)
    sides = {}
    for hand_type, hand in camera_hand_info.items():
        handedness[:] = 1
        sides[hand_type] = {
            "global_orient": np.asarray(hand["global_orient"], np.float32).reshape(3),
            "hand_pose": _pad_pose(np.asarray(hand["hand_pose"], np.float32).reshape(-1)),
            "shape": np.asarray(hand["shape"], np.float32).reshape(10),
            "trans": np.asarray(hand["trans"], np.float32).reshape(3),
            "valid": np.float32(1.0),
        }
    if "left" not in sides:
        sides["left"] = dict(sides["right"], valid=np.float32(0.0))
        handedness[0] = 0
    if "right" not in sides:
        sides["right"] = dict(sides["left"], valid=np.float32(0.0))
        handedness[1] = 0
    return {"left": sides["left"], "right": sides["right"], "handedness": handedness}


def _pad_pose(pose: np.ndarray, n: int = N_POSE_GT) -> np.ndarray:
    if pose.shape[0] >= n:
        return pose[:n]
    return np.concatenate([pose, np.zeros(n - pose.shape[0], np.float32)])


def stack_samples(samples) -> Dict:
    """A list of per-window dicts -> one dict of stacked numpy arrays."""
    def rec(items):
        if isinstance(items[0], dict):
            return {k: rec([it[k] for it in items]) for k in items[0]}
        return np.stack(items)

    return rec(samples)


class Prefetcher:
    """Runs an iterator in a background thread, ``depth`` items ahead, so
    that host batch assembly overlaps the device's work."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, args=(iterator,),
                                        daemon=True)
        self._thread.start()

    def _worker(self, iterator):
        try:
            for item in iterator:
                self._q.put(item)
        except BaseException as e:  # re-raised in the consumer
            self._error = e
        finally:
            self._q.put(self._DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            if self._error is not None:
                raise self._error
            raise StopIteration
        return item


def synthetic_ev2hands_s(
    n_events: int = 65536, n_frames: int = 16, width: int = 346,
    height: int = 260, seed: int = 0,
) -> Tuple[np.ndarray, List[Dict]]:
    """(event rows [n_events, 6] int64, annotations) of a small random
    Ev2Hands-S-format dataset: the JAX package's synthetic writer's draws,
    in its order, from ``seed``. Every fifth frame lacks its left hand."""
    rng = np.random.RandomState(seed)
    t = np.sort(rng.randint(0, int(1e9), n_events))
    x = rng.randint(0, width, n_events)
    y = rng.randint(0, height, n_events)
    p = rng.randint(0, 2, n_events)
    anno = (np.arange(n_events) * n_frames // n_events).astype(np.int64)
    label = rng.randint(0, 4, n_events)
    rows = np.stack([x, y, t, p, anno, label], axis=1).astype(np.int64)

    annotations = []
    for i in range(n_frames):
        frame = {}
        for side in ("left", "right"):
            if side == "left" and i % 5 == 4:
                continue
            frame[side] = {
                "global_orient": rng.randn(3).astype(np.float32) * 0.2,
                "hand_pose": rng.randn(45).astype(np.float32) * 0.3,
                "shape": rng.randn(10).astype(np.float32) * 0.5,
                "trans": rng.randn(3).astype(np.float32) * 0.1
                + np.float32([-0.1 if side == "left" else 0.1, 0, 0.4]),
            }
        annotations.append(frame)
    return rows, annotations


def write_synthetic_ev2hands_s(root: str, **kwargs) -> str:
    """Write ``synthetic_ev2hands_s(**kwargs)`` as ``{root}.h5`` and
    ``{root}_anno.pickle``; returns ``root``."""
    import h5py

    rows, annotations = synthetic_ev2hands_s(**kwargs)
    os.makedirs(os.path.dirname(root) or ".", exist_ok=True)
    with h5py.File(f"{root}.h5", "w") as f:
        f.create_dataset("event", data=rows)
    with open(f"{root}_anno.pickle", "wb") as f:
        pickle.dump(annotations, f)
    return root
