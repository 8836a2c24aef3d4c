"""Pre-rasterised ERPC dataset writer and reader.

The port's own copy of ``ev2hands_tpu/datagen/erpc_writer.py``. The
reference's second generation script stores each frame's events already
rasterised into the 5-feature ERPC rows (x, y, mean t in ms, #positive,
#negative), sampled down to <= 2048 rows, in pickle parts keyed
``events-%09d`` / ``event_labels-%09d`` / ``camera_hand_info-%09d``:

  * :func:`rasterize_frame_erpc` -- that recipe for one frame (``np.add.at``
    sums, the nonzero pixels, ns -> ms mean time, a with-replacement
    ``choice`` past ``n_events``);
  * :func:`write_erpc_parts` -- parts in that key layout;
  * :class:`PreRasterizedErpcReader` -- fixed-shape batches of such parts
    for ``events.erpc.erpc_preraster_batch_transform``.

numpy on the host; the batches are the JAX package's bit for bit.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def rasterize_frame_erpc(
    events: np.ndarray,   # [N, 4] raw events: x, y, t_ns, p
    labels: np.ndarray,   # [N] per-event class labels
    width: int,
    height: int,
    n_events: int = 2048,
    rng: Optional[np.random.RandomState] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One frame's raw events -> pre-rasterized ERPC rows, following
    ``main_erpc.py:84-109`` exactly: per-pixel sums via ``np.add.at``,
    nonzero pixels re-extracted, mean timestamp converted ns->ms (* 1e-6),
    and a with-replacement ``np.random.choice`` downsample when more than
    ``n_events`` pixels fire.  Labels ride along per selected pixel (the
    reference reads them from the segmentation map at the same yi, xi)."""
    rng = rng or np.random.RandomState(0)
    x = events[:, 0].astype(np.int32)
    y = events[:, 1].astype(np.int32)
    t = events[:, 2].astype(np.float64)
    p = events[:, 3]

    event_grid = np.zeros((height, width, 3), np.float64)
    count_grid = np.zeros((height, width), np.float64)
    label_grid = np.zeros((height, width), np.int64)
    np.add.at(event_grid, (y, x, 0), t)
    np.add.at(event_grid, (y, x, 1), p == 1)
    np.add.at(event_grid, (y, x, 2), p != 1)
    np.add.at(count_grid, (y, x), 1)
    label_grid[y, x] = labels  # last-writer-wins, like seg[yi, xi]

    yi, xi = np.nonzero(count_grid)
    t_avg = (event_grid[yi, xi, 0] / count_grid[yi, xi]) * 1e-6  # ns -> ms
    rows = np.stack(
        [xi.astype(np.float64), yi.astype(np.float64), t_avg,
         event_grid[yi, xi, 1], event_grid[yi, xi, 2]], axis=-1
    )
    row_labels = label_grid[yi, xi].astype(np.uint8)

    if len(rows) > n_events:
        sel = rng.choice(rows.shape[0], n_events)
        rows, row_labels = rows[sel], row_labels[sel]
    return rows, row_labels


def write_erpc_parts(
    frames: Iterator[Dict],
    out_dir: str,
    mode: str = "train",
    width: int = 346,
    height: int = 260,
    n_events: int = 2048,
    frames_per_part: int = 1000,
    worker_id: int = 0,
    seed: int = 0,
) -> List[str]:
    """Write reference-layout pre-rasterized parts from generated frames
    (the dicts :func:`datagen.generate.simulate_sequence` yields: raw
    ``events`` [N,4], ``event_labels`` [N], ``camera_hand_info``)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    parts: List[str] = []
    cache: Dict[bytes, np.ndarray] = {}
    part_idx = 0
    cache_index = 0

    def flush():
        nonlocal cache, part_idx
        if not cache:
            return
        path = os.path.join(
            out_dir, f"{mode}_erpc_w{worker_id:02d}_part{part_idx:06d}.pickle"
        )
        with open(path, "wb") as f:
            pickle.dump(cache, f)
        parts.append(path)
        cache = {}
        part_idx += 1

    for frame in frames:
        rows, row_labels = rasterize_frame_erpc(
            np.asarray(frame["events"]), np.asarray(frame["event_labels"]),
            width, height, n_events, rng,
        )
        # the reference's exact cache-key layout (main_erpc.py:147-156)
        cache[b"events-%09d" % cache_index] = rows
        cache[b"event_labels-%09d" % cache_index] = row_labels
        cache[b"camera_hand_info-%09d" % cache_index] = frame["camera_hand_info"]
        cache_index += 1
        if cache_index % frames_per_part == 0:
            flush()
    flush()
    return parts


class PreRasterizedErpcReader:
    """Reads reference-layout pre-rasterized parts into fixed-shape batches.

    Each frame becomes (feats [capacity, 5] zero-padded, labels [capacity],
    n_valid) plus the packed MANO GT; feed batches to
    ``erpc_preraster_batch_transform`` for the on-device resample/normalize."""

    def __init__(self, paths: List[str], capacity: int = 2048, seed: int = 0):
        from ev2hands_tpu_torch.events.streams import pack_mano_gt

        self.frames: List[Dict] = []
        for path in paths:
            with open(path, "rb") as f:
                cache = pickle.load(f)
            indices = sorted(
                int(k.split(b"-")[1]) for k in cache if k.startswith(b"events-")
            )
            for i in indices:
                rows = np.asarray(cache[b"events-%09d" % i], np.float32)
                labels = np.asarray(
                    cache[b"event_labels-%09d" % i], np.int32
                )
                info = cache[b"camera_hand_info-%09d" % i]
                n = min(len(rows), capacity)
                feats = np.zeros((capacity, 5), np.float32)
                labs = np.zeros((capacity,), np.int32)
                feats[:n] = rows[:n]
                labs[:n] = labels[:n]
                self.frames.append({
                    "feats": feats, "labels": labs, "n_valid": np.int32(n),
                    **pack_mano_gt(info),
                })
        self.capacity = capacity
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.frames)

    def batches(
        self, batch_size: int, shuffle: bool = True,
        max_batches: Optional[int] = None,
    ) -> Iterator[Dict[str, np.ndarray]]:
        from ev2hands_tpu_torch.events.streams import stack_samples

        count = 0
        while max_batches is None or count < max_batches:
            if shuffle:
                idx = self.rng.randint(0, len(self.frames), size=batch_size)
            else:
                idx = (np.arange(batch_size) + count * batch_size) % len(self.frames)
            yield stack_samples([self.frames[i] for i in idx])
            count += 1
