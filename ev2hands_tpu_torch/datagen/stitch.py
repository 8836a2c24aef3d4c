"""Stitcher: merge generated pickle parts into the Ev2Hands-S files.

Counterpart of ``ev2hands_tpu/datagen/stitch.py``, in two steps.
``stitch_rows`` merges the parts, in natural order, into event rows
[x, y, t, p, annotation_index, event_label] int64 and a flat list of
per-frame camera-space MANO parameters, in memory: that is what
``events.streams.Ev2HandSReader.from_rows`` reads, with no ``h5py``.
``stitch`` writes them as ``{root}.h5`` (dataset ``event``) and
``{root}_anno.pickle``, the layout ``Ev2HandSReader(root)`` opens; it
imports ``h5py`` only there.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Tuple

import numpy as np


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def stitch_rows(part_paths: List[str]) -> Tuple[np.ndarray, List[Dict]]:
    """The parts' frames in natural part order -> (event rows [n, 6]
    int64, annotations: one entry a frame, events or not)."""
    annotations, chunks = [], []
    for path in sorted(part_paths, key=_natural_key):
        with open(path, "rb") as pf:
            frames = pickle.load(pf)
        for frame in frames:
            anno_index = len(annotations)
            annotations.append(frame["camera_hand_info"])
            events = np.asarray(frame["events"], np.float64)
            if events.size == 0:
                continue
            rows = np.empty((len(events), 6), np.int64)
            rows[:, 0] = events[:, 0]          # x
            rows[:, 1] = events[:, 1]          # y
            rows[:, 2] = events[:, 2]          # t (ns)
            rows[:, 3] = events[:, 3] > 0      # p: 1 positive, 0 negative
            rows[:, 4] = anno_index
            rows[:, 5] = np.asarray(frame["event_labels"], np.int64)
            chunks.append(rows)
    rows = np.concatenate(chunks) if chunks else np.zeros((0, 6), np.int64)
    return rows, annotations


def stitch(part_paths: List[str], out_root: str, chunk_rows: int = 1 << 16) -> str:
    """Merge parts into ``{out_root}.h5`` + ``{out_root}_anno.pickle`` ->
    ``out_root``."""
    import h5py

    rows, annotations = stitch_rows(part_paths)
    os.makedirs(os.path.dirname(out_root) or ".", exist_ok=True)
    with h5py.File(f"{out_root}.h5", "w") as f:
        dset = f.create_dataset("event", shape=(0, 6), maxshape=(None, 6),
                                dtype=np.int64, chunks=(chunk_rows, 6))
        if len(rows):
            dset.resize(len(rows), axis=0)
            dset[:] = rows
    with open(f"{out_root}_anno.pickle", "wb") as f:
        pickle.dump(annotations, f)
    return out_root
