"""The native batch loader of Ev2Hands-S training: ctypes bindings for
``csrc/ev2hands_loader.cpp``.

Counterpart of ``ev2hands_tpu/events/native_loader.py``. The event rows
live once in memory that the C++ library borrows, and fixed-shape batches
are filled by a pool of threads, in place of per-window numpy slicing
(``events.streams.Ev2HandSReader``, whose windows it equals). The library
is the port's own copy of the source, compiled with ``g++`` into
``build/host/`` on first use (``ops/_build.load_host``).

``fill_random(step)`` draws a batch's window starts from an mt19937_64
seeded with ``seed ^ (step * 0x9E3779B97F4A7C15)``, so batch ``step`` is
the same in every run and in both packages.
"""

from __future__ import annotations

import ctypes
import pickle
from typing import Dict, Iterator, List, Optional

import numpy as np

from ev2hands_tpu_torch.events.streams import pack_mano_gt, stack_samples

_LIB = None


def get_library() -> ctypes.CDLL:
    """The loader library, built on first use; raises if it does not
    build."""
    global _LIB
    if _LIB is None:
        from ev2hands_tpu_torch.ops._build import load_host

        lib = load_host("ev2hands_loader")
        lib.ev2hands_loader_create.restype = ctypes.c_void_p
        lib.ev2hands_loader_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_uint64]
        lib.ev2hands_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.ev2hands_loader_len.restype = ctypes.c_int64
        lib.ev2hands_loader_len.argtypes = [ctypes.c_void_p]
        lib.ev2hands_loader_fill.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.ev2hands_loader_fill_random.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the loader library builds and loads here."""
    try:
        get_library()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeEv2HandSLoader:
    """Random-window batches over Ev2Hands-S event rows [x, y, t, p,
    annotation_index, event_label], filled by the native library.
    ``n_threads`` 0 takes every hardware thread."""

    def __init__(self, root: str, n_events: int = 2048, n_threads: int = 0,
                 seed: int = 0):
        """Reads ``{root}.h5`` (decoded once, about 48 bytes an event) and
        ``{root}_anno.pickle``."""
        import h5py

        with open(f"{root}_anno.pickle", "rb") as f:
            annotations = pickle.load(f)
        with h5py.File(f"{root}.h5", "r") as f:
            rows = np.asarray(f["event"], np.int64)
        self._init(rows, annotations, n_events, n_threads, seed)

    @classmethod
    def from_rows(cls, rows: np.ndarray, annotations: List[Dict],
                  n_events: int = 2048, n_threads: int = 0,
                  seed: int = 0) -> "NativeEv2HandSLoader":
        """A loader over event rows [n, 6] held in memory (no ``h5py``)."""
        loader = cls.__new__(cls)
        loader._init(rows, annotations, n_events, n_threads, seed)
        return loader

    def _init(self, rows, annotations, n_events, n_threads, seed):
        self._handle = None
        self._lib = get_library()
        self.n_events = n_events
        self.annotations = annotations
        # the library borrows this buffer: keep it as long as the handle
        self._rows = np.ascontiguousarray(rows, np.int64)
        if self._rows.ndim != 2 or self._rows.shape[1] != 6 or not len(self._rows):
            raise ValueError(f"event rows must be [n > 0, 6], got {self._rows.shape}")
        self._handle = self._lib.ev2hands_loader_create(
            _ptr(self._rows), self._rows.shape[0], n_threads, seed)

    def __len__(self) -> int:
        return int(self._lib.ev2hands_loader_len(self._handle))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.ev2hands_loader_destroy(self._handle)
            self._handle = None

    def fill_batch(self, batch_size: int, step: Optional[int] = None,
                   starts: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """One raw batch: 'events' [B, N, 4] float32, 'labels' [B, N] int32
        and the MANO ground truth of each window's last row, from the given
        window ``starts`` or from the random starts of batch ``step``."""
        B, N = batch_size, self.n_events
        events = np.empty((B, N, 4), np.float32)
        labels = np.empty((B, N), np.int32)
        annos = np.empty((B,), np.int64)
        if starts is not None:
            starts = np.ascontiguousarray(starts, np.int64)
            if starts.shape != (B,):
                raise ValueError(f"starts must be [{B}], got {starts.shape}")
            self._lib.ev2hands_loader_fill(self._handle, _ptr(starts), B, N,
                                           _ptr(events), _ptr(labels), _ptr(annos))
        else:
            starts = np.empty((B,), np.int64)
            self._lib.ev2hands_loader_fill_random(
                self._handle, int(step or 0), B, N, _ptr(starts), _ptr(events),
                _ptr(labels), _ptr(annos))
        gts = stack_samples([pack_mano_gt(self.annotations[int(a)]) for a in annos])
        return {"events": events, "labels": labels, **gts}

    def batches(self, batch_size: int, max_batches: Optional[int] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches ``fill_batch(step=0)``, ``step=1``, ..."""
        step = 0
        while max_batches is None or step < max_batches:
            yield self.fill_batch(batch_size, step=step)
            step += 1
