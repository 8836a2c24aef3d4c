"""Device introspection: the card's memory statistics and a timer that
waits for the card.

Counterpart of ``ev2hands_tpu/utils/device.py`` on ``torch.cuda``.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch


def get_device_memory_usage() -> List[Dict]:
    """Per CUDA device: memory in use, its peak and the device's total, in
    MB (``torch.cuda.memory_stats``, PyTorch's allocator); an empty list
    without a card."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
            "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 2**20,
            "peak_bytes_in_use_mb": stats.get("allocated_bytes.all.peak", 0) / 2**20,
            "bytes_limit_mb": torch.cuda.get_device_properties(i).total_memory / 2**20,
        })
    return out


@contextmanager
def device_timer(label: str = "", result: Optional[Dict] = None):
    """Times a block to the end of the card's work: synchronises the card
    (when there is one) before reading the clock, and stores the seconds
    in ``result['seconds']``; prints them when ``label`` is given."""
    store = result if result is not None else {}
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    yield store
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    store["seconds"] = time.perf_counter() - t0
    if label:
        print(f"[{label}] {store['seconds'] * 1e3:.2f} ms")
