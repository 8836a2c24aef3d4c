"""The traffic generator: deterministic for a seed, different across
seeds, and windows of hand-sized clusters, noise and labels as the mixes
state."""

import json
import os

import numpy as np
import pytest

import generator

MIX = json.load(open(os.path.join(os.path.dirname(os.path.dirname(__file__)),
                                  "traffic", "stream-b8.json")))


@pytest.fixture(scope="module")
def win():
    return generator.make_windows(2 ** 31 + 11, 64, MIX)


def test_same_seed_same_windows(win):
    again = generator.make_windows(2 ** 31 + 11, 64, MIX)
    for k in win:
        np.testing.assert_array_equal(win[k], again[k])


def test_other_seed_other_windows(win):
    other = generator.make_windows(2 ** 31 + 12, 64, MIX)
    assert not np.array_equal(win["x"], other["x"])
    assert not np.array_equal(win["trans"], other["trans"])


def test_window_layout(win):
    W, E = win["x"].shape
    assert (W, E) == (64, MIX["events_per_window"])
    assert win["x"].min() >= 0 and win["x"].max() < 346
    assert win["y"].min() >= 0 and win["y"].max() < 260
    assert set(np.unique(win["p"])) <= {0, 1}
    # timestamps sorted within a window, windows after one another
    assert (np.diff(win["t"], axis=1) >= 0).all()
    assert (win["t"][1:, 0] >= win["t"][:-1, -1]).all()
    span = win["t"][:, -1] - win["t"][:, 0]
    assert span.max() <= MIX["window_ms"] * 1e6


def test_labels_and_noise_share(win):
    labels = win["labels"]
    assert set(np.unique(labels)) <= {1, 2, 3}
    assert abs((labels == 3).mean() - MIX["noise_share"]) < 0.01
    # an absent left hand gives no left events and an invalid left slot
    gone = win["valid"][:, 0] == 0
    assert gone.any() and not (labels[gone] == 1).any()
    np.testing.assert_array_equal(win["handedness"][gone, 0], 0)
    np.testing.assert_array_equal(win["trans"][gone, 0], win["trans"][gone, 1])


def test_hands_are_clusters_of_hand_size(win):
    """Hand events span about 110 x 220 px at 0.4 m: more than a noise-free
    blob, far less than the sensor."""
    for w in range(8):
        for label in (1, 2):
            sel = win["labels"][w] == label
            if sel.sum() < 100:
                continue
            wx = np.percentile(win["x"][w][sel], 99) - np.percentile(win["x"][w][sel], 1)
            hy = np.percentile(win["y"][w][sel], 99) - np.percentile(win["y"][w][sel], 1)
            assert 50 < wx < 260 and 100 < hy < 260
    # events sit on outlines: far fewer distinct pixels than a uniform spray
    occupied = len(np.unique(win["y"][0] * 346 + win["x"][0]))
    assert occupied < 0.97 * MIX["events_per_window"]


def test_rows_in_the_ev2hands_s_layout(win):
    rows, annotations = generator.rows(win)
    W, E = win["x"].shape
    assert rows.shape == (W * E, 6) and rows.dtype == np.int64
    np.testing.assert_array_equal(rows[E:2 * E, 4], 1)        # annotation of window 1
    np.testing.assert_array_equal(rows[:E, 5], win["labels"][0])
    assert len(annotations) == W
    for w in range(W):
        assert ("left" in annotations[w]) == bool(win["valid"][w, 0])
        assert "right" in annotations[w]


def test_batch_layout(win):
    b = generator.batch(win, slice(0, 4))
    assert b["events"].shape == (4, MIX["events_per_window"], 4)
    assert b["events"].dtype == np.float32
    assert b["left"]["hand_pose"].shape == (4, 45)
    assert b["handedness"].shape == (4, 2)
