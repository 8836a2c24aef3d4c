"""The frozen reference against the port's plain routes on the CPU, at
N <= 256: its pieces one by one, then whole runs of each cell, whose
compared numbers must be small."""

import numpy as np
import pytest
import torch

from conftest import small_run

import generator
from reference import erpc, mano, model, ops


@pytest.fixture(scope="module")
def raw():
    mix = {"events_per_window": 256, "window_ms": 5.0, "noise_share": 0.05,
           "hand_size_m": [0.09, 0.18], "hand_x_m": 0.1, "hand_z_m": 0.4,
           "one_hand_share": 0.2, "edge_jitter_px": 1.5,
           "pose_scale": {"global_orient": 0.2, "hand_pose": 0.3, "shape": 0.5, "trans": 0.1}}
    win = generator.make_windows(7, 4, mix)
    return win, torch.from_numpy(generator.raw_events(win)), torch.from_numpy(win["labels"])


def test_erpc_matches_the_port(raw):
    """Bitwise, with the augmentation's draws taken in the same order."""
    from ev2hands_tpu_torch.events.erpc import erpc_batch_transform

    _, events, labels = raw
    for augment in (False, True):
        g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
        got = erpc_batch_transform(events, labels, g1, n_out=256, augment=augment)
        want, want_labels = erpc.transform(events, labels, g2, 346, 260, 256, augment=augment)
        torch.testing.assert_close(got.events, want, rtol=0, atol=0)
        np.testing.assert_array_equal(got.labels.numpy(), want_labels.numpy())


def test_fps_ball_query_and_interpolation_match_the_port(raw):
    from ev2hands_tpu_torch.ops import pointnet

    xyz = torch.rand(2, 256, 3)
    start = torch.tensor([3, 100], dtype=torch.int32)
    np.testing.assert_array_equal(ops.farthest_point_sample(xyz, 64, start).numpy(),
                                  pointnet.farthest_point_sample(xyz, 64, start).long().numpy())
    sq = ops.square_distance(xyz[:, :16], xyz)
    np.testing.assert_array_equal(sq.numpy(), pointnet.square_distance(xyz[:, :16], xyz).numpy())
    for r, k in ((0.1, 8), (0.4, 32)):
        np.testing.assert_array_equal(ops.ball_query(r, k, sq).numpy(),
                                      pointnet.query_ball_point(r, k, sq).numpy())
    pts = torch.randn(2, 16, 7)
    torch.testing.assert_close(ops.three_nn_interpolate(xyz, xyz[:, :16], pts),
                               pointnet.three_nn_interpolate(xyz, xyz[:, :16], pts))


def test_mano_matches_the_port():
    from ev2hands_tpu_torch.mano.layer import create_mano_params, mano_forward
    from ev2hands_tpu_torch.mano.model_data import ManoModelData, synthetic_mano_models

    arrays = mano.synthetic_hands(0)
    port = synthetic_mano_models(0)
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(3, n, generator=g) * s for n, s in ((3, 0.3), (6, 0.5), (10, 0.5), (3, 0.1))]
    for side in ("left", "right"):
        for k, v in arrays[side].items():
            np.testing.assert_array_equal(v, getattr(port[side], k))
        want = mano_forward(create_mano_params(ManoModelData(side=side, **arrays[side]),
                                               device="cpu"), *args)
        v, j = mano.forward(mano.hand(arrays[side], side, "cpu"), *args)
        torch.testing.assert_close(v, want.vertices, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(j, want.joints, rtol=1e-5, atol=1e-6)


def test_state_layout_loads_into_the_port():
    from ev2hands_tpu_torch.model.tehnet import TEHNet

    net = TEHNet(device="meta")
    want = {k: tuple(v.shape) for k, v in net.state_dict().items()}
    assert want == model.layout()


@pytest.mark.parametrize("cell, limits", [
    ("stream-b8", {"logits_gap": 1e-5, "mano_gap": 1e-5, "mesh_gap": 1e-5}),
    ("eval-s-b32", {"joints_gap": 1e-5, "verts_gap": 1e-5, "gt_gap": 1e-5}),
])
def test_inference_runs_agree(cell, limits):
    res = small_run(cell)
    assert res["correct"], res["checks"]
    for k, limit in limits.items():
        value = res["checks"][k]["value"] if k in res["checks"] else res["readings"][k]
        assert value < limit, (k, value)


def test_training_steps_agree():
    res = small_run("train-b8", batch=4)
    assert res["correct"], res["checks"]
    got = {**res["readings"], **{k: c["value"] for k, c in res["checks"].items()}}
    assert got["loss1_gap"] < 1e-6 and got["grad_gap"] < 1e-4, got
