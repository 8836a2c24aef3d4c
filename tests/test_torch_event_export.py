"""The serving export with an event mesh on the CPU
(``export.export_serving(event_mesh=...)``, ``tests/test_export.py:119``):
one artifact for a (data 1, event 2) mesh, exported by this process (the
trace runs no collective) and loaded on two gloo ranks with
``load_serving(event_mesh=...)``, against the one-device serving function
of the same weights on the same windows, within rtol = atol = 1e-5 (the JAX
test's bound), and against each rank's eager event route bitwise; its graph
holds the event ops and no other collective. The one-device function is
its own loaded ``.pt2`` bit for bit at this configuration
(``tests/test_torch_export.py::test_saved_program_matches_live_bitwise``).

Small size, as ``tests/test_torch_export.py``: n_points=128, a 64x48
sensor, B=2 windows of up to 256 events. The ranks start first and run the
eager route while the artifact is exported.
"""

import os
import time

import numpy as np
import pytest
import torch

from ev2hands_tpu_torch import export as tex
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig, SensorConfig
from ev2hands_tpu_torch.model.tehnet import TEHNet
from ev2hands_tpu_torch.parallel import mesh as pm

B, MAX_EVENTS, N, W, H = 2, 256, 128, 64, 48
N_EVENT = 2
CHUNKS = dict(dense_chunk=128, regressor_dense_chunk=128)


def setup(event_parallel):
    """(cfg, the seeded net in eval, synthetic hands, the inputs)."""
    cfg = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H), model=ModelConfig(
        n_points=N, event_parallel=event_parallel, **CHUNKS))
    rng = np.random.RandomState(1)
    events = np.stack([
        rng.randint(0, W, (B, MAX_EVENTS)), rng.randint(0, H, (B, MAX_EVENTS)),
        np.sort(rng.uniform(0, 2, (B, MAX_EVENTS))), rng.randint(0, 2, (B, MAX_EVENTS)),
    ], -1).astype(np.float32)
    valid = np.arange(MAX_EVENTS)[None] < np.array([[MAX_EVENTS], [MAX_EVENTS * 3 // 4]])
    inputs = (torch.from_numpy(events), torch.from_numpy(valid),
              torch.rand((B, N), generator=torch.Generator().manual_seed(2),
                         dtype=torch.float64))
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    return cfg, hands, inputs


def make_net(cfg, event_mesh=None):
    net = TEHNet(cfg.model, device="cpu", event_mesh=event_mesh)
    net.load_state_dict(tw.init_weights(torch.Generator().manual_seed(0), cfg.model))
    return net.eval()


def rank_serve(path):
    """A rank of the (data 1, event 2) mesh: the eager event route, then
    the artifact at ``path`` once it is written -> (the loaded program's
    outputs, the eager route's), as numpy."""
    torch.set_num_threads(2)
    mesh = pm.create_event_mesh(N_EVENT, 1, device="cpu")
    cfg, hands, inputs = setup(True)
    with torch.no_grad():
        eager = tex.make_serving_fn(make_net(cfg, mesh), hands, cfg)(*inputs)
    deadline = time.monotonic() + 240
    while not os.path.exists(path) and time.monotonic() < deadline:
        time.sleep(0.1)
    got = tex.load_serving(path, event_mesh=mesh)(*inputs)
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in eager.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results, the one-device outputs, the program's op
    counts)."""
    path = str(tmp_path_factory.mktemp("event_export") / "event.pt2")
    ranks = pm.start_ranks(rank_serve, N_EVENT, path, env={"OMP_NUM_THREADS": "2"})
    # rank 0's mesh without its process group: tracing needs only the
    # event ranks' count
    mesh = pm.Mesh(None, None, None, 0, 1, 0, N_EVENT, torch.device("cpu"))
    cfg, hands, inputs = setup(True)
    program = tex.export_serving(make_net(cfg, mesh), hands, cfg, B, MAX_EVENTS,
                                 event_mesh=mesh)
    torch.export.save(program, path + ".tmp")
    os.replace(path + ".tmp", path)
    cfg, hands, inputs = setup(False)
    with torch.no_grad():
        single = tex.make_serving_fn(make_net(cfg), hands, cfg)(*inputs)
    return (ranks.join(timeout=300), {k: v.numpy() for k, v in single.items()},
            tex.op_counts(program))


def test_event_mesh_artifact_matches_one_device_artifact(runs):
    """Both ranks' outputs of the loaded event-mesh artifact within rtol =
    atol = 1e-5 of the one-device function's; the segmentation equal."""
    results, single, _ = runs
    for got, _ in results:
        assert set(got) == set(single)
        for k, v in single.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_array_equal(got["seg"], single["seg"])


def test_event_mesh_artifact_matches_eager_route_bitwise(runs):
    """The loaded program gives the eager event route's bits on each rank."""
    for got, eager in runs[0]:
        for k, v in eager.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_event_mesh_graph_holds_the_event_ops(runs):
    """No kernel op (the event route shards FPS and the grouping in plain
    torch) and no collective outside the event ops: one sharded-FPS node a
    draw (sa1, sa2, the heads' shared one), and for each of the 9 dense
    scales (sa1's 3, sa2's 2, 2 a head) two all-gathers (the shards'
    in-radius counts, the pooled max), two shards (xyz, points) and two
    reads of the event rank (the count offset, the empty-ball fallback)."""
    counts = runs[2]
    assert counts == {"event_fps": 3, "event_all_gather": 18, "event_shard": 18,
                      "event_rank": 18}, counts
