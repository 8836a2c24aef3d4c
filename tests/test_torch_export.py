"""The port's serving export on the CPU: ``export.export_serving`` saved
to a ``.pt2`` and loaded back with ``export.load_serving`` against the live
serving function (bitwise), the registered kernel ops in the exported
graphs (one node per call), and an sa1-style layer exported on the
block-sparse route, per scale and fused. The serving function itself is
held against the JAX package's in ``tests/test_torch_serving.py``.

Small size: n_points=128, a 64x48 sensor, B=2 windows of up to 256
events. The program is exported, saved and loaded once per module.
"""

import numpy as np
import pytest
import torch

from ev2hands_tpu_torch import export as tex
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig, SensorConfig
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt

B, MAX_EVENTS, N, W, H = 2, 256, 128, 64, 48
# one centroid chunk a scale: the same function, fewer graph nodes to export
CHUNKS = dict(dense_chunk=128, regressor_dense_chunk=128)
HAND_KEYS = tex.HAND_KEYS


def real_windows(rng):
    """Padded real windows (x, y, t in ms, polarity) with a validity mask."""
    ev = np.stack([
        rng.randint(0, W, (B, MAX_EVENTS)), rng.randint(0, H, (B, MAX_EVENTS)),
        np.sort(rng.uniform(0, 2, (B, MAX_EVENTS))), rng.randint(0, 2, (B, MAX_EVENTS)),
    ], -1).astype(np.float32)
    valid = np.arange(MAX_EVENTS)[None] < np.array([[MAX_EVENTS], [MAX_EVENTS * 3 // 4]])
    return ev, valid


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    rng = np.random.RandomState(1)
    events, valid = real_windows(rng)
    cfg = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H),
                                 model=ModelConfig(n_points=N, **CHUNKS))
    net = tt.TEHNet(cfg.model, device="cpu")
    net.load_state_dict(tw.init_weights(torch.Generator().manual_seed(0), cfg.model))
    net.eval()
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    inputs = (torch.from_numpy(events), torch.from_numpy(valid),
              torch.rand((B, N), generator=torch.Generator().manual_seed(2),
                         dtype=torch.float64))
    with torch.no_grad():
        live = tex.make_serving_fn(net, hands, cfg)(*inputs)
    path = str(tmp_path_factory.mktemp("export") / "serving.pt2")
    program = tex.export_serving(net, hands, cfg, B, MAX_EVENTS, path=path)
    return dict(live=live, inputs=inputs, program=program,
                loaded=tex.load_serving(path))


def test_saved_program_matches_live_bitwise(exported):
    """Saved to disk and loaded back, the program gives the live serving
    function's outputs bit for bit."""
    got = exported["loaded"](*exported["inputs"])
    assert set(got) == set(exported["live"])
    for k, v in exported["live"].items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_exported_graph_holds_one_fps_node_per_call(exported):
    """sa1, sa2 and the heads' shared draw: three FPS nodes. At this size
    no scale takes the block-sparse route."""
    assert tex.op_counts(exported["program"]) == {"fps": 3}


def _layer_case(fused):
    rng = np.random.RandomState(4)
    Np, D = 256, 5
    layer = tl.SetAbstractionMsg(
        64, (0.2, 0.4), (16, 32), D, ((8, 8, 16), (8, 12, 16)), pallas_nb=64,
        pallas_fused=fused, device="cpu")
    sd = {k: torch.from_numpy(np.abs(rng.randn(*v.shape)).astype(np.float32) * 0.3 + 0.5
                              if k.endswith("running_var") else
                              rng.randn(*v.shape).astype(np.float32) * 0.3)
          for k, v in layer.state_dict().items()}
    layer.load_state_dict(sd)
    xyz = torch.from_numpy(np.clip(rng.randn(2, Np, 3) * 0.4, -1, 1).astype(np.float32))
    pts = torch.from_numpy(rng.randn(2, Np, D).astype(np.float32))
    return layer.eval(), (xyz, pts)


@pytest.mark.parametrize("fused", [False, True], ids=["per_scale", "fused"])
def test_exported_layer_holds_the_grouping_ops(monkeypatch, fused):
    """An sa1-style layer on the block-sparse route exports with one
    grouping node per scale (one fused node with ``pallas_fused``) and one
    FPS node, and the exported program gives the layer's bits."""
    monkeypatch.setattr(tl, "SPARSE_MIN_PAIRS", 0)
    layer, args = _layer_case(fused)
    with torch.no_grad():
        want = layer(*args)
        program = torch.export.export(layer, args, strict=False)
    got = program.module()(*args)
    assert tex.op_counts(program) == (
        {"fps": 1, "msg_fused_scales_sparse": 1} if fused
        else {"fps": 1, "msg_scale_sparse": 2})
    for a, b in zip(got, want):
        assert torch.equal(a, b)
