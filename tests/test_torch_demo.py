"""The port's streaming demo against the JAX package's on the CPU: the
demo step against ``ev2hands_tpu.demo.make_demo_step`` (the ``device``
mesh pane, whose step also returns the splat pane's projected vertices),
``rasterize_mesh`` against the JAX package's on the same vertices, the
painters, and ``run_demo`` writing an mp4 with every window of a partial
tail batch for both panes.

Small size: n_points=128, a 64x48 sensor, B=2, a synthetic recording.
The regressors' translation bias puts both hands 0.4 m in front of the
camera (OpenGL: -z), so the meshes project into the image.
"""

import collections

import cv2
import jax
import numpy as np
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu import demo as jdemo
from ev2hands_tpu.config import Config as JConfig
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.config import SensorConfig as JSensorConfig
from ev2hands_tpu.datagen import rasterizer as jr
from ev2hands_tpu.mano import create_mano_hands
from ev2hands_tpu.mano import synthetic_mano_models as j_synthetic
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import demo as tdemo
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig, SensorConfig
from ev2hands_tpu_torch.datagen import rasterizer as tr
from ev2hands_tpu_torch.events.real_streams import (
    RealStream,
    sliding_window_batches,
    write_synthetic_ev2hands_r,
)
from ev2hands_tpu_torch.model import tehnet as tt

from test_torch_serving import jax_real_indices, uniforms_for

B, N, W, H = 2, 128, 64, 48
CHUNKS = dict(dense_chunk=128, regressor_dense_chunk=128)
CFG = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H), model=ModelConfig(n_points=N, **CHUNKS))
# what JAX's demo step reads of a train state (a pytree)
JState = collections.namedtuple("JState", "params batch_stats")
# the vertex gate of the slice tests, in meters
VERTEX_TOL = 1e-4


def seeded_state():
    """Seeded weights with both hands' translation at z = -0.4 m."""
    state = tw.init_weights(torch.Generator().manual_seed(0), CFG.model)
    for side in ("left", "right"):
        state[f"{side}_mano_regressor.mano_regressor.4.bias"][-1] = -0.4
    return state


def pixel_tolerance(verts_m, cfg, tol_m=VERTEX_TOL):
    """A bound, to first order, on how far a vertex moved by ``tol_m`` in
    each coordinate moves its pixel: ``0.5 * size * p * tol * (1 / |z| +
    (|x| + |y|) / z^2)`` with ``p`` the projection's focal term, in mm."""
    v = np.asarray(verts_m, np.float64).reshape(-1, 3) * 1e3
    p = cfg.camera.projection_matrix(cfg.sensor.width, cfg.sensor.height)
    scale = 0.5 * max(cfg.sensor.width * p[0, 0], cfg.sensor.height * p[1, 1])
    z = np.abs(v[:, 2])
    return float(np.max(scale * tol_m * 1e3 * (1 / z + (np.abs(v[:, 0]) + np.abs(v[:, 1])) / z**2)))


@pytest.fixture(scope="module")
def recording(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("real") / "subject_1.pickle")
    return write_synthetic_ev2hands_r(path, n_events=30_000, n_frames=20, width=W, height=H)


@pytest.fixture(scope="module")
def stepped(recording):
    """One batch of the recording through both demo steps (device pane)."""
    batch = next(sliding_window_batches(RealStream(recording, W, H), B, with_gt=False))
    key = jax.random.PRNGKey(7)
    state = seeded_state()
    jcfg = JConfig(sensor=JSensorConfig(W, H),
                   model=JModelConfig(n_points=N, fps_deterministic=True, **CHUNKS))
    hands = create_mano_hands(j_synthetic(0))
    jstep = jdemo.make_demo_step(
        jt.TEHNet(cfg=jcfg.model), {s: h.params for s, h in hands.items()}, jcfg,
        faces={s: np.asarray(h.faces) for s, h in hands.items()}, mesh_render="device")
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in state.items()})
    ref = jax.device_get(jstep(JState(**variables), batch["events"],
                               batch["event_valid"], key))

    net = tt.TEHNet(CFG.model, device="cpu")
    net.load_state_dict(state, strict=True)
    hands = ttr.build_hands(CFG, synthetic=True, device="cpu")
    idx, n_valid = jax_real_indices(batch["events"], batch["event_valid"], key)
    step = tdemo.make_demo_step(net.eval(), hands, CFG, "device")
    got = step(torch.from_numpy(batch["events"]), torch.from_numpy(batch["event_valid"]),
               torch.from_numpy(uniforms_for(idx, n_valid)))
    return ref, {k: v.numpy() for k, v in got.items()}


def test_demo_step_matches_jax(stepped):
    """Segmentation and polarity equal; event pixels within 1e-4 px (JAX's
    jitted normalisation is one ulp off its formula); projected vertices
    within the pixel bound of the 1e-4 m vertex gate; the rasterised pane
    equal but on pixels where the two sides' vertices (1e-6 m apart) put a
    triangle edge through the pixel centre differently, at most 1% of the
    covered pixels, with the shading within 1e-4 where the class agrees."""
    ref, got = stepped
    assert set(ref) < set(got)    # the port's step also returns the vertices
    np.testing.assert_array_equal(got["seg"], ref["seg"])
    np.testing.assert_array_equal(got["polarity"], ref["polarity"])
    np.testing.assert_allclose(got["xy"], ref["xy"], rtol=0, atol=1e-4)
    for side in ("left", "right"):
        tol = pixel_tolerance(got[f"verts_{side}"], CFG)
        assert 0 < tol < 0.1
        np.testing.assert_allclose(got[f"px_{side}"], ref[f"px_{side}"], rtol=0,
                                   atol=tol, err_msg=side)
    cls, rcls = got["mesh_cls"], ref["mesh_cls"]
    assert cls.shape == (B, H, W) and cls.dtype == np.int32
    assert (rcls > 0).sum() > 100                      # the meshes are in view
    differ = cls != rcls
    assert differ.sum() <= 0.01 * (rcls > 0).sum(), int(differ.sum())
    np.testing.assert_allclose(got["mesh_shade"][~differ], ref["mesh_shade"][~differ],
                               rtol=0, atol=1e-4)


def _raster_case():
    """Both synthetic hands 0.4 m in front of the camera, the left one
    moved 3 cm to the side, in mm as the demo step passes them."""
    hands = ttr.build_hands(CFG, synthetic=True, device="cpu")
    vl = hands["left"].v_template + torch.tensor([-0.03, 0.0, -0.4])
    vr = hands["right"].v_template + torch.tensor([0.03, 0.0, -0.4])
    n_v = vl.shape[0]
    faces = torch.cat([hands["left"].faces, hands["right"].faces + n_v])
    materials = torch.cat([torch.ones(len(hands["left"].faces), dtype=torch.int32),
                           torch.full((len(hands["right"].faces),), 2, dtype=torch.int32)])
    proj = torch.as_tensor(CFG.camera.projection_matrix(W, H), dtype=torch.float32)
    proj = proj * torch.tensor([[-1.0], [1.0], [1.0], [1.0]])
    return torch.cat([vl, vr]) * 1e3, faces, materials, proj


def test_rasterize_mesh_matches_jax():
    """The same vertices through both rasterizers: class ids equal,
    intensity and depth within 1e-5 (depth in mm, relative)."""
    verts, faces, materials, proj = _raster_case()
    ref = jr.rasterize_mesh(verts.numpy(), faces.numpy().astype(np.int32),
                            materials.numpy(), proj.numpy(), width=W, height=H)
    got = tr.rasterize_mesh(verts, faces, materials, proj, W, H)
    assert (np.asarray(ref.class_id) > 0).sum() > 100
    np.testing.assert_array_equal(got.class_id.numpy(), np.asarray(ref.class_id))
    np.testing.assert_allclose(got.intensity.numpy(), np.asarray(ref.intensity),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-5,
                               atol=0)


def test_painters_match_jax():
    """Every painter gives the JAX package's image bit for bit."""
    rng = np.random.RandomState(2)
    xy = rng.uniform(-2, W + 2, (300, 2)).astype(np.float32)
    pol = rng.randint(0, 4, (300, 2)).astype(np.float32)
    seg = rng.randint(0, 5, 300)
    pl, pr = (rng.uniform(-5, W + 5, (778, 2)).astype(np.float32) for _ in range(2))
    cls = rng.randint(0, 3, (H, W)).astype(np.int32)
    shade = rng.uniform(0, 1.2, (H, W)).astype(np.float32)
    for got, ref in (
            (tdemo.render_event_frame(xy, pol, W, H), jdemo.render_event_frame(xy, pol, W, H)),
            (tdemo.render_segmentation(xy, seg, W, H), jdemo.render_segmentation(xy, seg, W, H)),
            (tdemo.paint_mesh_splat(pl, pr, W, H), jdemo.paint_mesh_splat(pl, pr, W, H)),
            (tdemo.colorize_mesh_raster(cls, shade), jdemo.colorize_mesh_raster(cls, shade))):
        assert got.dtype == ref.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("mesh_render", ["splat", "device"])
def test_run_demo_writes_every_window(recording, tmp_path, mesh_render):
    """3 windows at B=2: the tail batch holds one real window, which is
    painted too; the mp4 holds 3 frames of [H, 3W]."""
    path = str(tmp_path / f"demo_{mesh_render}.mp4")
    writer = tdemo.open_video_writer(path, 25, 3 * W, H)
    try:
        report = tdemo.run_demo(recording, writer, batch_size=2, max_windows=3,
                                synthetic_mano=True, mesh_render=mesh_render, cfg=CFG,
                                device="cpu")
    finally:
        writer.release()
    assert report["frames"] == 3 and report["steady_state_windows"] == 1
    cap = cv2.VideoCapture(path)
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(frame)
        ok, frame = cap.read()
    cap.release()
    assert len(frames) == 3 and frames[0].shape == (H, 3 * W, 3)


def test_video_writer_needs_opencv(monkeypatch, tmp_path):
    """Without OpenCV the command line's mp4 writer says so; it does not
    write something else."""
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tdemo.open_video_writer(str(tmp_path / "x.mp4"), 25, 3 * W, H)
