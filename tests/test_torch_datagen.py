"""The port's synthetic Ev2Hands-S generation (``ev2hands_tpu_torch/datagen``)
against the JAX package's on the CPU.

Tolerances: the shaded rasteriser's class ids equal, RGB within 1e-5; the
background's deterministic part within 3e-7 of ``jax.image.resize`` on the
same uniforms (``F.interpolate`` computes its source coordinates by its own
formula: up to 4 ulps of values in [0.5, 1)); forearm vertices within 1e-6; interpolation, the InterHand adapter, the stitcher
and the pre-rasterised ERPC writer and reader equal. ``simulate_sequence``
(realistic mode, given JAX's light and background draws) gives equal class
maps and a frame's event count within 1% of JAX's: the log frames may
differ by one ulp (pow and log), so an event may flip at a threshold.

Small sizes, as ``tests/test_datagen.py``: a 64x48 sensor, 3-4 frames, one
JAX compile a function.
"""

import json
import pickle

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.config import SensorConfig as JSensorConfig
from ev2hands_tpu.datagen import erpc_writer as jw
from ev2hands_tpu.datagen import generate as jg
from ev2hands_tpu.datagen import interhand as jih
from ev2hands_tpu.datagen import interpolate as jip
from ev2hands_tpu.datagen import meshes as jm
from ev2hands_tpu.datagen import rasterizer as jr
from ev2hands_tpu.datagen import stitch as jst
from ev2hands_tpu.datagen import visualize as jvis
from ev2hands_tpu.events.streams import Ev2HandSReader as JReader
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, SensorConfig
from ev2hands_tpu_torch.datagen import erpc_writer as tw
from ev2hands_tpu_torch.datagen import generate as tg
from ev2hands_tpu_torch.datagen import interhand as tih
from ev2hands_tpu_torch.datagen import interpolate as tip
from ev2hands_tpu_torch.datagen import meshes as tm
from ev2hands_tpu_torch.datagen import rasterizer as tr
from ev2hands_tpu_torch.datagen import stitch as tst
from ev2hands_tpu_torch.datagen import visualize as tvis
from ev2hands_tpu_torch.events.erpc import erpc_preraster_batch_transform
from ev2hands_tpu_torch.events.streams import Ev2HandSReader, synthetic_ev2hands_s
from ev2hands_tpu_torch.mano import model_data as tmd

W, H = 64, 48
CFG = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H))
JCFG_SMALL = JCFG.replace(sensor=JSensorConfig(width=W, height=H))


@pytest.fixture(scope="module")
def models():
    return tmd.synthetic_mano_models(0)


def make_frames(n=4):
    """A short two-hand sequence in front of the camera, both hands moving
    (``tests/test_datagen.py``'s)."""
    frames = []
    for i in range(n):
        hands = []
        for side, x0 in (("left", -0.06), ("right", 0.06)):
            pose = np.zeros(48, np.float32)
            pose[:3] = [0, 0.2 * i / n, 0]
            hands.append({"hand_type": side, "pose": pose,
                          "shape": np.zeros(10, np.float32),
                          "trans": np.asarray([x0 + 0.01 * i, 0, -0.45], np.float32)})
        frames.append(hands)
    return frames


def _scene(models):
    """Both hands at the template pose 0.45 m in front of the camera, with
    forearms: (vertices [V, 3], faces, materials, vertex colours)."""
    faces, materials, n_total, _ = tg.scene_topology(models["left"].faces, CFG)
    verts = []
    for side, x0 in (("left", -0.06), ("right", 0.06)):
        v = models[side].v_template + np.float32([x0, 0.0, -0.45])
        verts += [v, tm.forearm_mesh(v[0].astype(np.float64), np.array([0.0, -1.0, 0.2]))[0]]
    colors = tm.random_skin_vertex_colors(n_total, np.random.RandomState(0))
    return np.concatenate(verts).astype(np.float32), faces, materials, colors


def _proj():
    return CFG.camera.projection_matrix(W, H).astype(np.float32)


def test_rasterize_scene_and_render_two_hands_match_jax(models):
    """The realistic scene (two hands and forearms, 3,140 triangles) with
    JAX's light draws through both shaded rasterisers: class ids equal, RGB
    within 1e-5 and depth within rtol 1e-6; render_two_hands' class ids
    equal and intensity within 1e-5."""
    verts, faces, materials, colors = _scene(models)
    lp, li = (np.asarray(x) for x in jr.sample_train_lights(jax.random.PRNGKey(0)))
    ref = jr.rasterize_scene(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(materials),
                             jnp.asarray(colors), jnp.asarray(lp), jnp.asarray(li),
                             jnp.asarray(_proj()), W, H)
    got = tr.rasterize_scene(*(torch.from_numpy(np.array(a)) for a in
                               (verts, faces, materials, colors, lp, li, _proj())), W, H)
    cls = got.class_id.numpy()
    np.testing.assert_array_equal(cls, np.asarray(ref.class_id))
    assert set(np.unique(cls)) == {0, 1, 2, tg.FOREARM_MATERIAL}
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(ref.rgb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth), rtol=1e-6, atol=0)
    assert got.rgb[got.class_id > 0].std(dim=0).max() > 1e-3   # Gouraud, not flat

    V = 778
    vl, vr = verts[:V], verts[V + 65:2 * V + 65]
    ref2 = jr.render_two_hands(jnp.asarray(vl), jnp.asarray(vr), models["left"].faces,
                               jnp.asarray(_proj()), W, H)
    got2 = tr.render_two_hands(torch.from_numpy(vl), torch.from_numpy(vr),
                               models["left"].faces, torch.from_numpy(_proj()), W, H)
    np.testing.assert_array_equal(got2.class_id.numpy(), np.asarray(ref2.class_id))
    np.testing.assert_allclose(got2.intensity.numpy(), np.asarray(ref2.intensity),
                               rtol=0, atol=1e-5)


def test_lights_and_background_match_jax():
    """background_from_draws on JAX's uniforms within 3e-7 of JAX's
    random_background; the port's own draws: shapes, ranges, seeded."""
    key = jax.random.PRNGKey(7)
    k_grid, k_noise = jax.random.split(key)
    grid = np.array(jax.random.uniform(k_grid, (8, 8, 3)))
    fine = np.array(jax.random.uniform(k_noise, (H, W, 1)))
    want = np.asarray(jr.random_background(key, H, W))
    got = tr.background_from_draws(torch.from_numpy(grid), torch.from_numpy(fine), H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-7)

    bg = tr.random_background(torch.Generator().manual_seed(0), H, W)
    assert bg.shape == (H, W, 3) and 0 <= bg.min() and bg.max() <= 1
    assert torch.equal(bg, tr.random_background(torch.Generator().manual_seed(0), H, W))
    assert not torch.equal(bg, tr.random_background(torch.Generator().manual_seed(1), H, W))
    pos, inten = tr.sample_train_lights(torch.Generator().manual_seed(0))
    assert pos.shape == (5, 3) and inten.shape == (5,)
    assert set(inten.tolist()) <= {1.0, 2.0, 3.0, 4.0}
    anchors = torch.tensor([[0.0, -1.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 2.0]])
    assert ((pos[:3] - anchors >= 0) & (pos[:3] - anchors < 0.1)).all()
    assert (pos[3:].abs() <= 2).all()


def test_meshes_match_jax():
    """forearm_vertices within 1e-6 of JAX's twin and of forearm_mesh, at
    both frame branches (|d_x| below and above 0.9); the numpy functions
    equal."""
    rng = np.random.RandomState(0)
    for direction in (rng.randn(3), np.array([1.0, 0.1, 0.0])):
        wrist = (rng.randn(3) * 0.1).astype(np.float32)
        d = direction.astype(np.float32)
        want = np.asarray(jm.forearm_vertices_jax(jnp.asarray(wrist), jnp.asarray(d)))
        got = tm.forearm_vertices(torch.from_numpy(wrist), torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        v_np, f_np = tm.forearm_mesh(wrist.astype(np.float64), d.astype(np.float64))
        np.testing.assert_allclose(got, v_np, rtol=0, atol=1e-6)
        v_j, f_j = jm.forearm_mesh(wrist.astype(np.float64), d.astype(np.float64))
        np.testing.assert_array_equal(v_np, v_j)
        np.testing.assert_array_equal(f_np, f_j)
    joints = rng.randn(21, 3)
    np.testing.assert_array_equal(tm.estimate_forearm_direction(joints),
                                  jm.estimate_forearm_direction(joints))
    np.testing.assert_array_equal(
        tm.random_skin_vertex_colors(100, np.random.RandomState(3)),
        jm.random_skin_vertex_colors(100, np.random.RandomState(3)))
    outs = {s: {"vertices": rng.randn(778, 3), "j3d": rng.randn(21, 3)}
            for s in ("left", "right")}
    faces = tmd.synthetic_mano_models(0)["left"].faces
    a = tm.two_hand_scene(outs, faces, np.random.RandomState(4))
    b = jm.two_hand_scene(outs, faces, np.random.RandomState(4))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(tg.scene_topology(faces, CFG)[0],
                                  jg.scene_topology(faces, JCFG_SMALL)[0])


def test_interpolation_and_interhand_match_jax(models, mano_models, tmp_path):
    """interpolate_hand_params, interpolate_sequence (a hand missing in one
    frame), augment_sequence, AxisAngleToPca and CameraTransform equal to
    JAX's; InterHandAnnotations on a JSON file in the release's layout."""
    rng = np.random.RandomState(0)
    pose, shape, trans = rng.randn(6, 48) * 0.4, rng.randn(6, 10), rng.randn(6, 3)
    a = tip.interpolate_hand_params(pose, shape, trans, 5, 30)
    b = jip.interpolate_hand_params(pose, shape, trans, 5, 30)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])

    seq = {f: {"left": {"pose": rng.randn(48) * 0.3, "shape": rng.randn(10),
                        "trans": rng.randn(3)},
               "right": None if f == 2 else {"pose": rng.randn(48) * 0.3,
                                             "shape": rng.randn(10), "trans": rng.randn(3)}}
           for f in range(5)}
    fa, fb = tip.interpolate_sequence(seq, 5, 30), jip.interpolate_sequence(seq, 5, 30)
    fa = tip.augment_sequence(fa, np.random.RandomState(1))
    fb = jip.augment_sequence(fb, np.random.RandomState(1))
    assert len(fa) == len(fb) == 30
    for ha, hb in zip(fa, fb):
        assert [h["hand_type"] for h in ha] == [h["hand_type"] for h in hb]
        for x, y in zip(ha, hb):
            for k in ("pose", "shape", "trans"):
                np.testing.assert_array_equal(x[k], y[k])

    aa = rng.randn(4, 45).astype(np.float32)
    np.testing.assert_array_equal(tih.AxisAngleToPca(models["right"])(aa),
                                  jih.AxisAngleToPca(mano_models["right"])(aa))
    np.testing.assert_array_equal(tg.pca_from_aa(aa, models["left"], 6),
                                  jg.pca_from_aa(aa, mano_models["left"], 6))
    R = np.linalg.qr(rng.randn(3, 3))[0]
    args = ("left", rng.randn(3) * 0.5, rng.randn(3) * 0.2,
            rng.randn(10).astype(np.float32) * 0.3, R, rng.randn(3) * 0.3)
    ca = tih.CameraTransform(models).world_to_camera(*args)
    cb = jih.CameraTransform(mano_models).world_to_camera(*args)
    for k in cb:
        np.testing.assert_array_equal(ca[k], cb[k])

    split = "test"
    anno_dir = tmp_path / "annotations" / split
    anno_dir.mkdir(parents=True)
    mano = {cap: {str(f): {"left": None if f == 1 else {
        "pose": rng.randn(48).tolist(), "shape": rng.randn(10).tolist(),
        "trans": rng.randn(3).tolist()},
        "right": {"pose": rng.randn(48).tolist(), "shape": rng.randn(10).tolist(),
                  "trans": rng.randn(3).tolist()}} for f in range(3)} for cap in ("10", "2")}
    cams = {cap: {"camrot": {"400": np.linalg.qr(rng.randn(3, 3))[0].tolist()},
                  "campos": {"400": (rng.randn(3) * 500).tolist()}} for cap in ("10", "2")}
    (anno_dir / f"InterHand2.6M_{split}_MANO_NeuralAnnot.json").write_text(json.dumps(mano))
    (anno_dir / f"InterHand2.6M_{split}_camera.json").write_text(json.dumps(cams))
    ta = tih.InterHandAnnotations(str(tmp_path), split)
    ja = jih.InterHandAnnotations(str(tmp_path), split)
    assert ta.capture_ids() == ja.capture_ids() == ["2", "10"]
    for x, y in zip(ta.camera_params("10", "400"), ja.camera_params("10", "400")):
        np.testing.assert_array_equal(x, y)
    sa, sb = ta.sequence("10"), ja.sequence("10")
    assert sa.keys() == sb.keys() and sa[1]["left"] is None
    for f in sb:
        for side in ("left", "right"):
            if sb[f][side] is not None:
                for k in sb[f][side]:
                    np.testing.assert_array_equal(sa[f][side][k], sb[f][side][k])


def test_simulate_sequence_matches_jax(models, mano_models, monkeypatch):
    """Realistic mode, 3 frames at 64x48, both packages given JAX's
    background and light draws: class maps equal, each frame's event count
    within 1%, labels only in {0, 1, 2} (the forearms folded into 0), the
    annotation entries equal."""
    seed = 0
    key = jax.random.PRNGKey(seed)
    key, k_bg = jax.random.split(key)
    draws = tg.SequenceDraws(
        torch.from_numpy(np.array(jr.random_background(k_bg, H, W))),
        [tuple(torch.from_numpy(np.array(x))
               for x in jr.sample_train_lights(jax.random.fold_in(key, fi)))
         for fi in range(3)])

    maps = {"jax": [], "port": []}
    real_make = jg.make_frame_simulator

    def recording_make(*args, **kwargs):
        fn = real_make(*args, **kwargs)

        def frame_fn(*a):
            out = fn(*a)
            maps["jax"].append(np.asarray(out[2]))
            return out
        return frame_fn

    real_port_make = tg.make_frame_simulator

    def recording_port_make(*args, **kwargs):
        sim = real_port_make(*args, **kwargs)

        def frame_fn(*a):
            out = sim(*a)
            maps["port"].append(out[2].numpy())
            return out
        return frame_fn

    monkeypatch.setattr(jg, "make_frame_simulator", recording_make)
    monkeypatch.setattr(tg, "make_frame_simulator", recording_port_make)
    ref = list(jg.simulate_sequence(make_frames(3), mano_models, JCFG_SMALL, seed=seed))
    got = list(tg.simulate_sequence(make_frames(3), models, CFG, seed=seed, device="cpu",
                                    draws=draws))
    assert len(maps["jax"]) == len(maps["port"]) == 3
    for a, b in zip(maps["port"], maps["jax"]):
        np.testing.assert_array_equal(a, b)
    assert (maps["port"][0] == tg.FOREARM_MATERIAL).sum() > 0
    for fa, fb in zip(got, ref):
        na, nb = len(fa["events"]), len(fb["events"])
        assert abs(na - nb) <= 0.01 * nb, (na, nb)
        assert set(np.unique(fa["event_labels"])) <= {0, 1, 2}
        for side in fb["camera_hand_info"]:
            for k, v in fb["camera_hand_info"][side].items():
                np.testing.assert_array_equal(fa["camera_hand_info"][side][k], v)
    assert sum(len(f["events"]) for f in got) > 100


def test_generate_stitch_read_roundtrip(models, tmp_path):
    """generate (plain mode too, and two workers' shards) -> stitch ->
    Ev2HandSReader: the port's rows equal stitch_rows' and the JAX
    stitcher's on the same parts, readable by both readers; without a card
    and without a CPU device the entry points raise."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tg.generate(iter([make_frames(2)]), models, str(tmp_path / "x"), cfg=CFG)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            next(tg.simulate_sequence(make_frames(2), models, CFG))
    seqs = [make_frames(4), make_frames(3)]
    parts = tg.generate(iter(seqs), models, str(tmp_path / "parts"), cfg=CFG,
                        frames_per_part=3, verbose=False, device="cpu")
    assert [p.rsplit("/", 1)[1] for p in parts] == [
        f"train_w00_part{i:06d}.pickle" for i in range(3)]
    shard = tg.generate(iter(seqs), models, str(tmp_path / "w1"), cfg=CFG, n_workers=2,
                        worker_id=1, verbose=False, device="cpu")
    with open(shard[0], "rb") as f:
        assert len(pickle.load(f)) == 3          # only sequence 1
    rows, annos = tst.stitch_rows(parts)
    assert len(annos) == 7 and len(rows) > 100
    assert set(np.unique(rows[:, 5])) <= {0, 1, 2}
    assert rows[:, 0].max() < W and rows[:, 1].max() < H

    root = tst.stitch(parts, str(tmp_path / "train"))
    jroot = jst.stitch(parts, str(tmp_path / "jax_train"))
    import h5py

    with h5py.File(f"{root}.h5") as f, h5py.File(f"{jroot}.h5") as g:
        np.testing.assert_array_equal(f["event"][:], rows)
        np.testing.assert_array_equal(g["event"][:], rows)
    reader = Ev2HandSReader(root, n_events=64)
    batch = next(reader.batches(2, shuffle=False))
    jbatch = next(JReader(root, n_events=64).batches(2, shuffle=False))
    np.testing.assert_array_equal(batch["events"], jbatch["events"])
    mem = next(Ev2HandSReader.from_rows(rows, annos, n_events=64).batches(2, shuffle=False))
    np.testing.assert_array_equal(mem["events"], batch["events"])
    assert batch["left"]["valid"].all() and batch["right"]["valid"].all()

    plain = CFG.replace(datagen=CFG.datagen.__class__(realistic_scene=False))
    frames = list(tg.simulate_sequence(make_frames(3), models, plain, device="cpu"))
    assert sum(len(f["events"]) for f in frames) > 0


def test_erpc_writer_and_reader_match_jax(tmp_path):
    """rasterize_frame_erpc (with the downsample past n_events),
    write_erpc_parts and PreRasterizedErpcReader bitwise against JAX's; the
    batches go through erpc_preraster_batch_transform."""
    rng = np.random.RandomState(0)
    frames = []
    for i, n in enumerate((300, 40, 0)):
        ev = np.stack([rng.randint(0, W, n), rng.randint(0, H, n),
                       np.sort(rng.randint(0, 10 ** 6, n)), rng.choice([-1, 1], n)],
                      axis=1).astype(np.float64)
        frames.append({"events": ev, "event_labels": rng.randint(0, 3, n),
                       "camera_hand_info": {"right": {
                           "global_orient": rng.randn(3).astype(np.float32),
                           "hand_pose": rng.randn(45).astype(np.float32),
                           "shape": rng.randn(10).astype(np.float32),
                           "trans": rng.randn(3).astype(np.float32)}}})
    a = tw.rasterize_frame_erpc(frames[0]["events"], frames[0]["event_labels"], W, H,
                                64, np.random.RandomState(1))
    b = jw.rasterize_frame_erpc(frames[0]["events"], frames[0]["event_labels"], W, H,
                                64, np.random.RandomState(1))
    assert a[0].shape == (64, 5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)

    pa = tw.write_erpc_parts(iter(frames), str(tmp_path / "t"), width=W, height=H,
                             n_events=64, frames_per_part=2)
    pb = jw.write_erpc_parts(iter(frames), str(tmp_path / "j"), width=W, height=H,
                             n_events=64, frames_per_part=2)
    assert [p.rsplit("/", 1)[1] for p in pa] == [p.rsplit("/", 1)[1] for p in pb]
    for x, y in zip(pa, pb):
        with open(x, "rb") as f, open(y, "rb") as g:
            ca, cb = pickle.load(f), pickle.load(g)
        assert ca.keys() == cb.keys()
        for k in cb:
            if not k.startswith(b"camera"):
                np.testing.assert_array_equal(ca[k], cb[k])
    ra, rb = tw.PreRasterizedErpcReader(pa, capacity=96), jw.PreRasterizedErpcReader(pb, capacity=96)
    assert len(ra) == len(rb) == 3
    ba = next(ra.batches(3, shuffle=True))
    bb = next(rb.batches(3, shuffle=True))
    for k in ("feats", "labels", "n_valid"):
        np.testing.assert_array_equal(ba[k], bb[k])
    for k in bb["right"]:
        np.testing.assert_array_equal(ba["right"][k], bb["right"][k])
    out = erpc_preraster_batch_transform(
        torch.from_numpy(ba["feats"]), torch.from_numpy(ba["labels"]),
        torch.from_numpy(ba["n_valid"]), torch.Generator().manual_seed(0),
        width=W, height=H, n_out=32)
    assert out.events.shape == (3, 32, 5) and torch.isfinite(out.events).all()


def test_replay_matches_jax(mano_hands, tmp_path, monkeypatch):
    """replay on a small dataset (its hands moved 0.45 m in front of the
    camera): the same frames as JAX's replay, caught from cv2.VideoWriter;
    the event and segmentation panes bitwise, the mesh pane within one grey
    level on at most 1% of its pixels."""
    import h5py

    rows, annos = synthetic_ev2hands_s(n_events=2048, n_frames=4, width=W, height=H)
    for frame in annos:
        for hand in frame.values():
            hand["trans"][2] = -0.45
    root = str(tmp_path / "s")
    with h5py.File(f"{root}.h5", "w") as f:
        f.create_dataset("event", data=rows)
    with open(f"{root}_anno.pickle", "wb") as f:
        pickle.dump(annos, f)
    written = []

    class Sink:
        def __init__(self, path, fourcc, fps, size):
            self.size = size
            written.append([])

        def write(self, frame):
            written[-1].append(frame)

        def release(self):
            pass

    monkeypatch.setattr(cv2, "VideoWriter", Sink)
    jvis.replay(root, mano_hands, str(tmp_path / "j.mp4"), JCFG_SMALL, n_windows=3,
                window=256)
    hands = ttr.build_hands(CFG, synthetic=True, device="cpu")
    assert tvis.replay(root, hands, str(tmp_path / "t.mp4"), CFG, n_windows=3,
                       window=256) == str(tmp_path / "t.mp4")
    (ref, got) = written
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        assert a.shape == b.shape == (H, 3 * W, 3)
        np.testing.assert_array_equal(a[:, :2 * W], b[:, :2 * W])
        diff = np.abs(a[:, 2 * W:].astype(int) - b[:, 2 * W:].astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    assert sum((b[:, 2 * W:] > 0).sum() for b in ref) > 100
