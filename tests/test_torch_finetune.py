"""The port's finetuning path on the CPU against the JAX package: the camera
projection, ``real_losses`` (float64 and float32), the Ev2Hands-R training
reader and its 2-D joints, one finetuning step, and ``finetune`` with
resume (B=2, N=256). No JAX step is compiled."""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu import camera as jcam
from ev2hands_tpu import losses as jlosses
from ev2hands_tpu.config import CameraConfig as JCameraConfig
from ev2hands_tpu.config import LossConfig as JLossConfig
from ev2hands_tpu.events import real_streams as jrs
from ev2hands_tpu.mano import synthetic_mano_models
from ev2hands_tpu.ops import collision as jc
from ev2hands_tpu_torch import camera as tcam
from ev2hands_tpu_torch import evaluate as tev
from ev2hands_tpu_torch import finetune as tft
from ev2hands_tpu_torch import losses as tlosses
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import CameraConfig, DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events import real_streams as trs
from ev2hands_tpu_torch.model.tehnet import TEHNet
from test_torch_loop import assert_tree_equal

B, N = 2, 256
W, H = 346, 260


@pytest.fixture(scope="module")
def recordings(tmp_path_factory):
    """Two small synthetic Ev2Hands-R recordings written by the JAX package,
    in one directory."""
    d = tmp_path_factory.mktemp("recordings")
    for i in range(2):
        jrs.write_synthetic_ev2hands_r(str(d / f"subject{i}.pickle"), n_events=20000,
                                       n_frames=10, seed=5 + i)
    return str(d)


@pytest.mark.parametrize("zfar", [None, 10.0])
def test_projection_matches_jax(zfar):
    """The projection matrix and ``opengl_projection_transform`` against
    JAX's: atol 1e-6 in float64, and in float32 within 1e-6 relative (a few
    ulps of pixel coordinates in the hundreds)."""
    ref = JCameraConfig(zfar=zfar).projection_matrix(W, H)
    got = CameraConfig(zfar=zfar).projection_matrix(W, H)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    rng = np.random.RandomState(0)
    pts = rng.randn(4, 21, 3) * 40 + np.array([0.0, 0.0, 400.0])
    with jax.enable_x64(True):
        want = np.asarray(jcam.opengl_projection_transform(jnp.asarray(ref), W, H,
                                                           jnp.asarray(pts)))
        want32 = np.asarray(jcam.opengl_projection_transform(
            jnp.asarray(ref, jnp.float32), W, H, jnp.asarray(pts, jnp.float32)))
    got = tcam.opengl_projection_transform(torch.from_numpy(got), W, H,
                                           torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got32 = tcam.opengl_projection_transform(
        torch.from_numpy(ref).float(), W, H, torch.from_numpy(pts).float()).numpy()
    assert got32.dtype == np.float32
    np.testing.assert_allclose(got32, want32, rtol=1e-6, atol=0)


def _loss_case(dtype):
    """Network outputs with overlapping synthetic-MANO meshes (so the
    collision term sees intersecting pairs) and targets with an interacting
    row, a single-hand row and a row whose right hand is invalid."""
    models = synthetic_mano_models(0)
    rng = np.random.RandomState(11)
    Bc = 3
    out, tgt = {}, {}
    for side in ("left", "right"):
        v = models[side].v_template[None] + 0.004 * rng.randn(Bc, 778, 3)
        out[side] = {"betas": rng.randn(Bc, 10) * 0.3, "hand_pose": rng.randn(Bc, 6),
                     "j3d": rng.randn(Bc, 21, 3) * 0.03 + [0, 0, 0.4], "vertices": v}
        tgt[side] = {"j3d": rng.randn(Bc, 21, 3) * 0.03 + [0, 0, 0.4],
                     "j2d": rng.uniform(0, 300, (Bc, 21, 2)),
                     "valid": np.array([1.0, 1.0, 1.0 if side == "left" else 0.0])}
    out["right"]["vertices"][1] += [0.06, 0.0, 0.0]
    cast = lambda t: {k: cast(v) if isinstance(v, dict) else np.asarray(v, dtype)  # noqa: E731
                      for k, v in t.items()}
    tgt = cast(tgt)
    tgt["handedness"] = np.array([[1, 1], [1, 0], [1, 1]], np.int32)
    faces = jc.build_two_hand_faces(models["left"].faces, models["right"].faces)
    return cast(out), tgt, faces, jc.build_adjacency_mask(faces)


@pytest.mark.parametrize("dtype,rtol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_real_losses_match_jax(dtype, rtol):
    """Every term of ``real_losses`` against JAX's on the same outputs and
    targets (the regulariser's double scaling of the left hand kept)."""
    out, tgt, faces, adj = _loss_case(dtype)
    proj = CameraConfig().projection_matrix(W, H).astype(dtype)
    with jax.enable_x64(dtype == np.float64):
        ref = jax.jit(lambda o, t, f, a, p: jlosses.real_losses(
            o, t, jlosses.CollisionContext(faces=f, adjacency=a), p, W, H,
            JLossConfig()))(out, tgt, faces, adj, proj)
        ref = {k: float(v) for k, v in ref.items()}
    ctx = tlosses.CollisionContext(faces=torch.from_numpy(faces),
                                   adjacency=torch.from_numpy(adj))
    to_t = lambda t: {k: to_t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                      for k, v in t.items()}
    got = tlosses.real_losses(to_t(out), to_t(tgt), ctx, torch.from_numpy(proj), W, H)
    assert set(got) == set(ref)
    assert ref["loss_interpen"] > 0 and ref["loss_inter_j3d"] > 0
    for k, v in ref.items():
        g = got[k]
        assert g.dtype == torch.from_numpy(proj).dtype, k
        np.testing.assert_allclose(g.item(), v, rtol=rtol, atol=0, err_msg=k)


def test_real_reader_matches_jax(recordings):
    """Three batches of the training reader over two recordings, and
    ``joints_2d``, bitwise equal to the JAX package's for the same seed."""
    ref = jrs.Ev2HandRReader(recordings, seed=3, capacity=4096)
    got = trs.Ev2HandRReader(recordings, seed=3, capacity=4096)
    for f in (0, 4, 9):
        np.testing.assert_array_equal(got.streams[1].joints_2d(f),
                                      ref.streams[1].joints_2d(f))
    for a, b in zip(got.batches(4, max_batches=3), ref.batches(4, max_batches=3)):
        assert_tree_equal(a, b)
    assert a["events"].shape == (4, 4096, 4) and not a["event_valid"].all()


def _small_cfg(**train):
    return DEFAULT_CONFIG.replace(
        model=ModelConfig(n_points=N), train=DEFAULT_CONFIG.train.__class__(
            **{**DEFAULT_CONFIG.train.__dict__, "batch_size": B, "eval_batch_size": B,
               "msg_iter": 1, **train}))


def test_finetune_step_on_cpu(recordings):
    """One finetuning step on the CPU: finite losses with every term of
    ``real_losses`` and the total, the collision term computed, and every
    parameter and BatchNorm statistic moved. Without a device argument it
    asks for the card and raises on a host without one."""
    cfg = _small_cfg()
    net = TEHNet(cfg.model, device="cpu")
    net.load_state_dict(tw.init_weights(torch.Generator().manual_seed(1), cfg.model))
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    ctx = ttr.build_collision_context(hands)
    opt = ttr.make_optimizer(net.parameters(), cfg.train)
    proj = cfg.camera.projection_matrix(W, H)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tft.make_finetune_step(net, hands, ctx, cfg, opt, proj)
    step = tft.make_finetune_step(net, hands, ctx, cfg, opt, proj, device="cpu")
    batch = next(trs.Ev2HandRReader(recordings, seed=0, capacity=4096).batches(B))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    losses = step(batch, torch.Generator().manual_seed(0))
    assert set(losses) == {"loss_interpen", "loss_inter_shape", "loss_inter_j3d",
                           "loss_rj3d", "loss_j2d", "regularizer_loss", "loss"}
    assert np.isfinite(list(losses.values())).all()
    assert losses["loss"] == pytest.approx(
        sum(v for k, v in losses.items() if k != "loss"), rel=1e-6)
    unchanged = [k for k, v in net.state_dict().items() if torch.equal(v, before[k])]
    assert not unchanged, unchanged


def test_finetune_resume(recordings, tmp_path, monkeypatch):
    """finetune() for a step saves its best checkpoint at step 1; a run
    resumed from it with max_iter 1 takes no step and returns the first
    run's parameters, BatchNorm statistics and Adam state bitwise. Both runs
    score the training recordings (no val_data_root) and log the warning.
    A warm start from the checkpoint directory (finetune's checkpoint_path,
    evaluate.load_net) loads the same weights."""
    monkeypatch.chdir(tmp_path)
    cfg = _small_cfg()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tft.main(["--data_root", recordings, "--synthetic_mano"])
    first = tft.finetune(cfg, recordings, "", max_iter=1, save_iter=1,
                         synthetic_mano=True, max_eval_iters=2, device="cpu")
    assert first.step == 1 and first.stats.steps == 1 and first.stats.saves == 1
    ckpts = sorted(glob.glob("runs/finetune_*/ckpt"))
    assert len(ckpts) == 1 and glob.glob(f"{ckpts[0]}/step_000000001.pt")
    again = tft.finetune(cfg, recordings, "", max_iter=1, save_iter=1,
                         synthetic_mano=True, max_eval_iters=2, resume_dir=ckpts[0],
                         device="cpu")
    assert again.step == 1 and again.stats.steps == 0
    assert again.max_eval_score == first.max_eval_score
    assert_tree_equal(again.net.state_dict(), first.net.state_dict())
    assert_tree_equal(again.optimizer.state_dict()["state"],
                      first.optimizer.state_dict()["state"])
    logs = glob.glob("runs/finetune_*/log.txt")
    assert len(logs) == 2 and all("val_data_root" in open(p).read() for p in logs)

    warm = tft.finetune(cfg, recordings, ckpts[0], max_iter=0, synthetic_mano=True,
                        device="cpu")
    assert_tree_equal(warm.net.state_dict(), first.net.state_dict())
    assert warm.optimizer.state_dict()["state"] == {}
    assert_tree_equal(tev.load_net(cfg, ckpts[0], "cpu").state_dict(),
                      first.net.state_dict())
