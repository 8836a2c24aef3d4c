"""The port's ERPC transform and MANO layer against the JAX package on the
CPU, plus the port's import and device boundaries."""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.mano import JOINT_REORDER, KINTREE_PARENTS
from ev2hands_tpu.mano import create_mano_params as j_create_mano_params
from ev2hands_tpu.mano import mano_forward as j_mano_forward
from ev2hands_tpu.mano import synthetic_mano_models as j_synthetic
from ev2hands_tpu.mano.model_data import load_mano_models as j_load_mano_models
from ev2hands_tpu_torch.events import erpc as te
from ev2hands_tpu_torch.mano import layer as tl
from ev2hands_tpu_torch.mano import model_data as tmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def raw_windows(rng, B, N, width=346, height=260):
    """bench.py-style raw windows (x, y, t in ns, polarity) and labels."""
    t = np.sort(rng.uniform(0, 5e6, (B, N))).astype(np.float32)
    raw = np.stack([
        rng.randint(0, width, (B, N)).astype(np.float32),
        rng.randint(0, height, (B, N)).astype(np.float32),
        t,
        rng.randint(0, 2, (B, N)).astype(np.float32),
    ], axis=-1)
    return raw, rng.randint(0, 4, (B, N)).astype(np.int32)


def jax_draws(raw, labels, key, n_out, width=346, height=260):
    """The resample draws erpc_batch_transform makes inside JAX."""
    _, _, n_valid = jax.jit(jax.vmap(
        lambda e, l: je.rasterize_erpc(e, l, width, height)))(raw, labels)
    draws = []
    for b, k in enumerate(jax.random.split(key, raw.shape[0])):
        k_sample = jax.random.split(k, 3)[2]
        draws.append(jax.random.randint(
            k_sample, (n_out,), 0, jnp.maximum(n_valid[b], 1)))
    return np.array(jnp.stack(draws))


def assert_erpc_equal(got, ref, jitted=False):
    """Exact, except the t column: the port sums a pixel's times in float64
    and rounds once, JAX in float32 in event order (rtol 1e-6). Under jit,
    XLA turns x / width into a multiply by the reciprocal fused with the
    -1, one ulp (1.2e-7 on [-1, 1]) off the division the source writes."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(got[..., 3:], ref[..., 3:])
    if jitted:
        np.testing.assert_allclose(got[..., :2], ref[..., :2], rtol=0,
                                   atol=1.2e-7)
    else:
        np.testing.assert_array_equal(got[..., :2], ref[..., :2])
    np.testing.assert_allclose(got[..., 2], ref[..., 2], rtol=1e-6, atol=1e-6)


def test_rasterize_and_transform_match_jax():
    rng = np.random.RandomState(0)
    B, N, W, H = 3, 256, 24, 16   # a small sensor: many events per pixel
    raw, labels = raw_windows(rng, B, N, W, H)
    feats, plab, n_valid = jax.jit(jax.vmap(
        lambda e, l: je.rasterize_erpc(e, l, W, H)))(raw, labels)
    g_feats, g_plab, g_n = te.rasterize_erpc(
        torch.from_numpy(raw), torch.from_numpy(labels), W, H)
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(n_valid))
    assert (np.asarray(n_valid) < N).all()   # pixel collisions happened
    np.testing.assert_array_equal(g_plab.numpy(), np.asarray(plab))
    assert_erpc_equal(g_feats, feats)
    assert_erpc_equal(te.normalize_erpc(g_feats, W, H),
                      jax.vmap(lambda f: je.normalize_erpc(f, W, H))(feats))

    key = jax.random.PRNGKey(5)
    ref = je.erpc_batch_transform(raw, labels, key, width=W, height=H, n_out=N)
    draws = jax_draws(raw, labels, key, N, W, H)
    got = te.erpc_batch_transform(
        torch.from_numpy(raw), torch.from_numpy(labels),
        draws=torch.from_numpy(draws), width=W, height=H, n_out=N)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert_erpc_equal(got.events, ref.events, jitted=True)

    # a generator's draws cover [0, n_valid)
    g = torch.Generator().manual_seed(0)
    r = te.resample_draws(g_n, 4096, g)
    assert (r >= 0).all() and (r < g_n[:, None]).all()
    assert (r.amax(dim=1) == g_n - 1).all()


def test_synthetic_mano_models_bit_identical():
    ref = j_synthetic(3)
    got = tmd.synthetic_mano_models(3)
    for side in ("left", "right"):
        for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "hands_components", "hands_mean", "faces"):
            a, b = getattr(got[side], f), getattr(ref[side], f)
            assert a.dtype == b.dtype, (side, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{side}.{f}")
        np.testing.assert_array_equal(got[side].tip_vertex_ids,
                                      ref[side].tip_vertex_ids)
    np.testing.assert_array_equal(tmd.JOINT_REORDER, JOINT_REORDER)
    np.testing.assert_array_equal(tmd.KINTREE_PARENTS, KINTREE_PARENTS)


def test_mano_forward_matches_jax():
    """Vertices and joints within 1e-5 m (f32 contractions in another
    order), over a [2, 3] batch."""
    rng = np.random.RandomState(4)
    models = tmd.synthetic_mano_models(0)
    shape = (2, 3)
    go = (0.7 * rng.randn(*shape, 3)).astype(np.float32)
    hp = rng.randn(*shape, 6).astype(np.float32)
    be = rng.randn(*shape, 10).astype(np.float32)
    tr = (0.1 * rng.randn(*shape, 3)).astype(np.float32)
    for side in ("left", "right"):
        ref = jax.jit(j_mano_forward)(
            j_create_mano_params(j_synthetic(0)[side]), go, hp, be, tr)
        got = tl.mano_forward(
            tl.create_mano_params(models[side], device="cpu"),
            *(torch.from_numpy(a) for a in (go, hp, be, tr)))
        assert got.vertices.shape == (2, 3, 778, 3)
        np.testing.assert_allclose(got.vertices.numpy(),
                                   np.asarray(ref.vertices), atol=1e-5)
        np.testing.assert_allclose(got.joints.numpy(),
                                   np.asarray(ref.joints), atol=1e-5)


def test_port_imports_no_jax():
    """Importing every module of the port loads no JAX, flax or JAX-package
    module, nor h5py or OpenCV (checked in a fresh interpreter)."""
    code = (
        "import sys\n"
        "import ev2hands_tpu_torch.serve, ev2hands_tpu_torch.weights\n"
        "import ev2hands_tpu_torch.ops._build, ev2hands_tpu_torch.train\n"
        "import ev2hands_tpu_torch.evaluate, ev2hands_tpu_torch.evaluate_real\n"
        "import ev2hands_tpu_torch.finetune, ev2hands_tpu_torch.checkpoint\n"
        "import ev2hands_tpu_torch.events.native_loader\n"
        "import ev2hands_tpu_torch.utils.logging, ev2hands_tpu_torch.camera\n"
        "import ev2hands_tpu_torch.export, ev2hands_tpu_torch.demo\n"
        "import ev2hands_tpu_torch.datagen.rasterizer\n"
        "import ev2hands_tpu_torch.ops.esim, ev2hands_tpu_torch.datagen.generate\n"
        "import ev2hands_tpu_torch.datagen.meshes, ev2hands_tpu_torch.datagen.interhand\n"
        "import ev2hands_tpu_torch.datagen.interpolate, ev2hands_tpu_torch.datagen.stitch\n"
        "import ev2hands_tpu_torch.datagen.erpc_writer\n"
        "import ev2hands_tpu_torch.datagen.visualize\n"
        "import ev2hands_tpu_torch.utils.device, ev2hands_tpu_torch.utils.profiling\n"
        "import ev2hands_tpu_torch.parallel.mesh, ev2hands_tpu_torch.parallel.event_parallel\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('h5py', 'cv2')]\n"
        "assert not bad, bad\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ev2hands_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_pipeline_defaults_to_the_card():
    """Without a ``device`` argument the pipeline asks for CUDA and raises
    without a card, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a host without a CUDA device")
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG
    from ev2hands_tpu_torch.serve import InferencePipeline
    from ev2hands_tpu_torch.weights import init_weights

    state = init_weights(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferencePipeline(DEFAULT_CONFIG, state, tmd.synthetic_mano_models(0))
    # a CPU-only torch build raises an AssertionError here
    with pytest.raises((RuntimeError, AssertionError)):
        tl.create_mano_params(tmd.synthetic_mano_models(0)["left"])


# --- the MANO pickle loader -----------------------------------------------

def write_official_mano(root, models):
    """``{root}/mano/MANO_{LEFT,RIGHT}.pkl`` in the official layout:
    v_template and shapedirs as chumpy objects (pickled from a stand-in
    ``chumpy.ch.Ch``, as the assets hold them), J_regressor as a scipy
    sparse matrix, the rest numpy, faces uint32 as ``f``."""
    import scipy.sparse

    mod = types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    mod.Ch = Ch
    saved = {k: sys.modules.get(k) for k in ("chumpy", "chumpy.ch")}
    sys.modules["chumpy"] = types.ModuleType("chumpy")
    sys.modules["chumpy.ch"] = mod
    try:
        os.makedirs(os.path.join(root, "mano"), exist_ok=True)
        for side, m in models.items():
            data = {
                "v_template": Ch(m.v_template.astype(np.float64)),
                "shapedirs": Ch(m.shapedirs.astype(np.float64)),
                "posedirs": m.posedirs.astype(np.float64),
                "J_regressor": scipy.sparse.csc_matrix(m.J_regressor.astype(np.float64)),
                "weights": m.lbs_weights.astype(np.float64),
                "hands_components": m.hands_components.astype(np.float64),
                "hands_mean": m.hands_mean.astype(np.float64),
                "f": m.faces.astype(np.uint32),
                "kintree_table": np.stack([KINTREE_PARENTS, np.arange(16)]),
            }
            with open(os.path.join(root, "mano", f"MANO_{side.upper()}.pkl"), "wb") as f:
                pickle.dump(data, f, protocol=2)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return root


def test_load_mano_models_matches_jax(tmp_path):
    """The port's loader gives the JAX package's arrays bit for bit on a
    pickle in the official layout, with the left-hand shapedirs fix applied
    (the synthetic hands share their shapedirs, as the released left asset
    does), and ``train.build_hands`` reads the directory from
    ``cfg.mano.model_path``."""
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch.config import DEFAULT_CONFIG

    root = write_official_mano(str(tmp_path), tmd.synthetic_mano_models(0))
    assert "chumpy" not in sys.modules
    ref, got = j_load_mano_models(root), tmd.load_mano_models(root)
    synth = tmd.synthetic_mano_models(0)
    for side in ("left", "right"):
        for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "lbs_weights", "hands_components", "hands_mean", "faces"):
            a, b = getattr(got[side], f), getattr(ref[side], f)
            assert a.dtype == b.dtype, (side, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{side}.{f}")
    np.testing.assert_array_equal(got["left"].shapedirs[:, 0], -synth["left"].shapedirs[:, 0])
    np.testing.assert_array_equal(got["right"].shapedirs, synth["right"].shapedirs)

    cfg = DEFAULT_CONFIG.replace(mano=dataclasses.replace(DEFAULT_CONFIG.mano, model_path=root))
    hands = ttr.build_hands(cfg, device="cpu")
    want = tl.create_mano_params(got["left"], device="cpu")
    for a, b in zip(hands["left"], want):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError, match="MANO_RIGHT.pkl"):
        tmd.load_mano_models(str(tmp_path / "nowhere"))


def test_cli_entry_points_read_the_mano_directory(tmp_path, monkeypatch):
    """The four CLIs take their hands from ``--mano_dir``: finetuning runs
    with a directory of pickles; each CLI raises FileNotFoundError (not
    NotImplementedError) for a directory without them."""
    from ev2hands_tpu_torch import evaluate as tev
    from ev2hands_tpu_torch import evaluate_real as tevr
    from ev2hands_tpu_torch import finetune as tft
    from ev2hands_tpu_torch import train as ttr
    from ev2hands_tpu_torch.events.real_streams import write_synthetic_ev2hands_r

    monkeypatch.chdir(tmp_path)
    models = write_official_mano(str(tmp_path / "models"), tmd.synthetic_mano_models(0))
    rec = write_synthetic_ev2hands_r(str(tmp_path / "rec" / "s.pickle"), n_events=20_000,
                                     n_frames=10)
    run = tft.main(["--data_root", rec, "--mano_dir", models, "--max_iter", "0",
                    "--n_points", "128", "--device", "cpu"])
    assert run.step == 0
    missing = str(tmp_path / "no_models")
    for main, argv in ((ttr.main, ["--data_root", "data"]),
                       (tft.main, ["--data_root", rec]),
                       (tev.main, ["--checkpoint_path", "x.pth"]),
                       (tevr.main, ["--data_root", rec, "--checkpoint_path", "x.pth"])):
        with pytest.raises(FileNotFoundError, match="MANO_RIGHT.pkl"):
            main(argv + ["--mano_dir", missing, "--device", "cpu"])


# --- the 4-channel input and the pre-rasterised ERPC ------------------------

def test_draws_from_uniforms_equal_resample_draws():
    """Uniforms in, indices out, with ``resample_draws``' arithmetic: the
    same bits as ``resample_draws`` on the generator's own uniforms."""
    n_valid = torch.tensor([0, 1, 7, 4096], dtype=torch.int32)
    want = te.resample_draws(n_valid, 2048, torch.Generator().manual_seed(9))
    u = torch.rand((4, 2048), generator=torch.Generator().manual_seed(9),
                   dtype=torch.float64)
    got = te.draws_from_uniforms(u, n_valid)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert (got[:2] == 0).all() and (got[2] < 7).all() and (got[3] < 4096).all()


def jax_raw_draws(events, seed, n_out, width, height):
    """The draws raw_window_transform(augment=True) makes inside JAX, per
    window: gate, noise events, resample."""
    n_noise = n_out // 32
    N = events.shape[1]

    def window(k):
        k_gate, k_noise, k_sample = jax.random.split(k, 3)
        active = jax.random.bernoulli(k_gate, 0.5)
        kx, ky, kt, kr, kp = jax.random.split(k_noise, 5)
        total = N + jnp.where(active, n_noise, 0)
        return dict(gate=active,
                    xs=jax.random.randint(kx, (n_noise,), 0, width),
                    ys=jax.random.randint(ky, (n_noise,), 0, height),
                    src=jax.random.randint(kr, (n_noise,), 0, N),
                    t=jax.random.uniform(kt, (n_noise,)),
                    ps=jax.random.bernoulli(kp, 0.5, (n_noise,)),
                    r=jax.random.randint(k_sample, (n_out,), 0, total))

    keys = jnp.stack([jax.random.PRNGKey(seed * 100 + b) for b in range(events.shape[0])])
    d = jax.vmap(window)(keys)
    return keys, {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("augment", [False, True])
def test_raw_window_transform_matches_jax(augment):
    """The 4-channel path, the port fed the draws JAX's keys give: labels
    exact, polarity exact, x and y within one ulp of the jitted division,
    t rtol 1e-6."""
    rng = np.random.RandomState(6)
    Bq, Nq, n_out, Wq, Hq = 4, 512, 256, 64, 48
    ev = np.stack([rng.randint(0, Wq, (Bq, Nq)), rng.randint(0, Hq, (Bq, Nq)),
                   np.sort(rng.randint(0, 10_000, (Bq, Nq))), rng.randint(0, 2, (Bq, Nq))],
                  -1).astype(np.float32)
    labels = rng.randint(0, 3, (Bq, Nq)).astype(np.int32)
    keys, d = jax_raw_draws(ev, 3, n_out, Wq, Hq)
    ref = jax.vmap(lambda e, l, k: je.raw_window_transform(
        e, l, k, width=Wq, height=Hq, n_out=n_out, augment=augment))(ev, labels, keys)
    zeros = torch.zeros_like(d["xs"])
    noise = te.NoiseDraws(d["gate"], d["xs"], d["ys"], d["src"], d["t"], d["ps"],
                          zeros, zeros)
    if augment:
        assert d["gate"].any() and not d["gate"].all()
    else:   # no noise events: the resample is over the N events alone
        d["r"] = torch.from_numpy(np.stack([np.asarray(jax.random.randint(
            jax.random.split(k, 3)[2], (n_out,), 0, Nq)) for k in keys]))
    got = te.raw_window_transform(torch.from_numpy(ev), torch.from_numpy(labels),
                                  draws=d["r"], width=Wq, height=Hq, n_out=n_out,
                                  augment=augment, noise=noise if augment else None)
    assert got.events.shape == (Bq, n_out, 4)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert (got.labels.numpy() == 3).any() == augment
    g, r = got.events.numpy(), np.asarray(ref.events)
    np.testing.assert_array_equal(g[..., 3], r[..., 3])
    np.testing.assert_allclose(g[..., :2], r[..., :2], rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(g[..., 2], r[..., 2], rtol=1e-6, atol=1e-6)


def jax_preraster_draws(keys, n_valid, n_out, width, height):
    """The draws erpc_preraster_window_transform(augment=True) makes inside
    JAX for each window's key and valid-row count."""
    n_noise = n_out // 32

    def window(k, nv):
        k_gate, k_noise, k_sample = jax.random.split(k, 3)
        active = jax.random.bernoulli(k_gate, 0.5)
        kx, ky, kt, kr, kp, kpe, kne = jax.random.split(k_noise, 7)
        total = nv + jnp.where(active, n_noise, 0)
        return dict(gate=active,
                    xs=jax.random.randint(kx, (n_noise,), 0, width),
                    ys=jax.random.randint(ky, (n_noise,), 0, height),
                    src=jax.random.randint(kr, (n_noise,), 0, jnp.maximum(nv, 1)),
                    t=jax.random.uniform(kt, (n_noise,)),
                    ps=jax.random.bernoulli(kp, 0.5, (n_noise,)),
                    n_pe=jax.random.randint(kpe, (n_noise,), 0, 8),
                    n_ne=jax.random.randint(kne, (n_noise,), 0, 8),
                    r=jax.random.randint(k_sample, (n_out,), 0, jnp.maximum(total, 1)),
                    r0=jax.random.randint(k_sample, (n_out,), 0, jnp.maximum(nv, 1)))

    d = jax.vmap(window)(keys, n_valid)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("augment", [False, True])
def test_preraster_transforms_match_jax(augment):
    """Pre-rasterised ERPC rows through the batch transform (and one window
    through the window transform), the port fed JAX's draws: labels exact,
    events as the ERPC tests hold them."""
    rng = np.random.RandomState(8)
    Bq, Nq, n_out, Wq, Hq = 4, 256, 256, 24, 16
    raw, labels = raw_windows(rng, Bq, Nq, Wq, Hq)
    feats, plab, n_valid = jax.vmap(lambda e, l: je.rasterize_erpc(e, l, Wq, Hq))(raw, labels)
    key = jax.random.PRNGKey(4)
    ref = je.erpc_preraster_batch_transform(feats, plab, n_valid, key, width=Wq,
                                            height=Hq, n_out=n_out, augment=augment)
    d = jax_preraster_draws(jax.random.split(key, Bq), n_valid, n_out, Wq, Hq)
    noise = te.NoiseDraws(*(d[f] for f in te.NoiseDraws._fields)) if augment else None
    args = (torch.from_numpy(np.asarray(feats)), torch.from_numpy(np.asarray(plab)),
            torch.from_numpy(np.asarray(n_valid)))
    draws = d["r"] if augment else d["r0"]
    got = te.erpc_preraster_batch_transform(*args, draws=draws, width=Wq, height=Hq,
                                            n_out=n_out, augment=augment, noise=noise)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    assert_erpc_equal(got.events, ref.events, jitted=True)
    one = te.erpc_preraster_window_transform(
        *(a[1] for a in args), draws=draws[1], width=Wq, height=Hq, n_out=n_out,
        augment=augment, noise=None if noise is None else te.NoiseDraws(*(t[1] for t in noise)))
    assert torch.equal(one.events, got.events[1]) and torch.equal(one.labels, got.labels[1])


def test_four_channel_tehnet_matches_jax():
    """``TEHNet(ModelConfig(erpc=False))`` on the 4-channel cloud against the
    JAX package's with the same weights: logits and MANO parameters within
    1e-4 (the slice test's golden tolerance)."""
    from ev2hands_tpu import checkpoint as jckpt
    from ev2hands_tpu.config import ModelConfig as JModelConfig
    from ev2hands_tpu.model import tehnet as jt
    from ev2hands_tpu_torch.config import ModelConfig
    from ev2hands_tpu_torch.model import tehnet as tt
    from ev2hands_tpu_torch.weights import init_weights

    chunks = dict(dense_chunk=128, regressor_dense_chunk=128)
    cfg = ModelConfig(n_points=128, erpc=False, **chunks)
    state = init_weights(torch.Generator().manual_seed(1), cfg)
    assert state["sa1.conv_blocks.0.0.weight"].shape[1] == 4 + 3
    x = np.random.RandomState(2).uniform(-1, 1, (2, 128, 4)).astype(np.float32)
    x[..., 3] = np.round(x[..., 3] * 0.5 + 0.5)   # polarity 0 / 1
    jnet = jt.TEHNet(cfg=JModelConfig(n_points=128, erpc=False, fps_deterministic=True, **chunks))
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in state.items()})
    ref = jax.jit(lambda v, a: jnet.apply(v, a, train=False))(variables, x)
    net = tt.TEHNet(cfg, device="cpu")
    net.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got["class_logits"].numpy(), np.asarray(ref["class_logits"]),
                               atol=1e-4, rtol=1e-4)
    for side in ("left", "right"):
        for k in ("global_orient", "hand_pose", "betas", "transl"):
            np.testing.assert_allclose(got[side][k].numpy(), np.asarray(ref[side][k]),
                                       atol=1e-4, rtol=1e-4, err_msg=f"{side}.{k}")
