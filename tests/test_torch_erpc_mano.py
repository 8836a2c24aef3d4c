"""The port's ERPC transform and MANO layer against the JAX package on the
CPU, plus the port's import and device boundaries."""

import os
import subprocess
import sys

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
