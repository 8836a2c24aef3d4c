"""``ModelConfig.fused_regressors`` (``model/fused_regressor.py``) on the CPU:
the port's fused two-hand regressor against the JAX package's
``fused_two_hand_regressor`` and against the port's two separate heads, at
``tests/test_model.py:127``'s size and inputs (N=256, deterministic FPS,
every 1-D weight and BatchNorm statistic moved by 0.03 so the fold is not
trivial), and the gate (eval, the heads on the dense route, no event mesh).

The weights are numpy draws in the port's state-dict layout, read by the
JAX package's checkpoint reader and reach the port through
``weights.flax_to_torch`` (``numpy_state``; the other switch tests use it
too). One JAX compile: the fused eval forward.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import ModelConfig
from ev2hands_tpu_torch.model import fused_regressor as fr
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from ev2hands_tpu_torch.parallel import mesh as pm

N = 256
HEAD_KEYS = ("global_orient", "hand_pose", "betas", "transl")


def numpy_state(rng, cfg=ModelConfig(n_points=N)):
    """JAX variables of TEHNet from numpy draws made in the port's state-dict
    layout: conv weights ~ N(0, 1/fan_in) (the heads' output layer 100x
    smaller), biases ~ 0.1 N, BatchNorm scale ~ 1 + 0.1 N, mean ~ 0.1 N,
    var ~ U[0.5, 1.5]."""
    sd = {}
    for k, v in tt.TEHNet(cfg, device="cpu").state_dict().items():
        s = tuple(v.shape)
        if k.endswith("running_var"):
            a = 0.5 + rng.rand(*s)
        elif k.endswith("running_mean"):
            a = 0.1 * rng.randn(*s)
        elif k.endswith("bias"):
            a = 0.1 * rng.randn(*s)
        elif len(s) == 1:                        # a BatchNorm scale
            a = 1.0 + 0.1 * rng.randn(*s)
        else:
            a = rng.randn(*s) / math.sqrt(math.prod(s[1:]))
            if k.endswith("mano_regressor.4.weight"):
                a = a * 0.01
        sd[k] = np.asarray(a, np.float32)
    return jckpt.torch_to_flax(sd)


def event_cloud(rng, B=2, n=N):
    """``tests/test_model.py:131``'s ERPC-like cloud: x, y in [-1, 1], sorted
    t, positive and negative counts 1-4."""
    return np.concatenate([rng.rand(B, n, 2) * 2 - 1, np.sort(rng.rand(B, n, 1) * 2 - 1, 1),
                           rng.randint(1, 5, (B, n, 2))], -1).astype(np.float32)


def port_net(variables, **model):
    net = tt.TEHNet(ModelConfig(n_points=N, fps_deterministic=True, **model), device="cpu")
    net.load_state_dict(tw.flax_to_torch(variables), strict=True)
    return net.eval()


def outputs_np(out):
    return {"class_logits": out["class_logits"].numpy(),
            **{s: {k: out[s][k].numpy() for k in HEAD_KEYS} for s in ("left", "right")}}


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(0)
    events = event_cloud(rng)
    variables = jax.tree.map(lambda a: a + 0.03 if a.ndim == 1 else a,
                             numpy_state(rng))
    net = jt.TEHNet(cfg=JModelConfig(n_points=N, fps_deterministic=True,
                                     fused_regressors=True))
    ref = jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, jnp.asarray(events))
    x = torch.from_numpy(events)
    with torch.no_grad():
        fused = outputs_np(port_net(variables, fused_regressors=True)(x))
        separate = outputs_np(port_net(variables)(x))
    return dict(ref=jax.tree.map(np.asarray, ref), fused=fused, separate=separate,
                variables=variables, x=x)


def test_fused_regressor_matches_jax(case):
    """The port's fused forward against JAX's within atol = rtol = 1e-4,
    the slice's golden tolerance (``tests/test_torch_model.py``)."""
    ref, got = case["ref"], case["fused"]
    np.testing.assert_allclose(got["class_logits"], ref["class_logits"], rtol=1e-4,
                               atol=1e-4)
    for side in ("left", "right"):
        for k in HEAD_KEYS:
            np.testing.assert_allclose(got[side][k], ref[side][k], rtol=1e-4, atol=1e-4,
                                       err_msg=f"{side}/{k}")


def test_fused_regressor_matches_separate_heads(case):
    """Against the port's two heads: the logits bitwise (the trunk is the
    same code), the regressed parameters within rtol = atol = 1e-5 (folded
    BatchNorm and stacked products; ``tests/test_model.py:158`` allows
    1e-4)."""
    got, sep = case["fused"], case["separate"]
    np.testing.assert_array_equal(got["class_logits"], sep["class_logits"])
    for side in ("left", "right"):
        for k in HEAD_KEYS:
            np.testing.assert_allclose(got[side][k], sep[side][k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{side}/{k}")


def test_fused_regressor_gate(case, monkeypatch):
    """The fused pass runs in eval on the dense route without an event mesh
    (one FPS draw for both heads: 3 in the forward), and not in training,
    with the heads on the gather route or under an event mesh."""
    calls, fps = [], []
    real = tt.fused_two_hand_regressor
    monkeypatch.setattr(tt, "fused_two_hand_regressor",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    for mod in (fr, tl, tt):
        real_fps = mod.fps_unchecked
        monkeypatch.setattr(mod, "fps_unchecked",
                            lambda *a, _f=real_fps, **k: fps.append(1) or _f(*a, **k))
    x = case["x"][:1, :64]
    with torch.no_grad():
        port_net(case["variables"], fused_regressors=True)(x)
    assert (len(calls), len(fps)) == (1, 3)
    mesh = pm.Mesh(None, None, None, 0, 1, 0, 1, torch.device("cpu"))
    for net in (port_net(case["variables"], fused_regressors=True).train(),
                port_net(case["variables"], fused_regressors=True,
                         grouping_regressor="gather"),
                port_net(case["variables"], fused_regressors=True, event_parallel=True)
                .set_mesh(event_mesh=mesh)):
        net(x, torch.Generator().manual_seed(0))
    assert len(calls) == 1
