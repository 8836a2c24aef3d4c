"""``ModelConfig.bf16_eval`` on the CPU, against the JAX package's bf16
forward (``tests/test_bf16.py:158-262``) at its size (N=256, deterministic
FPS): the parameter tree unchanged, every FPS index and selection mask of
the bf16 forward equal to the float32 forward's, and the port's bf16
outputs within a bound of JAX's bf16 outputs. Also what each bf16 switch
leaves alone: ``bf16_eval`` the training forward, ``bf16_train`` the eval
forward, both bitwise. One JAX compile: the bf16 eval forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch.model import fused_regressor as tfr
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from test_torch_fused_regressor import HEAD_KEYS, N, event_cloud, numpy_state, port_net


def recorded_forward(net, x, monkeypatch):
    """net(x) in eval -> (outputs, every FPS index and selection mask it
    computed, in call order)."""
    seen = []

    def tap(fn):
        return lambda *a, **k: seen.append(fn(*a, **k)) or seen[-1]

    with monkeypatch.context() as mp:
        for mod in (tl, tt, tfr):
            mp.setattr(mod, "fps_unchecked", tap(mod.fps_unchecked))
        for mod in (tl, tfr):
            mp.setattr(mod, "dense_selection_mask", tap(mod.dense_selection_mask))
        with torch.no_grad():
            out = net(x)
    return out, seen


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(5)
    variables = numpy_state(rng)
    events = event_cloud(rng) * np.float32(0.5)
    net = jt.TEHNet(cfg=JModelConfig(n_points=N, fps_deterministic=True, bf16_eval=True))
    ref = jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, jnp.asarray(events))
    return dict(variables=variables, x=torch.from_numpy(events),
                ref=jax.tree.map(np.asarray, ref))


def test_bf16_eval_parameter_tree_unchanged(case):
    """The switch adds, drops and recasts no parameter or buffer."""
    a = port_net(case["variables"]).state_dict()
    b = port_net(case["variables"], bf16_eval=True).state_dict()
    assert list(a) == list(b)
    for k in a:
        assert b[k].dtype == torch.float32 and torch.equal(a[k], b[k]), k


def test_bf16_eval_indices_equal_and_close_to_jax(case, monkeypatch):
    """Every FPS index and selection mask of the bf16 forward equals the
    float32 forward's (selection stays float32). The outputs are float32 and
    finite and lie within ``tests/test_bf16.py:219``'s bound of JAX's bf16
    forward: logits cosine > 0.999, argmax agreement > 0.98, every regressed
    MANO parameter within 3e-2; tightened here to cosine > 0.9999 and 3e-3
    (measured: 1 - cosine 6.6e-6, 2.4e-4, about what lies between JAX's
    bf16 and float32 forwards: 3.7e-6, 2.4e-4). These bounds would pass the
    float32 forward too, so the logits must differ from its bits; which
    layers run in bfloat16 is held in ``tests/test_torch_bf16_routing.py``."""
    x = case["x"]
    out32, seen32 = recorded_forward(port_net(case["variables"]), x, monkeypatch)
    out, seen16 = recorded_forward(port_net(case["variables"], bf16_eval=True), x,
                                   monkeypatch)
    assert len(seen16) == len(seen32) == 3 + 3 + 2 + 2 * 2
    for a, b in zip(seen32, seen16):
        assert torch.equal(a, b)
    assert not torch.equal(out["class_logits"], out32["class_logits"])
    ref = case["ref"]
    a, b = ref["class_logits"], out["class_logits"].numpy()
    assert out["class_logits"].dtype == torch.float32 and np.isfinite(b).all()
    cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    assert cos > 0.9999, cos
    agree = float((a.argmax(-1) == b.argmax(-1)).mean())
    assert agree > 0.98, agree
    for side in ("left", "right"):
        for k in HEAD_KEYS:
            v = out[side][k]
            assert v.dtype == torch.float32 and torch.isfinite(v).all()
            d = float(np.abs(v.numpy() - ref[side][k]).max())
            assert d < 3e-3, (side, k, d)


@pytest.mark.parametrize("switch,mode", [("bf16_eval", "train"), ("bf16_train", "eval")])
def test_bf16_switch_leaves_the_other_mode_bitwise(case, switch, mode):
    """``bf16_eval`` leaves the training forward (outputs and BatchNorm
    statistics) bitwise, ``bf16_train`` the eval forward
    (``tests/test_bf16.py:50, :249``)."""
    x = case["x"][:1, :64]
    outs = []
    for model in ({}, {switch: True}):
        net = port_net(case["variables"], dropout_classifier=0.0, dropout_query=0.0,
                       dropout_regressor=0.0, **model)
        net.train(mode == "train")
        with torch.no_grad():
            out = net(x)
        outs.append([out["class_logits"]] + [out[s][k] for s in ("left", "right")
                                             for k in HEAD_KEYS]
                    + list(net.buffers()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
