"""``ModelConfig.bf16_train`` on the CPU, against the JAX package's bf16
training (``tests/test_bf16.py:61, :96``) at its size (N=256,
deterministic FPS, no dropout, whose draws differ between the packages):
one training forward of TEHNet, with parameters, gradients and BatchNorm
statistics float32 (one set-abstraction layer's gradient is held in
``tests/test_torch_bf16_layer.py``); and the ``--bf16`` flag of the
training and finetuning CLIs. One JAX compile: the training forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import finetune as tft
from ev2hands_tpu_torch import train as ttr
from test_torch_fused_regressor import HEAD_KEYS, N, event_cloud, numpy_state, port_net

NO_DROPOUT = dict(dropout_classifier=0.0, dropout_query=0.0, dropout_regressor=0.0)


def sum_loss(out):
    """``tests/test_bf16.py:75``'s loss of the outputs."""
    return ((out["class_logits"] ** 2).mean()
            + sum((out[s][k] ** 2).mean() for s in ("left", "right") for k in HEAD_KEYS))


def test_bf16_training_forward_matches_jax():
    """The port's bf16 training forward against JAX's: the loss within rtol
    5e-2 (``tests/test_bf16.py:86`` allows 1e-1 between JAX's bf16 and
    float32; measured 1.5e-2: each side's bf16 loss lies within 1e-2 of the
    float32 loss, on which the two agree to 1e-4); outputs and BatchNorm statistics float32 and finite (the
    statistics are not compared: at random init the max-pools' routing
    flips under bf16 rounding, ``tests/test_bf16.py:10``); the backward's
    gradients float32 for every parameter. The loss bound would pass the
    float32 forward too, so the loss must differ from its bits; which layers
    run in bfloat16 is held in ``tests/test_torch_bf16_routing.py``."""
    rng = np.random.RandomState(2)
    variables = numpy_state(rng)
    x = event_cloud(rng) * np.float32(0.5)
    net = jt.TEHNet(cfg=JModelConfig(n_points=N, fps_deterministic=True, bf16_train=True,
                                     **NO_DROPOUT))

    @jax.jit
    def ref(v, x):
        out, upd = net.apply(v, x, train=True, mutable=["batch_stats"])
        return jnp.mean(out["class_logits"] ** 2) + sum(
            jnp.mean(out[s][k] ** 2) for s in ("left", "right") for k in HEAD_KEYS), upd

    loss_ref, _ = ref(variables, jnp.asarray(x))
    port = port_net(variables, bf16_train=True, **NO_DROPOUT).train()
    out = port(torch.from_numpy(x))
    loss = sum_loss(out)
    with torch.no_grad():
        loss32 = sum_loss(port_net(variables, **NO_DROPOUT).train()(torch.from_numpy(x)))
    assert loss.item() != loss32.item()
    loss.backward()
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=5e-2)
    for k, b in port.named_buffers():
        assert b.dtype == torch.float32 and torch.isfinite(b).all(), k
    for k, p in port.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32, k


@pytest.mark.parametrize("cli", ["train", "finetune"])
def test_bf16_flag_of_the_clis(monkeypatch, cli):
    """``--bf16`` sets ``bf16_train`` in the configuration the CLI runs; it
    is off without the flag."""
    mod, fn = (ttr, "train") if cli == "train" else (tft, "finetune")
    seen = []
    monkeypatch.setattr(mod, fn, lambda cfg, *a, **k: seen.append(cfg.model.bf16_train))
    args = ["--data_root", "unused", "--synthetic_mano", "--device", "cpu"]
    mod.main(args + ["--bf16"])
    mod.main(args)
    assert seen == [True, False]
