"""Which layers of TEHNet compute in bfloat16 under ``ModelConfig.bf16_eval``
and ``bf16_train``, against the JAX package's routing of ``dtype``
(``ev2hands_tpu/model/layers.py:41-50, 247-260, 795-902``,
``ev2hands_tpu/model/tehnet.py:231-240``), at N=256.

For every Dense, Conv and BatchNorm that JAX's forward calls, the dtype of
its output is read from a trace (``jax.eval_shape`` under
``flax.linen.intercept_methods``, no compile); for every ``Pointwise``,
``Conv1dK3`` and ``BatchNorm`` that the port's forward calls, from a forward
hook. Both run one cloud of 128 events (the route of every layer is that
of N=256, ``tests/test_bf16.py``'s size, but sa1's block-sparse one). The
two records, the JAX names mapped to the port's through
``weights.flax_to_torch``, must be equal: the same layers called, each with
the same output dtype, in the switch's own mode and in the other mode. The
switch's own mode must also change the outputs, so a switch that does
nothing fails. The sa1 block-sparse route, which JAX takes only on a TPU,
is held on the port alone: it keeps its float32 folded weights.
"""

import functools

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import ModelConfig
from ev2hands_tpu_torch.model import layers as tl
from ev2hands_tpu_torch.model import tehnet as tt
from test_torch_fused_regressor import HEAD_KEYS, N, event_cloud, numpy_state

# no dropout; each dense scale in one centroid chunk, which shortens JAX's
# trace and routes no layer otherwise
NO_DROPOUT = dict(dropout_classifier=0.0, dropout_query=0.0, dropout_regressor=0.0,
                  dense_chunk=512, regressor_dense_chunk=128)
SMALL = 128


@pytest.fixture(scope="module")
def case():
    rng = np.random.RandomState(3)
    variables = numpy_state(rng)
    leaves, _ = jax.tree_util.tree_flatten_with_path(variables)
    labelled = tw.flax_to_torch(jax.tree.unflatten(
        jax.tree.structure(variables),
        [np.full(v.shape, i, np.float32) for i, (_, v) in enumerate(leaves)]))
    port_of_leaf = {int(t.reshape(-1)[0]): k.rsplit(".", 1)[0] for k, t in labelled.items()}
    port_name = {tuple(p.key for p in path[1:-1]): port_of_leaf[i]
                 for i, (path, _) in enumerate(leaves)}
    return dict(variables=variables, state=tw.flax_to_torch(variables),
                x=event_cloud(rng, B=1, n=SMALL), x_full=event_cloud(rng, B=1, n=N),
                port_name=port_name, jax={}, port={})


def jax_record(case, model, train):
    """{port module name: output dtypes} of every Dense, Conv and BatchNorm
    call in JAX's forward, traced once per configuration."""
    key = (tuple(sorted(model.items())), train)
    if key not in case["jax"]:
        case["jax"][key] = trace_record(case, model, train)
    return case["jax"][key]


def trace_record(case, model, train):
    seen = {}

    def tap(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__" and isinstance(
                context.module, (nn.Dense, nn.Conv, nn.BatchNorm)):
            name = case["port_name"][context.module.path]
            seen.setdefault(name, set()).add(str(out.dtype).split(".")[-1])
        return out

    net = jt.TEHNet(cfg=JModelConfig(n_points=SMALL, fps_deterministic=True, **NO_DROPOUT,
                                     **model))

    def forward(v, x):
        with nn.intercept_methods(tap):
            return net.apply(v, x, train=train, mutable=["batch_stats"] if train else False)

    jax.eval_shape(forward, case["variables"], case["x"])
    return seen


def port_record(case, model, train, x=None):
    """(outputs, {module name: output dtypes}) of every Pointwise,
    Conv1dK3 and BatchNorm call in the port's forward of ``x`` (by default
    the 128-event cloud)."""
    x = case["x"] if x is None else x
    net = tt.TEHNet(ModelConfig(n_points=x.shape[1], fps_deterministic=True, **NO_DROPOUT,
                                **model), device="cpu")
    net.load_state_dict(case["state"], strict=True)
    net.train(train)
    seen = {}
    for name, m in net.named_modules():
        if isinstance(m, (tl.Pointwise, tl.Conv1dK3, tl.BatchNorm)):
            m.register_forward_hook(lambda m, a, out, name=name: seen.setdefault(
                name, set()).add(str(out.dtype).split(".")[-1]))
    with torch.no_grad():
        out = net(torch.from_numpy(x))
    return [out["class_logits"]] + [out[s][k] for s in ("left", "right")
                                    for k in HEAD_KEYS], seen


@pytest.mark.parametrize("model,train", [
    (dict(bf16_eval=True), False),
    (dict(bf16_eval=True), True),
    (dict(bf16_train=True), True),
    (dict(bf16_train=True), False),
    (dict(bf16_train=True, uv_split_gather=True), True),
    (dict(bf16_eval=True, fused_regressors=True), False),
], ids=["bf16_eval-eval", "bf16_eval-train", "bf16_train-train", "bf16_train-eval",
        "bf16_train-uv-train", "bf16_eval-fused-eval"])
def test_bf16_routing_matches_jax(case, model, train):
    """The port's layer dtypes equal JAX's: under ``bf16_eval`` in eval the
    set-abstraction, sa3, feature-propagation, classifier-trunk and query
    convs and their BatchNorms in bfloat16, ``classifier_conv_1`` and the
    heads' fc stack in float32; under ``bf16_train`` in training the same
    convs in bfloat16 and every BatchNorm in float32; every layer float32 in
    the other mode. Where the switch's mode is on, the outputs differ from
    the float32 forward's; elsewhere they are its bits."""
    want = jax_record(case, model, train)
    out, got = port_record(case, model, train)
    assert got == want
    on = model.get("bf16_train" if train else "bf16_eval", False)
    assert any(dts == {"bfloat16"} for dts in got.values()) == on
    plain = {k: v for k, v in model.items() if not k.startswith("bf16")}
    key = (tuple(sorted(plain.items())), train)
    if key not in case["port"]:
        case["port"][key] = port_record(case, plain, train)[0]
    out32 = case["port"][key]
    same = all(torch.equal(a, b) for a, b in zip(out, out32))
    assert same != on


def test_bf16_eval_sparse_route_stays_float32(case, monkeypatch):
    """With sa1's scales on the block-sparse route (taken at N=256 by
    lowering the pair threshold to sa1's 512 x 256 pairs, above every other
    layer's), ``bf16_eval`` leaves sa1's layers uncalled and the kernel
    wrapper's folded weights and points float32, and every other layer
    runs as JAX routes it."""
    calls = []
    real = tl.msg_scale_sparse

    def wrapper(folded, *a, **k):
        calls.append({str(t.dtype).split(".")[-1] for t in folded})
        return real(folded, *a, **k)

    monkeypatch.setattr(tl, "SPARSE_MIN_PAIRS", 512 * N)
    monkeypatch.setattr(tl, "msg_scale_sparse", wrapper)
    _, got = port_record(case, dict(bf16_eval=True), False, case["x_full"])
    assert calls == [{"float32"}] * 3
    want = jax_record(case, dict(bf16_eval=True), False)
    assert got == {k: v for k, v in want.items() if not k.startswith("sa1.")}
