"""The port's serving function against the JAX package's on the CPU:
``export.make_serving_fn`` against ``ev2hands_tpu.export.make_serving_fn``
on the same weights and resample indices, the uniforms that carry those
indices, and ``torch.library.opcheck`` on each registered kernel op.
The export itself, the ``.pt2`` round trip and the ops in the exported
graph are in ``tests/test_torch_export.py``.

Small size: n_points=128, a 64x48 sensor, B=2 windows of up to 256
events.
"""

import jax
import numpy as np
import pytest
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu import export as jexport
from ev2hands_tpu.config import Config as JConfig
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.config import SensorConfig as JSensorConfig
from ev2hands_tpu.mano import create_mano_hands
from ev2hands_tpu.mano import synthetic_mano_models as j_synthetic
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import export as tex
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig, SensorConfig
from ev2hands_tpu_torch.events import erpc as te
from ev2hands_tpu_torch.model import tehnet as tt
from ev2hands_tpu_torch.ops import fps as tf
from ev2hands_tpu_torch.ops import grouping as tg

from test_torch_erpc_mano import assert_erpc_equal
from test_torch_export import B, CHUNKS, H, HAND_KEYS, MAX_EVENTS, N, W, real_windows


def uniforms_for(indices, n_valid):
    """float64 uniforms that ``draws_from_uniforms`` maps to ``indices``:
    the middle of each index's interval."""
    total = np.maximum(np.asarray(n_valid, np.float64), 1)[:, None]
    return (np.asarray(indices, np.float64) + 0.5) / total


def jax_real_indices(events, valid, key, n_out=N, width=W, height=H):
    """The resample indices erpc_real_batch_transform draws inside JAX, and
    the windows' valid pixel rows."""
    b, n_ev, _ = events.shape
    _, _, n_valid = te.rasterize_erpc(
        torch.from_numpy(events), torch.zeros(b, n_ev, dtype=torch.int32), width,
        height, time_scale=1.0, event_valid=torch.from_numpy(valid),
        max_pixels=min(n_ev, max(n_out * 2, 2048)))
    idx = np.stack([
        np.asarray(jax.random.randint(jax.random.split(k, 3)[2], (n_out,), 0,
                                      max(int(n_valid[i]), 1)))
        for i, k in enumerate(jax.random.split(key, b))])
    return idx, n_valid.numpy()


@pytest.fixture(scope="module")
def served():
    rng = np.random.RandomState(0)
    events, valid = real_windows(rng)
    key = jax.random.PRNGKey(3)

    cfg = DEFAULT_CONFIG.replace(sensor=SensorConfig(W, H),
                                 model=ModelConfig(n_points=N, **CHUNKS))
    state = tw.init_weights(torch.Generator().manual_seed(0), cfg.model)
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in state.items()})
    jcfg = JConfig(sensor=JSensorConfig(W, H),
                   model=JModelConfig(n_points=N, fps_deterministic=True, **CHUNKS))
    jnet = jt.TEHNet(cfg=jcfg.model)
    jhands = {s: h.params for s, h in create_mano_hands(j_synthetic(0)).items()}
    jfn = jexport.make_serving_fn(jnet, jhands, jcfg, weights=variables)
    ref = jax.jit(jfn)(events, valid, key)

    net = tt.TEHNet(cfg.model, device="cpu")
    net.load_state_dict(state, strict=True)
    net.eval()
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    idx, n_valid = jax_real_indices(events, valid, key)
    uniforms = torch.from_numpy(uniforms_for(idx, n_valid))
    with torch.no_grad():
        live = tex.make_serving_fn(net, hands, cfg)(
            torch.from_numpy(events), torch.from_numpy(valid), uniforms)
    return dict(ref=ref, live=live, uniforms=uniforms, idx=idx, n_valid=n_valid)


def test_uniforms_give_jax_indices(served):
    """The uniforms handed to the port map back to JAX's indices exactly."""
    got = te.draws_from_uniforms(served["uniforms"], torch.from_numpy(served["n_valid"]))
    np.testing.assert_array_equal(got.numpy(), served["idx"])


def test_serving_fn_matches_jax(served):
    """The port's serving function against JAX's make_serving_fn on the same
    weights and resample indices: the ERPC cloud as the ERPC tests hold it,
    every other output within 1e-4 (atol and rtol, the golden tolerance of
    the slice test), the segmentation argmax equal."""
    ref, live = served["ref"], served["live"]
    assert set(live) == set(ref)
    assert_erpc_equal(live["events"], ref["events"], jitted=True)
    np.testing.assert_array_equal(live["seg"].numpy(), np.asarray(ref["seg"]))
    for k in ["class_logits"] + [f"{s}_{h}" for s in ("left", "right") for h in HAND_KEYS]:
        np.testing.assert_allclose(live[k].numpy(), np.asarray(ref[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


def _op_cases():
    rng = np.random.RandomState(5)
    xyz = torch.from_numpy(rng.randn(2, 96, 3).astype(np.float32))
    start = torch.tensor([0, 95], dtype=torch.int32)
    Bq, S, Np, nb = 2, 16, 128, 64

    def folded(c1, c2, c3):
        shapes = ((Bq, Np, c1), (Bq, S, c1), (c1, c2), (c2,), (c2, c3), (c3,))
        return tg.FoldedScale(*(torch.from_numpy(rng.randn(*s).astype(np.float32))
                                for s in shapes))

    sel = torch.from_numpy((rng.rand(Bq, 2, S, Np) < 0.05).astype(np.float32))
    act = torch.stack([tg.tile_activity(sel[:, r], nb) for r in range(2)], 1).amax(1)
    stacked, sections, blocks = tg.stack_folded_scales(
        [folded(4, 8, 8), folded(8, 8, 16)])
    return {
        "fps": (tf.fps_op, (xyz, 40, start)),
        "fps_no_start": (tf.fps_op, (xyz, 40, None)),
        "msg_scale_sparse": (tg.msg_scale_sparse_op,
                             (*folded(4, 8, 8), sel[:, 0], act, nb)),
        "msg_fused_scales_sparse": (
            tg.msg_fused_scales_sparse_op,
            (*stacked, sel, act, list(sections), nb, [c for b in blocks for c in b])),
    }


@pytest.mark.parametrize("name", ["fps", "fps_no_start", "msg_scale_sparse",
                                  "msg_fused_scales_sparse"])
def test_op_passes_opcheck(name):
    """Schema, fake (shape) function against the real op, and the op's
    behaviour under torch's dispatch and compile machinery."""
    op, args = _op_cases()[name]
    torch.library.opcheck(op, args)
