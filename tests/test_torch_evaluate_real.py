"""evaluate_real.make_real_eval_step and evaluate_recording against the JAX
package's on the CPU: one synthetic Ev2Hands-R recording (written by the
JAX package), the same seeded weights (the port's state dict, read by
JAX's checkpoint reader), and JAX's resample draws given to the port
(``evaluate_recording(draws=...)``), over the first 4 sliding windows in
batches of 2. One JAX compile: the eval step's.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu import evaluate_real as jevr
from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.events import real_streams as jrs
from ev2hands_tpu.losses import CollisionContext as JCollisionContext
from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu.ops import collision as jc
from ev2hands_tpu_torch import evaluate_real as tevr
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events import real_streams as trs
from ev2hands_tpu_torch.model.tehnet import TEHNet

N, BS, WINDOWS = 256, 2, 4
# one chunk per dense layer: the same values, a faster JAX compile
CHUNKS = dict(dense_chunk=512, regressor_dense_chunk=128)


def jax_report(rec, state_dict):
    """JAX's evaluate_recording of ``rec`` with the weights ``state_dict``
    (the port's layout, as numpy)."""
    variables = jckpt.torch_to_flax(state_dict)
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    models = synthetic_mano_models(0)
    faces = jc.build_two_hand_faces(models["left"].faces, models["right"].faces)
    ctx = JCollisionContext(faces=jnp.asarray(faces),
                            adjacency=jnp.asarray(jc.build_adjacency_mask(faces)))
    jcfg = JCFG.replace(model=JModelConfig(n_points=N, **CHUNKS))
    j_step = jevr.make_real_eval_step(
        jt.TEHNet(cfg=jcfg.model),
        {s: h.params for s, h in create_mano_hands(models).items()}, ctx, jcfg)
    return jevr.evaluate_recording(j_step, state, jrs.RealStream(rec), jcfg,
                                   batch_size=BS, max_windows=WINDOWS)


def test_evaluate_recording_matches_jax(tmp_path):
    """Every report entry against JAX's: frames and the ground truth's root
    distances equal; MPJPE within rtol 1e-4 and the non-collision score
    within 1e-3 points (float32 sums in another order); each PCK step
    within one joint of one window, each AUC within 1e-4 of JAX's plus
    that step."""
    rec = jrs.write_synthetic_ev2hands_r(str(tmp_path / "rec.pickle"), n_events=20000,
                                         n_frames=10, seed=6)
    weights = tw.init_weights(torch.Generator().manual_seed(8), ModelConfig(n_points=N))
    ref = jax_report(rec, {k: v.numpy() for k, v in weights.items()})

    @jax.jit
    def draws_of(events, valid, key):
        """The resample draws of JAX's real-data transform for a batch."""
        mp = min(events.shape[1], max(2 * N, 2048))
        _, _, n_valid = jax.vmap(lambda e, v: je.rasterize_erpc(
            e, jnp.zeros(e.shape[0], jnp.int32), 346, 260, event_valid=v,
            time_scale=1.0, max_pixels=mp))(events, valid)
        return jax.vmap(lambda k, n: jax.random.randint(
            jax.random.split(k, 3)[2], (N,), 0, jnp.maximum(n, 1)))(
            jax.random.split(key, events.shape[0]), n_valid)

    frames = [0]

    def jax_draws(i, batch):
        """JAX's draws for batch ``i``: its key is folded with the windows
        scored before it."""
        key = jax.random.fold_in(jax.random.PRNGKey(0), frames[0])
        frames[0] += batch["n_valid"]
        return torch.from_numpy(np.array(draws_of(batch["events"], batch["event_valid"],
                                                  key)))

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, **CHUNKS))
    net = TEHNet(cfg.model, device="cpu")
    net.load_state_dict(weights, strict=True)
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    step = tevr.make_real_eval_step(net, hands, ttr.build_collision_context(hands), cfg,
                                    "cpu")
    got = tevr.evaluate_recording(step, trs.RealStream(rec), cfg, batch_size=BS,
                                  max_windows=WINDOWS, device="cpu", draws=jax_draws)

    assert got["frames"] == ref["frames"] == WINDOWS
    np.testing.assert_allclose(got["root_distance_mm"], ref["root_distance_mm"], rtol=1e-6)
    np.testing.assert_allclose(got["mpjpe_mm"], ref["mpjpe_mm"], rtol=1e-4)
    np.testing.assert_allclose(got["non_collision_pct"], ref["non_collision_pct"], rtol=0,
                               atol=1e-3)
    step_tol = 1.0 / (42 * WINDOWS) + 1e-7
    for k, curve in ref["pck3d"].items():
        np.testing.assert_allclose(got["pck3d"][k], curve, rtol=0, atol=step_tol)
        np.testing.assert_allclose(got["auc"][k], ref["auc"][k], rtol=0,
                                   atol=1e-4 + step_tol)
