"""finetune.make_finetune_eval_step and evaluate_finetune against the JAX
package's on the CPU: the same Ev2Hands-R recording (written by the JAX
package), reader seed, seeded weights (the port's state dict, converted for
JAX by its checkpoint reader) and resample draws (JAX's, given to the port
through ``evaluate_finetune(draws=...)``). One JAX compile: the eval step's,
shared by both checks."""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ev2hands_tpu import checkpoint as jckpt
from ev2hands_tpu import finetune as jft
from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.config import ModelConfig as JModelConfig
from ev2hands_tpu.events import erpc as je
from ev2hands_tpu.events import real_streams as jrs
from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
from ev2hands_tpu.model import tehnet as jt
from ev2hands_tpu_torch import finetune as tft
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events import real_streams as trs
from ev2hands_tpu_torch.model.tehnet import TEHNet

N, BS, FRAMES = 256, 2, 4
# one chunk per dense layer: the same values, a JAX program that compiles
# several times faster than the default chunks'
CHUNKS = dict(dense_chunk=512, regressor_dense_chunk=128)


def test_evaluate_finetune_matches_jax(tmp_path):
    """Two batches of two windows: the eval step's predicted joints within
    1e-3 mm of JAX's (float32 sums in another order) on batch 0, and the
    whole evaluation's score and AUCs within 1e-4, each PCK step within one
    joint of one frame."""
    rec = jrs.write_synthetic_ev2hands_r(str(tmp_path / "rec.pickle"), n_events=30000,
                                         n_frames=12, seed=4)
    jcfg = JCFG.replace(model=JModelConfig(n_points=N, **CHUNKS),
                        train=dataclasses.replace(JCFG.train, eval_batch_size=BS))
    weights = tw.init_weights(torch.Generator().manual_seed(5), ModelConfig(n_points=N))
    variables = jckpt.torch_to_flax({k: v.numpy() for k, v in weights.items()})
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    j_hands = {s: h.params for s, h in create_mano_hands(synthetic_mano_models(0)).items()}
    j_step = jft.make_finetune_eval_step(jt.TEHNet(cfg=jcfg.model), j_hands, jcfg)
    ref_metrics, ref_score = jft.evaluate_finetune(
        j_step, state, jrs.Ev2HandRReader(rec, seed=3), jcfg, max_frames=FRAMES)

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

    def jax_draws(i, batch):
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        return torch.from_numpy(np.array(draws_of(batch["events"], batch["event_valid"],
                                                  key)))

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N, **CHUNKS),
                                 train=dataclasses.replace(DEFAULT_CONFIG.train,
                                                           eval_batch_size=BS))
    net = TEHNet(cfg.model, device="cpu")
    net.load_state_dict(weights, strict=True)
    step = tft.make_finetune_eval_step(net, ttr.build_hands(cfg, synthetic=True,
                                                            device="cpu"), cfg, "cpu")

    batch = next(trs.Ev2HandRReader(rec, seed=3).batches(BS))
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    want = np.asarray(j_step(state, jnp.asarray(batch["events"]),
                             jnp.asarray(batch["event_valid"]), key))
    got = step(batch["events"], batch["event_valid"], draws=jax_draws(0, batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)

    metrics, score = tft.evaluate_finetune(step, trs.Ev2HandRReader(rec, seed=3), cfg,
                                           max_frames=FRAMES, device="cpu",
                                           draws=jax_draws)
    assert np.isfinite(ref_score)
    np.testing.assert_allclose(score, ref_score, rtol=1e-4)
    for k, curve in ref_metrics["pck3d"].items():
        np.testing.assert_allclose(metrics["pck3d"][k], curve, rtol=0,
                                   atol=1.0 / (42 * FRAMES) + 1e-7)
        np.testing.assert_allclose(metrics["auc"][k], ref_metrics["auc"][k], rtol=1e-4)
