"""The data-parallel slice as a whole against the JAX package: the port's
gradient over two gloo ranks against JAX's ``grad`` over ``create_mesh(2)``
on the virtual CPU devices, as ``tests/test_dist.py:41-86`` holds JAX's
to one device. Eval-mode forward (no dropout, BatchNorm's running
statistics), ERPC without augmentation on JAX's resample draws, the same
seeded weights (the port's state dict, converted for JAX by its checkpoint
reader), float32: within rel 1e-4 of JAX's gradient.

One JAX compile, the whole model's gradient; the ranks run meanwhile. The
JAX program takes each dense scale's centroids in one chunk (``dense_chunk``
and ``regressor_dense_chunk`` at N; the centroids are independent, so the
gradient is the same), which halves its trace and compile on the CPU. The
ranks import this module, so JAX is imported inside the test only."""

import dataclasses

import numpy as np
import torch

from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch import weights as tw
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events.erpc import erpc_batch_transform
from ev2hands_tpu_torch.model.tehnet import TEHNet
from ev2hands_tpu_torch.parallel import mesh as pm

B, N, PAIRS = 2, 128, 8
FAST_COMPILE = {"xla_llvm_disable_expensive_passes": True}


def eval_mode_grads(mesh, state, batch, draws, collision_pairs):
    """The gradient of the eval-mode loss (``tests/test_dist.py:41``: no
    dropout, BatchNorm's running statistics) of this rank's rows of the
    global ``batch``, ERPC without augmentation on the given global
    ``draws``, summed over the mesh's ranks; float32 -> {name: gradient}."""
    cfg = DEFAULT_CONFIG.replace(
        model=ModelConfig(n_points=batch["events"].shape[1], fps_deterministic=True),
        loss=dataclasses.replace(DEFAULT_CONFIG.loss,
                                 collision_max_pairs=collision_pairs))
    net = TEHNet(cfg.model, device="cpu", mesh=mesh)
    net.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    rows, draws, _ = ttr.shard_step_inputs(mesh, batch, torch.as_tensor(draws))
    rows = ttr.to_device(rows, "cpu")
    erpc = erpc_batch_transform(rows["events"], rows["labels"], draws=draws,
                                n_out=cfg.model.n_points)
    targets = {"left": rows["left"], "right": rows["right"],
               "handedness": rows["handedness"], "class_logits": erpc.labels}
    net.eval()
    loss, _ = ttr.forward_losses(net, hands, ttr.build_collision_context(hands), cfg,
                                 erpc.events, targets)
    loss.backward()
    pm.all_sum_grads(list(net.parameters()), mesh)
    return {k: p.grad.numpy().copy() for k, p in net.named_parameters()}


def jax_grad_rank(state, batch, draws, collision_pairs):
    """A rank of the test: ``eval_mode_grads`` over the two ranks."""
    torch.set_num_threads(2)
    return eval_mode_grads(pm.create_mesh(2, device="cpu"), state, batch, draws,
                           collision_pairs)


def test_two_rank_gradient_matches_jax_mesh():
    import jax

    import __graft_entry__ as ge
    from ev2hands_tpu import checkpoint as jckpt
    from ev2hands_tpu.events.erpc import erpc_batch_transform as j_erpc
    from ev2hands_tpu.losses import mano_losses, total_loss
    from ev2hands_tpu.mano import create_mano_hands, synthetic_mano_models
    from ev2hands_tpu.model import TEHNet as JTEHNet
    from ev2hands_tpu.model import apply_mano
    from ev2hands_tpu.parallel.mesh import create_mesh, replicate, shard_batch
    from ev2hands_tpu.train import build_collision_context
    from test_torch_erpc_mano import jax_draws

    cfg = ge._small_cfg(n_points=N, batch=B, collision_pairs=PAIRS)
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dense_chunk=N,
                                                regressor_dense_chunk=N))
    batch = ge._fake_batch(cfg, B, np.random.RandomState(3))
    key = jax.random.PRNGKey(0)
    state = {k: v.numpy() for k, v in tw.init_weights(
        torch.Generator().manual_seed(4), ModelConfig(n_points=N)).items()}
    draws = jax_draws(batch["events"], batch["labels"], key, N)
    ranks = pm.start_ranks(jax_grad_rank, 2, state, batch, draws, PAIRS,
                           env={"OMP_NUM_THREADS": "2"})
    try:
        variables = jckpt.torch_to_flax(state)
        net = JTEHNet(cfg=cfg.model)
        hands_obj = create_mano_hands(synthetic_mano_models(0), cfg.mano.n_pose_comps)
        hands = {s: h.params for s, h in hands_obj.items()}
        ctx = build_collision_context(hands_obj)

        def loss_fn(params, batch_stats, b):
            erpc = j_erpc(b["events"], b["labels"], key, width=cfg.sensor.width,
                          height=cfg.sensor.height, n_out=N, augment=False)
            outputs = apply_mano(hands, net.apply(
                {"params": params, "batch_stats": batch_stats}, erpc.events,
                train=False))
            targets = {"left": b["left"], "right": b["right"],
                       "handedness": b["handedness"], "class_logits": erpc.labels}
            return total_loss(mano_losses(outputs, targets, hands, ctx, cfg.loss))

        mesh = create_mesh(2)
        args = (replicate(variables["params"], mesh),
                replicate(variables["batch_stats"], mesh), shard_batch(batch, mesh))
        grads = jax.jit(jax.grad(loss_fn)).lower(*args).compile(FAST_COMPILE)(*args)
        ref = tw.flax_to_torch({"params": jax.tree.map(np.asarray, grads),
                                "batch_stats": variables["batch_stats"]})
    finally:
        results = ranks.join(timeout=300)
    names = sorted(results[0])
    want = np.concatenate([ref[k].numpy().ravel() for k in names])
    for res in results:
        got = np.concatenate([res[k].ravel() for k in names])
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 1e-4, rel
    for k in names:
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)
