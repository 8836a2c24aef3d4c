"""The whole TEHNet with its event axis sharded over two gloo ranks
(``ModelConfig.event_parallel``, ``TEHNet(event_mesh=...)``) on the CPU,
against the same port in one process: the eval forward
(``tests/test_event_parallel.py:142``) and a float64 training step on the
``dense_train`` route (:277); and that route against the gather route in
one process, float64 (``tests/test_model.py:326``). The sharded functions
themselves are held to JAX's in ``tests/test_torch_event_parallel.py``.

Sizes are cut for the CPU clock: B=1 and N=64 for the training step (sa2
pairs 128 centroids with 512 points whatever N is), N=128 for the eval
forward. The ranks start once, in a module fixture; the one-process runs
take place in this process meanwhile.
"""

import numpy as np
import pytest
import torch

from ev2hands_tpu_torch.config import ModelConfig
from ev2hands_tpu_torch.model.tehnet import TEHNet
from ev2hands_tpu_torch.parallel import mesh as pm
from ev2hands_tpu_torch.weights import init_weights

N_EVENT = 2
EVAL_B, EVAL_N = 2, 128
TRAIN_N = 64
HEAD_KEYS = ("global_orient", "hand_pose", "betas", "transl")


def eval_forward(mesh):
    """TEHNet's eval forward (float32, seeded weights) on an ERPC-like cloud
    -> its outputs as numpy."""
    cfg = ModelConfig(n_points=EVAL_N, fps_deterministic=True, event_parallel=True)
    net = TEHNet(cfg, device="cpu", event_mesh=mesh)
    net.load_state_dict(init_weights(torch.Generator().manual_seed(0), cfg))
    rng = np.random.RandomState(2)
    events = np.concatenate([rng.rand(EVAL_B, EVAL_N, 2) * 2 - 1,
                             np.sort(rng.rand(EVAL_B, EVAL_N, 1) * 2 - 1, 1),
                             rng.randint(1, 5, (EVAL_B, EVAL_N, 2))], -1)
    net.eval()
    with torch.no_grad():
        out = net(torch.as_tensor(events, dtype=torch.float32))
    return {"class_logits": out["class_logits"].numpy(),
            **{side: {k: out[side][k].numpy() for k in HEAD_KEYS}
               for side in ("left", "right")}}


def train_step(mesh, grouping="dense"):
    """A float64 training forward and backward of sum(outputs^2), dropout
    drawn from one seed -> (loss, running statistics, gradients summed over
    the ranks)."""
    cfg = ModelConfig(n_points=TRAIN_N, fps_deterministic=True, grouping=grouping,
                      dense_train=grouping == "dense", dense_chunk=512,
                      regressor_dense_chunk=512, event_parallel=True)
    net = TEHNet(cfg, device="cpu", event_mesh=mesh)
    net.load_state_dict(init_weights(torch.Generator().manual_seed(1), cfg))
    net.double().train()
    x = torch.as_tensor(np.random.RandomState(7).randn(1, TRAIN_N, 5))
    out = net(x, torch.Generator().manual_seed(11))
    loss = (out["class_logits"] ** 2).sum() + sum(
        (out[s][k] ** 2).sum() for s in ("left", "right") for k in HEAD_KEYS)
    loss.backward()
    if mesh is not None:
        pm.all_sum_grads(list(net.parameters()), mesh, 1.0 / mesh.event_size)
    return (loss.item(), {k: b.numpy().copy() for k, b in net.named_buffers()},
            {k: p.grad.numpy().copy() for k, p in net.named_parameters()})


def rank_cases():
    torch.set_num_threads(2)
    mesh = pm.create_event_mesh(N_EVENT, 1, device="cpu")
    return {"eval": eval_forward(mesh), "train": train_step(mesh)}


@pytest.fixture(scope="module")
def runs():
    """(the two ranks' results, the one-process runs)."""
    ranks = pm.start_ranks(rank_cases, N_EVENT, env={"OMP_NUM_THREADS": "2"})
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        ref = {"eval": eval_forward(None), "train": train_step(None),
               "gather": train_step(None, "gather")}
    finally:
        torch.set_num_threads(threads)
        results = ranks.join(timeout=300)
    return results, ref


def flat(grads):
    return np.concatenate([grads[k].ravel() for k in sorted(grads)])


def test_event_sharded_eval_forward(runs):
    """Every output of the eval forward on both event ranks within 1e-4 of
    the one-process dense forward."""
    results, ref = runs
    for res in results:
        got = res["eval"]
        np.testing.assert_allclose(got["class_logits"], ref["eval"]["class_logits"],
                                   rtol=1e-4, atol=1e-4)
        for side in ("left", "right"):
            for k in HEAD_KEYS:
                np.testing.assert_allclose(got[side][k], ref["eval"][side][k], rtol=1e-4,
                                           atol=1e-4, err_msg=f"{side}/{k}")


def test_event_sharded_train_step_f64(runs):
    """The dense_train training step with the event axis sharded against one
    process, float64: the loss within rtol 1e-9, every running statistic
    within rtol 1e-8, the gradients within rel 1e-8, the JAX package's
    bounds (``tests/test_event_parallel.py:277``)."""
    results, ref = runs
    loss, buffers, grads = ref["train"]
    assert np.isfinite(loss)
    for got_loss, got_buffers, got_grads in (r["train"] for r in results):
        np.testing.assert_allclose(got_loss, loss, rtol=1e-9)
        for k, v in buffers.items():
            np.testing.assert_allclose(got_buffers[k], v, rtol=1e-8, atol=1e-10, err_msg=k)
        rel = np.linalg.norm(flat(got_grads) - flat(grads)) / np.linalg.norm(flat(grads))
        assert rel < 1e-8, rel


def test_dense_train_matches_gather_f64(runs):
    """One process: the dense_train route against the gather route, float64
    (``tests/test_model.py:326``): the loss within rtol 1e-9, running
    statistics within 1e-9, gradients within rel 1e-8."""
    _, ref = runs
    (l1, b1, g1), (l2, b2, g2) = ref["gather"], ref["train"]
    np.testing.assert_allclose(l2, l1, rtol=1e-9)
    for k, v in b1.items():
        np.testing.assert_allclose(b2[k], v, rtol=1e-9, atol=1e-9, err_msg=k)
    assert np.linalg.norm(flat(g2) - flat(g1)) / np.linalg.norm(flat(g1)) < 1e-8
