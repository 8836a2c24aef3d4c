"""The port's data-parallel route (``parallel/mesh.py``) on the CPU: two
ranks over gloo against one process.

The ranks start once, in a module fixture, and run every case; the one-
process references run in this process meanwhile. Counterparts of
``tests/test_dist.py``: the mesh helpers (:16-35), a training step (:41,
here in float64, with augmentation, random FPS starts and dropout, on a
batch whose halves differ in valid hands and handedness, so that the
global denominators and the sliced global draws both matter), the sharded
mid-run evaluations (:89, here also finetuning's), and the slot-sum
all-gather and its gradient. This module imports no JAX: the ranks import
it.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ev2hands_tpu_torch import finetune as tft
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events.real_streams import (
    Ev2HandRReader,
    write_synthetic_ev2hands_r,
)
from ev2hands_tpu_torch.events.streams import Ev2HandSReader, synthetic_ev2hands_s
from ev2hands_tpu_torch.mano.layer import ManoParams
from ev2hands_tpu_torch.model.tehnet import TEHNet, batchnorm_cancelled_biases
from ev2hands_tpu_torch.parallel import mesh as pm
from ev2hands_tpu_torch.weights import init_weights

B, N = 2, 128            # the global batch: a row a rank
EVAL_B, EVAL_FRAMES = 2, 2    # one batch an evaluation
RANKS_ENV = {"OMP_NUM_THREADS": "2"}


def step_batch():
    """A float64 raw batch of B windows whose two halves differ: rank 0's
    row has both hands valid, rank 1's a left hand only, and another
    handedness."""
    rng = np.random.RandomState(4)
    t = np.sort(rng.uniform(0, 5e6, (B, N)))
    events = np.stack([rng.randint(0, 346, (B, N)), rng.randint(0, 260, (B, N)), t,
                       rng.randint(0, 2, (B, N))], -1).astype(np.float64)

    def hand(valid):
        return {"global_orient": rng.randn(B, 3) * 0.1, "hand_pose": rng.randn(B, 45) * 0.1,
                "shape": rng.randn(B, 10) * 0.1, "trans": rng.randn(B, 3) * 0.1,
                "valid": np.asarray(valid, np.float64)}

    return {"events": events, "labels": rng.randint(0, 4, (B, N)).astype(np.int32),
            "left": hand([1, 1]), "right": hand([1, 0]),
            "handedness": np.array([[1, 1], [1, 0]], np.int32)}


def step_config():
    return DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N),
                                  train=dataclasses.replace(
                                      DEFAULT_CONFIG.train, eval_batch_size=EVAL_B))


def train_step(mesh):
    """One float64 training step of the seeded weights on ``step_batch``
    with the draws of ``seeded_generator(1, 0)`` -> (losses, gradients,
    BatchNorm buffers, parameters after Adam)."""
    cfg = step_config()
    net = TEHNet(cfg.model, device="cpu", mesh=mesh)
    net.load_state_dict(init_weights(torch.Generator().manual_seed(0), cfg.model))
    net.double()
    hands = {s: ManoParams(*(t.double() if t.is_floating_point() else t for t in p))
             for s, p in ttr.build_hands(cfg, synthetic=True, device="cpu").items()}
    step = ttr.make_train_step(net, hands, ttr.build_collision_context(hands), cfg,
                               ttr.make_optimizer(net.parameters(), cfg.train),
                               device="cpu")
    losses = step(step_batch(), ttr.seeded_generator(1, 0, "cpu"))
    return dict(losses=losses,
                grads={k: p.grad.numpy().copy() for k, p in net.named_parameters()},
                buffers={k: b.numpy().copy() for k, b in net.named_buffers()},
                params={k: p.detach().numpy().copy() for k, p in net.named_parameters()})


def evaluations(mesh, recording):
    """train.evaluate on synthetic Ev2Hands-S rows and
    finetune.evaluate_finetune on ``recording``, seeded weights, float32."""
    cfg = step_config()
    net = TEHNet(cfg.model, device="cpu", mesh=mesh)
    net.load_state_dict(init_weights(torch.Generator().manual_seed(1), cfg.model))
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    reader = Ev2HandSReader.from_rows(*synthetic_ev2hands_s(n_events=8192, n_frames=8), N)
    s = ttr.evaluate(ttr.make_eval_step(net, hands, cfg, "cpu"), reader, cfg,
                     max_frames=EVAL_FRAMES, device="cpu")
    r = tft.evaluate_finetune(tft.make_finetune_eval_step(net, hands, cfg, "cpu"),
                              Ev2HandRReader(recording, seed=3), cfg,
                              max_frames=EVAL_FRAMES, device="cpu")
    return {"train.evaluate": s, "finetune.evaluate_finetune": r}


def gather_inputs():
    """Each rank's float64 input [3, 4] and cotangent [2, 3, 4]."""
    rng = np.random.RandomState(7)
    return rng.randn(2, 3, 4), rng.randn(2, 2, 3, 4)


def gather_case(mesh):
    """all_gather_grad and all_sum_grad on rank-dependent float64 inputs,
    each rank backpropagating its own cotangent."""
    xs, ws = gather_inputs()
    out = {}
    for name, fn in (("gather", pm.all_gather_grad), ("sum", pm.all_sum_grad)):
        x = torch.tensor(xs[mesh.rank], requires_grad=True)
        y = fn(x, mesh, pm.DATA_AXIS)
        w = torch.tensor(ws[mesh.rank] if name == "gather" else ws[mesh.rank, 0])
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def loop_run(base_dir):
    """train.train with data_parallel=2: one step and one evaluation at a
    global batch of B, rows in memory -> (run directory, steps, files in
    it, a parameter's bits)."""
    cfg = step_config()
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, batch_size=B, data_parallel=2, save_iter=1, msg_iter=1,
        max_eval_iters=EVAL_B))
    rows = synthetic_ev2hands_s(n_events=8192, n_frames=4)
    run = ttr.train(cfg, synthetic_mano=True, max_iter=1, device="cpu", train_data=rows,
                    val_data=rows, base_dir=base_dir)
    files = sorted(os.listdir(run.run_dir)) if run.run_dir else None
    return run.run_dir, run.step, files, run.net.classifier[0].weight.detach().numpy()


def rank_cases(recording):
    """Every case of this file on one rank of two."""
    torch.set_num_threads(2)
    mesh = pm.create_mesh(2, device="cpu")
    small = {"events": np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4)}
    t = torch.full((3,), float(mesh.rank + 1))
    pm.replicate([t], mesh)
    return dict(rank=mesh.rank, shape=mesh.shape, device=str(mesh.device),
                shard=pm.shard_batch(small, mesh)["events"], replicated=t.numpy(),
                gather=gather_case(mesh), step=train_step(mesh),
                evaluations=evaluations(mesh, recording),
                loop=loop_run(os.path.join(os.path.dirname(recording), "runs")))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """(the two ranks' results, the one-process references)."""
    recording = str(tmp_path_factory.mktemp("rec") / "subject.pickle")
    write_synthetic_ev2hands_r(recording, n_events=20000, n_frames=10)
    ranks = pm.start_ranks(rank_cases, 2, recording, env=RANKS_ENV)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)     # the ranks take 2 threads each meanwhile
    try:
        ref = dict(step=train_step(None), evaluations=evaluations(None, recording))
    finally:
        torch.set_num_threads(threads)
        results = ranks.join(timeout=300)
    return results, ref


def test_mesh_helpers(two_ranks):
    """create_mesh over the two ranks, shard_batch's rows, replicate from
    rank 0 (``tests/test_dist.py:16-35``)."""
    results, _ = two_ranks
    full = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4)
    for r, res in enumerate(results):
        assert res["rank"] == r and res["shape"] == {"data": 2, "event": 1}
        assert res["device"] == "cpu"
        np.testing.assert_array_equal(res["shard"], full[4 * r:4 * r + 4])
        np.testing.assert_array_equal(res["replicated"], np.ones(3))
    with pytest.raises(ValueError, match="does not split"):
        pm.local_rows(np.zeros(3), pm.Mesh(None, None, None, 0, 2, 0, 1, "cpu"))


def test_all_gather_and_sum_match_autograd(two_ranks):
    """The slot-sum all-gather equals torch.cat of the ranks' inputs, and the
    gradient each rank gets is autograd's of the sum over ranks of their
    losses through torch.cat; likewise the differentiable SUM."""
    results, _ = two_ranks
    xs, ws = gather_inputs()
    x = torch.tensor(xs, requires_grad=True)
    sum(((x * torch.tensor(ws[r])).sum() for r in range(2))).backward()
    y = torch.tensor(xs, requires_grad=True)
    sum(((y.sum(0) * torch.tensor(ws[r, 0])).sum() for r in range(2))).backward()
    for r, res in enumerate(results):
        gathered, grad = res["gather"]["gather"]
        np.testing.assert_array_equal(gathered, xs)
        np.testing.assert_allclose(grad, x.grad.numpy()[r], rtol=1e-15)
        total, grad = res["gather"]["sum"]
        np.testing.assert_array_equal(total, xs.sum(0))
        np.testing.assert_allclose(grad, y.grad.numpy()[r], rtol=1e-15)


def rel_norm(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_two_rank_step_matches_one_process_f64(two_ranks):
    """One training step over two ranks against the one-process step on the
    global batch, float64: every loss term within rel 1e-10, every
    BatchNorm statistic within 1e-10 of its largest entry, every gradient
    within rel 1e-9 and every parameter after Adam within rel 1e-7 (per
    tensor, in norm); the same buffers and parameters on both ranks. The
    biases whose shift a train-mode BatchNorm removes have a zero gradient
    up to rounding, which Adam's normalisation blows up: both are left out.

    The one-process step differs from itself by 1.6e-10 in gradients and
    7.3e-9 in parameters after Adam between 1 and 8 CPU threads (sums in
    another order, amplified through the BatchNorm variances), so the
    gradient and parameter bounds sit a few times above that floor."""
    results, ref = two_ranks
    ref = ref["step"]
    skip = batchnorm_cancelled_biases(TEHNet(ModelConfig(n_points=N), device="cpu"))
    for res in results:
        got = res["step"]
        assert set(got["losses"]) == set(ref["losses"])
        for k, v in ref["losses"].items():
            assert got["losses"][k] == pytest.approx(v, rel=1e-10, abs=1e-300), k
        for k, v in ref["buffers"].items():
            err = np.abs(got["buffers"][k] - v).max() / max(np.abs(v).max(), 1e-300)
            assert err <= 1e-10, (k, err)
        for kind, limit in (("grads", 1e-9), ("params", 1e-7)):
            bad = [(k, rel_norm(got[kind][k], v)) for k, v in ref[kind].items()
                   if k not in skip and not rel_norm(got[kind][k], v) <= limit]
            assert not bad, (kind, bad[:5])
    a, b = results[0]["step"], results[1]["step"]
    for kind in ("buffers", "params"):
        for k in a[kind]:
            np.testing.assert_array_equal(a[kind][k], b[kind][k], err_msg=k)


def test_sharded_evaluations_match_unsharded(two_ranks):
    """train.evaluate and finetune.evaluate_finetune over the two ranks
    (each its half of every batch, the draws of seeded_generator(0, i)
    sliced, the predictions gathered) against one process: the score and
    every AUC within rtol 1e-5 (``tests/test_dist.py:89``)."""
    results, ref = two_ranks
    for name, (metrics, score) in ref["evaluations"].items():
        assert np.isfinite(score), name
        for res in results:
            got_metrics, got_score = res["evaluations"][name]
            np.testing.assert_allclose(got_score, score, rtol=1e-5, err_msg=name)
            for k in metrics["auc"]:
                np.testing.assert_allclose(got_metrics["auc"][k], metrics["auc"][k],
                                           rtol=1e-5, err_msg=f"{name} {k}")


def test_train_loop_data_parallel(two_ranks):
    """train.train with data_parallel=2 over the two ranks: one step and one
    evaluation each; only rank 0 has a run directory (its log, config and a
    checkpoint); both end with the same weights."""
    results, _ = two_ranks
    (dir0, step0, files0, w0), (dir1, step1, files1, w1) = (r["loop"] for r in results)
    assert step0 == step1 == 1
    assert dir1 is None and files1 is None
    assert {"ckpt", "config.json", "log.txt"} <= set(files0)
    np.testing.assert_array_equal(w0, w1)


def test_cli_data_parallel_flags():
    """The CLIs' data-parallel flags reach TrainConfig.data_parallel, and
    one process joins no group."""
    import argparse

    ap = argparse.ArgumentParser()
    ttr.add_parallel_args(ap)
    args = ap.parse_args(["--data_parallel", "2", "--coordinator", "localhost:1",
                          "--num_processes", "2", "--process_id", "1"])
    assert (args.data_parallel, args.coordinator, args.num_processes,
            args.process_id) == (2, "localhost:1", 2, 1)
    assert DEFAULT_CONFIG.train.data_parallel == 1
    assert pm.initialize_distributed(num_processes=1) is False


def test_export_data_parallel_exports_one_shard(monkeypatch):
    """export_serving(data_parallel=N) traces the one-device program at
    batch B / N, and refuses a batch that does not split."""
    from ev2hands_tpu_torch import export as kex

    cfg = step_config()
    net = TEHNet(cfg.model, device="cpu")
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    shapes = []
    monkeypatch.setattr(torch.export, "export",
                        lambda mod, args, **kw: shapes.append([a.shape for a in args]))
    kex.export_serving(net, hands, cfg, 4, 64, data_parallel=2)
    assert shapes == [[(2, 64, 4), (2, 64), (2, N)]]
    with pytest.raises(ValueError, match="does not split"):
        kex.export_serving(net, hands, cfg, 4, 64, data_parallel=3)


def test_split_serving_joins_shards():
    """split_serving runs shard i of the batch on program i and joins the
    outputs in shard order: each shard's rows are its program's output on
    those rows."""
    from ev2hands_tpu_torch.export import split_serving

    def program(tag):
        return lambda e, v, u: {"x": e.sum(-1) * v + tag, "u": u * tag}

    events = torch.arange(4 * 3 * 2, dtype=torch.float32).reshape(4, 3, 2)
    valid = torch.tensor([[1, 1, 0]] * 4, dtype=torch.float32)
    uniforms = torch.rand(4, 5, dtype=torch.float64)
    serve = split_serving([program(1.0), program(2.0)], ["cpu", "cpu"])
    out = serve(events, valid, uniforms)
    for i, tag in enumerate((1.0, 2.0)):
        want = program(tag)(events[2 * i:2 * i + 2], valid[2 * i:2 * i + 2],
                            uniforms[2 * i:2 * i + 2])
        for k in want:
            assert torch.equal(out[k][2 * i:2 * i + 2], want[k]), k
    with pytest.raises(ValueError, match="does not split"):
        serve(events[:3], valid[:3], uniforms[:3])
