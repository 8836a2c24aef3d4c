"""The port's training loop on the CPU: the native loader against the JAX
package's, the checkpointer's round trip, the evaluation against JAX's
``evaluate`` on the same joints, a resumed trajectory against the
uninterrupted one, and ``python -m ev2hands_tpu_torch.train`` end to end
(B=2, N=256). No JAX step is compiled."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ev2hands_tpu import train as jtrain
from ev2hands_tpu.config import DEFAULT_CONFIG as JCFG
from ev2hands_tpu.events import native_loader as jnl
from ev2hands_tpu.events import streams as js
from ev2hands_tpu_torch import train as ttr
from ev2hands_tpu_torch.checkpoint import Checkpointer, load_model_state
from ev2hands_tpu_torch.config import DEFAULT_CONFIG, ModelConfig
from ev2hands_tpu_torch.events import native_loader as tnl
from ev2hands_tpu_torch.events import streams as ts
from ev2hands_tpu_torch.model.layers import BatchNorm
from ev2hands_tpu_torch.model.tehnet import TEHNet

B, N = 2, 256


def assert_tree_equal(got, ref, path=""):
    if isinstance(ref, dict):
        assert set(got) == set(ref), path
        for k in ref:
            assert_tree_equal(got[k], ref[k], f"{path}.{k}")
    elif isinstance(ref, torch.Tensor):
        assert torch.equal(got, ref), path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=path)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """A small Ev2Hands-S split written by the JAX package, and its rows."""
    root = str(tmp_path_factory.mktemp("loop") / "train")
    js.write_synthetic_ev2hands_s(root, n_events=8192, n_frames=4, seed=3)
    return root, ts.synthetic_ev2hands_s(n_events=8192, n_frames=4, seed=3)


def test_native_loader_matches_jax(split):
    """fill_random at steps 0-2 and fill(starts) bitwise equal to the JAX
    package's loader on the same file; the loader over rows in memory equal
    to the file's; the loop's source through the Prefetcher equal to
    fill_random."""
    root, (rows, annotations) = split
    ref = jnl.NativeEv2HandSLoader(root, N, n_threads=2, seed=5)
    got = tnl.NativeEv2HandSLoader(root, N, n_threads=2, seed=5)
    mem = tnl.NativeEv2HandSLoader.from_rows(rows, annotations, N, n_threads=2, seed=5)
    assert len(got) == len(mem) == len(ref) == 8192
    for step in range(3):
        want = ref.fill_batch(3, step=step)
        assert_tree_equal(got.fill_batch(3, step=step), want, f"step {step}")
        assert_tree_equal(mem.fill_batch(3, step=step), want, f"rows, step {step}")
    starts = np.array([0, 100, 5000, 8192 - N, 10**9], np.int64)
    assert_tree_equal(got.fill_batch(5, starts=starts), ref.fill_batch(5, starts=starts))
    assert_tree_equal(mem.fill_batch(5, starts=starts), ref.fill_batch(5, starts=starts))

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    source, name = ttr.open_train_source(cfg, (rows, annotations))
    assert name == "native"
    loader = tnl.NativeEv2HandSLoader.from_rows(rows, annotations, N,
                                                seed=cfg.train.seed)
    for step, batch in zip(range(3), ts.Prefetcher(source)):
        assert_tree_equal(batch, loader.fill_batch(cfg.train.batch_size, step=step))


def _net_and_adam(seed):
    """A small module with the port's BatchNorm, and its Adam."""
    torch.manual_seed(seed)
    net = torch.nn.Sequential(torch.nn.Linear(5, 16), BatchNorm(16, "cpu"),
                              torch.nn.Linear(16, 3))
    net[1].running_mean.normal_()
    return net, ttr.make_optimizer(net.parameters(), DEFAULT_CONFIG.train)


def test_checkpointer_round_trip(tmp_path):
    """An asynchronous save, then latest_step and restore: the parameters
    and BatchNorm statistics, Adam's moments and step counts, the step and
    the best score come back bitwise, as they were when save returned
    (later in-place updates do not leak in). The whole TEHNet's round trip
    is in test_train_loop_resume."""
    net, opt = _net_and_adam(0)
    g = torch.Generator().manual_seed(1)
    for _ in range(2):
        for p in net.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
    want_model = {k: v.clone() for k, v in net.state_dict().items()}
    want_opt = {i: {k: v.clone() for k, v in s.items()}
                for i, s in opt.state_dict()["state"].items()}
    ckptr = Checkpointer(str(tmp_path / "ckpt"))
    ckptr.save(7, net, opt, 0.42)
    with torch.no_grad():
        for v in net.state_dict().values():
            v.add_(1)
    opt.step()
    assert ckptr.latest_step() == 7
    assert os.listdir(ckptr.directory) == ["step_000000007.pt"]

    net2, opt2 = _net_and_adam(9)
    blob = Checkpointer(ckptr.directory).restore_into(net2, opt2)
    assert blob["step"] == 7 and blob["max_eval_score"] == 0.42
    assert_tree_equal(net2.state_dict(), want_model)
    assert_tree_equal(opt2.state_dict()["state"], want_opt)
    assert_tree_equal(load_model_state(ckptr.directory), want_model)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore_into(net2)


def test_evaluate_matches_jax(split):
    """The port's evaluate() and JAX's evaluate(), each fed the same joints
    for each batch by a stand-in eval step: the same batches in, the same
    frame count, PCK curves, AUCs and score out."""
    root, _ = split
    bs, max_frames = 2, 5
    rng = np.random.RandomState(4)
    gt = [rng.randn(bs, 2, 21, 3).astype(np.float32) * 100 for _ in range(3)]
    pred = [g + rng.randn(*g.shape).astype(np.float32) * 25 for g in gt]
    seen = {"jax": [], "port": []}

    def jax_step(state, batch, key):
        seen["jax"].append(batch)
        i = len(seen["jax"]) - 1
        return jnp.asarray(pred[i]), jnp.asarray(gt[i])

    def port_step(batch, generator):
        assert isinstance(generator, torch.Generator)
        seen["port"].append(batch)
        i = len(seen["port"]) - 1
        return torch.from_numpy(pred[i]), torch.from_numpy(gt[i])

    jcfg = JCFG.replace(train=JCFG.train.__class__(
        **{**JCFG.train.__dict__, "eval_batch_size": bs}))
    cfg = DEFAULT_CONFIG.replace(train=DEFAULT_CONFIG.train.__class__(
        **{**DEFAULT_CONFIG.train.__dict__, "eval_batch_size": bs}))
    ref, ref_score = jtrain.evaluate(jax_step, None, js.Ev2HandSReader(root, N), jcfg,
                                     max_frames=max_frames)
    got, score = ttr.evaluate(port_step, ts.Ev2HandSReader(root, N), cfg,
                              max_frames=max_frames, device="cpu")
    assert len(seen["port"]) == len(seen["jax"]) == max_frames // bs
    for a, b in zip(seen["port"], seen["jax"]):
        assert_tree_equal(a, b)
    assert score == ref_score and got["auc"] == ref["auc"]
    assert 0 < got["auc"]["relative"] < 1
    for k, curve in ref["pck3d"].items():
        np.testing.assert_allclose(got["pck3d"][k], curve, rtol=0, atol=1e-6)


def _cli(root, *extra, device="cpu"):
    return ["--data_root", root, "--synthetic_mano", "--device", device,
            "--n_points", str(N), "--batch_size", str(B), "--eval_batch_size", "1",
            "--max_eval_iters", "1", "--save_iter", "2", "--msg_iter", "1",
            *extra]


def test_train_loop_resume(tmp_path, monkeypatch):
    """``python -m ev2hands_tpu_torch.train --device cpu`` end to end: 3
    steps on the native loader, an evaluation at step 2 and the best
    checkpoint saved there. From that checkpoint, step 2 with the loop's
    batch and draws gives the uninterrupted run's parameters, BatchNorm
    statistics and Adam state bitwise. A run resumed from the checkpoint
    takes exactly one more step. Without --device it asks for the card and
    raises on a host without one; without synthetic MANO it reads the
    pickles under ``cfg.mano.model_path`` and raises where there are none."""
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "data")
    for split_name in ("train", "val"):
        ts.write_synthetic_ev2hands_s(f"{root}/{split_name}", n_events=4096,
                                      n_frames=4, seed=len(split_name))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttr.main(_cli(root, device="cuda"))
    run = ttr.main(_cli(root, "--max_iter", "3"))
    assert run.step == 3 and run.source == "native"
    assert run.stats.steps == 3 and run.stats.evals == 1 and run.stats.saves == 1
    assert run.run_dir.startswith("runs/train_")
    log = open(f"{run.run_dir}/log.txt").read()
    assert "native C++ batch loader" in log and "saved best checkpoint at 2" in log
    assert all(os.path.isfile(f"{run.run_dir}/{f}")
               for f in ("config.json", "model.txt", "scalars.jsonl"))
    ckpt = f"{run.run_dir}/ckpt"
    assert "step_000000002.pt" in os.listdir(ckpt)

    cfg = DEFAULT_CONFIG.replace(model=ModelConfig(n_points=N))
    net = TEHNet(cfg.model, device="cpu")
    opt = ttr.make_optimizer(net.parameters(), cfg.train)
    Checkpointer(ckpt).restore_into(net, opt, step=2)
    hands = ttr.build_hands(cfg, synthetic=True, device="cpu")
    step = ttr.make_train_step(net, hands, ttr.build_collision_context(hands), cfg,
                               opt, device="cpu")
    loader = tnl.NativeEv2HandSLoader(f"{root}/train", N, seed=cfg.train.seed)
    for it in (2,):
        step(loader.fill_batch(B, step=it),
             ttr.seeded_generator(cfg.train.seed + 1, it, "cpu"))
    assert_tree_equal(net.state_dict(), run.net.state_dict())
    assert_tree_equal(opt.state_dict()["state"], run.optimizer.state_dict()["state"])

    again = ttr.main(_cli(root, "--max_iter", "3", "--resume_dir", ckpt))
    assert again.step == 3 and again.stats.steps == 1
    assert f"resumed from {ckpt} at step 2" in open(f"{again.run_dir}/log.txt").read()
    assert sorted(glob.glob("runs/train_*")) == sorted([run.run_dir, again.run_dir])
    with pytest.raises(FileNotFoundError, match="MANO_RIGHT.pkl"):   # no pickles here
        ttr.train(cfg, synthetic_mano=False, device="cpu")
