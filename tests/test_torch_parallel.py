"""The port's data parallelism on the CPU, two gloo ranks a case, each a
subprocess of one thread (`run_ranks`): the collectives (a ragged gather of
pickles, an fp64 sum, a barrier, a gather that carries the gradient), the
cross-rank BatchNorm against plain BatchNorm of the concatenated batch, a
world-1 process group bit-identical to none, a rank whose peer died failing
instead of hanging, and the train CLI at two ranks with a mid-epoch resume
in which only rank 0 writes. The JAX parity of a two-rank step is in
`tests/test_torch_ddp.py`.

This module imports no JAX: the ranks import it to run its `_rank_*`
functions."""

import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch import nn

from video_rep_learning_tpu_torch.config import apply_opts, get_cfg
from video_rep_learning_tpu_torch.models import layers
from video_rep_learning_tpu_torch.ops.augment import (AugmentParams, SupervisedParams,
                                                      sample_ssl_batch,
                                                      sample_supervised_batch)
from video_rep_learning_tpu_torch.tools.ddp_cards import free_port
from video_rep_learning_tpu_torch.train.trainer import step_seed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 60  # a collective waiting on a dead peer fails after this

BLOCKED = ("jax", "flax", "sklearn", "video_rep_learning_tpu")
BLOCK_JAX = f"for name in {BLOCKED!r}:\n    sys.modules[name] = None\n"
CHILD = """
import importlib, os, pickle, sys
{block}
import torch
torch.set_num_threads(1)
mod, fn, rank, world, port, args_path, out_path = sys.argv[1:]
rank, world = int(rank), int(world)
if port != "none":
    from video_rep_learning_tpu_torch.parallel import init_distributed
    init_distributed(f"127.0.0.1:{{port}}", world, rank, "cpu", timeout={timeout})
with open(args_path, "rb") as f:
    kwargs = pickle.load(f)
out = getattr(importlib.import_module(mod), fn)(rank, world, **kwargs)
with open(out_path, "wb") as f:
    pickle.dump(out, f)
if torch.distributed.is_initialized():
    torch.distributed.destroy_process_group()
"""


def run_ranks(fn, tmp_path, world=2, module="tests.test_torch_parallel", init=True,
              block_jax=False, timeout=300, expect_ok=True, threads="1", **kwargs):
    """Run `module.fn(rank, world, **kwargs)` in `world` subprocesses, ranks
    of a gloo group on the CPU (none with `init=False`: the function joins
    one itself), and return [(returncode, output, result or None)] in rank
    order. Every rank is killed if the run outlasts `timeout` seconds.
    With `expect_ok` every rank must exit 0. `threads` is the ranks'
    OMP_NUM_THREADS, None to leave it unset."""
    tmp_path.mkdir(parents=True, exist_ok=True)
    args_path = tmp_path / f"{fn}_args.pkl"
    with open(args_path, "wb") as f:
        pickle.dump(kwargs, f)
    port = str(free_port()) if init else "none"
    code = CHILD.format(block=BLOCK_JAX if block_jax else "", timeout=RANK_TIMEOUT_S)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS=threads or "")
    if threads is None:
        del env["OMP_NUM_THREADS"]
    outs = [tmp_path / f"{fn}_out{r}.pkl" for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, module, fn, str(r), str(world), port,
         str(args_path), str(outs[r])], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.time() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
    finally:
        for p in procs:  # a hung rank must not outlive the test
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = []
    for p, log, out in zip(procs, logs, outs):
        res = None
        if out.exists():
            with open(out, "rb") as f:
                res = pickle.load(f)
        results.append((p.returncode, log, res))
    if expect_ok:
        for r, (code_, log, _) in enumerate(results):
            assert code_ == 0, f"rank {r} exited {code_}:\n{log[-4000:]}"
    return results


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _rank_collectives(rank, world):
    from video_rep_learning_tpu_torch.parallel import (all_gather_object,
                                                       all_gather_with_grad,
                                                       all_reduce_sum, synchronize)

    objs = all_gather_object({"rank": rank, "pad": "x" * (1000 * rank + 3)})
    total = all_reduce_sum(0.1 * (rank + 1))
    synchronize()
    x = (torch.arange(3, dtype=torch.float32) + 10 * rank).requires_grad_()
    gathered = all_gather_with_grad(x[None])
    # each rank's loss weighs every rank's rows, by weights of its own
    w = torch.arange(world * 3, dtype=torch.float32).view(world, 3) + rank
    (gathered * w).sum().backward()
    return {"objs": objs, "total": total, "gathered": gathered.detach().numpy(),
            "grad": x.grad.numpy()}


@pytest.mark.timeout(300)
def test_collectives(tmp_path):
    res = [r for _, _, r in run_ranks("_rank_collectives", tmp_path)]
    for r in res:
        assert r["objs"] == [{"rank": 0, "pad": "xxx"}, {"rank": 1, "pad": "x" * 1003}]
        assert r["total"] == 0.1 + 0.2  # summed in fp64
        np.testing.assert_array_equal(r["gathered"], [[0, 1, 2], [10, 11, 12]])
    # rank r's rows get the gradient of every rank's loss: sum over ranks
    # of (arange(6).view(2, 3) + rank)[r]
    base = np.arange(6, dtype=np.float32).reshape(2, 3)
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["grad"], 2 * base[rank] + 1)


def _rank_threads(rank, world, port):
    """This rank's intra-op threads once it has joined the group (this
    module, imported first, sets one)."""
    from video_rep_learning_tpu_torch.parallel import init_distributed

    init_distributed(f"127.0.0.1:{port}", world, rank, "cpu", timeout=RANK_TIMEOUT_S)
    threads = torch.get_num_threads()
    torch.distributed.destroy_process_group()
    return threads


@pytest.mark.timeout(300)
def test_a_rank_takes_its_share_of_the_cpus(tmp_path):
    """Without OMP_NUM_THREADS each of W ranks runs its share of the CPUs as
    intra-op threads (W ranks a thread a CPU contend); with it, as set."""
    share = max(1, len(os.sched_getaffinity(0)) // 2)
    for threads, want in ((None, share), ("1", 1)):
        res = run_ranks("_rank_threads", tmp_path / str(threads), init=False,
                        threads=threads, port=free_port())
        assert [r for _, _, r in res] == [want, want]


def test_collectives_are_the_identity_in_one_process():
    from video_rep_learning_tpu_torch.parallel import (all_gather_object,
                                                       all_gather_with_grad,
                                                       all_reduce_sum, is_root_proc,
                                                       synchronize, world)

    assert world() == (1, 0) and is_root_proc()
    assert all_gather_object({"a": 1}) == [{"a": 1}]
    assert all_reduce_sum(2.5) == 2.5
    synchronize()
    x = torch.ones(2, 3)
    assert all_gather_with_grad(x) is x


# ---------------------------------------------------------------------------
# BatchNorm across ranks
# ---------------------------------------------------------------------------

BN_SHAPES = {1: (8, 5), 2: (6, 5, 3, 4), 3: (4, 5, 2, 3, 3)}
BN_SPLITS = {1: (3, 5), 2: (3, 3), 3: (2, 2)}  # rows a rank
BN_PLAIN = {1: layers.BatchNorm1d, 2: layers.BatchNorm2d, 3: layers.BatchNorm3d}


def _bn_inputs(dim):
    rng = np.random.RandomState(dim)
    shape = BN_SHAPES[dim]
    C = shape[1]
    per_channel = (1, C) + (1,) * (len(shape) - 2)
    x = rng.randn(*shape) * rng.uniform(0.5, 2.0, per_channel) + rng.randn(*per_channel)
    return {"x": x.astype(np.float32), "gy": rng.randn(*shape).astype(np.float32),
            "weight": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": rng.randn(C).astype(np.float32),
            "mean": rng.randn(C).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}


def _bn_module(dim, inputs):
    bn = BN_PLAIN[dim](inputs["x"].shape[1], eps=layers.BN_EPS)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inputs["weight"]))
        bn.bias.copy_(torch.from_numpy(inputs["bias"]))
        bn.running_mean.copy_(torch.from_numpy(inputs["mean"]))
        bn.running_var.copy_(torch.from_numpy(inputs["var"]))
    return bn.train()


def _bn_step(bn, x, gy):
    x = torch.from_numpy(x).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(gy)).sum().backward()
    return {"y": y.detach().numpy(), "gx": x.grad.numpy(),
            "gw": bn.weight.grad.numpy(), "gb": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy(),
            "tracked": int(bn.num_batches_tracked)}


def _rank_sync_bn(rank, world, dim):
    inputs = _bn_inputs(dim)
    net = layers.convert_sync_batchnorm(nn.Sequential(_bn_module(dim, inputs)))
    assert type(net[0]).__name__ == f"SyncBatchNorm{dim}d"
    lo = sum(BN_SPLITS[dim][:rank])
    rows = slice(lo, lo + BN_SPLITS[dim][rank])
    return _bn_step(net[0], inputs["x"][rows], inputs["gy"][rows])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_sync_batchnorm_equals_plain_batchnorm_of_the_whole_batch(tmp_path, dim):
    """Each rank normalises its rows (rank 0 three of the 1-d batch's eight,
    rank 1 five) by the statistics of all of them: the outputs, the input
    gradients and the running statistics are plain BatchNorm's over the
    concatenated batch, and the weight and bias gradients summed over the
    ranks (what DDP's average takes W times) are its own."""
    res = [r for _, _, r in run_ranks("_rank_sync_bn", tmp_path, dim=dim)]
    inputs = _bn_inputs(dim)
    want = _bn_step(_bn_module(dim, inputs), inputs["x"], inputs["gy"])
    tol = dict(rtol=1e-5, atol=1e-5)  # fp32, E[x^2] - E[x]^2 against two passes
    for key in ("y", "gx"):
        np.testing.assert_allclose(np.concatenate([r[key] for r in res]), want[key],
                                   err_msg=key, **tol)
    for key in ("gw", "gb"):
        np.testing.assert_allclose(res[0][key] + res[1][key], want[key], err_msg=key,
                                   **tol)
    for r in res:
        for key in ("mean", "var"):
            np.testing.assert_allclose(r[key], want[key], err_msg=key, **tol)
        assert r["tracked"] == want["tracked"] == 1
    for key in ("mean", "var"):  # the ranks' running statistics are one
        np.testing.assert_array_equal(res[0][key], res[1][key])


def test_sync_batchnorm_takes_the_plain_path_in_one_process():
    """Without a process group, and in eval mode, the synced module is the
    plain one bit for bit; the frozen trunk's BN is not converted."""
    inputs = _bn_inputs(2)
    want = _bn_step(_bn_module(2, inputs), inputs["x"], inputs["gy"])
    net = nn.Sequential(_bn_module(2, inputs))
    net.add_module("backbone", nn.Sequential(layers.BatchNorm2d(5)))
    layers.convert_sync_batchnorm(net)
    assert isinstance(net[0], layers.SyncBatchNorm2d)
    assert type(net.backbone[0]) is layers.BatchNorm2d
    x = torch.from_numpy(inputs["x"])
    with torch.no_grad():
        assert torch.equal(net[0].eval()(x), _bn_module(2, inputs).eval()(x))
    got = _bn_step(net[0].train(), inputs["x"], inputs["gy"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------------------
# randomness across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("crop", [True, False])
def test_a_ranks_augmentation_is_its_rows_of_the_global_draw(crop):
    """Rank r of W draws the values of the global batch's first r x B clips
    and drops them: its sampled values are rows [rB, (r+1)B) of one draw
    for all W x B clips (the dims of the dropped clips do not matter)."""
    dims = np.array([[40, 36], [32, 40], [38, 38], [40, 40]], np.float32)
    ssl, sup = AugmentParams(image_size=16), SupervisedParams(image_size=16,
                                                              random_crop=crop)
    gen = lambda: torch.Generator().manual_seed(step_seed(0, 0, 3, 5))  # noqa: E731
    whole = sample_ssl_batch(gen(), 4, 2, 40, 40, dims, ssl)
    part = sample_ssl_batch(gen(), 2, 2, 40, 40, dims[2:], ssl, skip=2)
    for key, value in part.items():
        assert torch.equal(value, whole[key][4:]), key
    whole = sample_supervised_batch(gen(), 4, 40, 40, dims, sup)
    part = sample_supervised_batch(gen(), 1, 40, 40, dims[3:], sup, skip=3)
    for key, value in part.items():
        assert torch.equal(value, whole[key][3:]), key


def test_dropout_seed_folds_in_the_rank():
    seeds = {step_seed(7, 2, 1, 4, rank) for rank in range(4)}
    assert len(seeds) == 4
    assert step_seed(7, 2, 1, 4, 0) == step_seed(7, 2, 1, 4)


# ---------------------------------------------------------------------------
# one training step: world 1 equals no process group; ranks stay one
# ---------------------------------------------------------------------------

# scl_transformer_config.yml cut to the CPU: 32 px, 4 frames, a 1-layer head
SMALL_OPTS = ["IMAGE_SIZE", "32", "TRAIN.NUM_FRAMES", "4", "DATA.NUM_WORKERS", "0",
              "USE_AMP", "False", "MODEL.BASE_MODEL.FRAMES_PER_BATCH", "8",
              "MODEL.EMBEDDER_MODEL.NUM_LAYERS", "1",
              "MODEL.EMBEDDER_MODEL.HIDDEN_SIZE", "32", "MODEL.EMBEDDER_MODEL.D_FF", "64",
              "MODEL.EMBEDDER_MODEL.EMBEDDING_SIZE", "16",
              "MODEL.EMBEDDER_MODEL.FC_LAYERS", "[[32,True]]",
              "MODEL.EMBEDDER_MODEL.CAPACITY_SCALAR", "1", "MODEL.PROJECTION_SIZE", "16"]


def tiny_step_cfg():
    """A small CARL SCL step (`SMALL_OPTS`), one clip, SGD momentum."""
    cfg = get_cfg()
    apply_opts(cfg, SMALL_OPTS)
    cfg.TRAIN.BATCH_SIZE = 1
    cfg.OPTIMIZER.TYPE = "MomentumOptimizer"
    return cfg


def _uint8_batch(B, T=4, S=40, seed=0):
    rng = np.random.RandomState(seed)
    return {"videos": rng.randint(0, 255, (B, 2, T, S, S, 3)).astype(np.uint8),
            "seq_lens": np.full((B, 2), 30, np.int32),
            "chosen_steps": np.tile(np.arange(0, 2 * T, 2, dtype=np.int32), (B, 2, 1)),
            "video_masks": np.ones((B, 2, T), np.float32),
            "dims": np.full((B, 2), 40.0, np.float32)}


def _two_steps(rank=0, world=1):
    """Two SCL steps (augmentation drawn by the trainer, dropout on) of
    `tiny_step_cfg` on rank `rank`'s clip of a global batch of `world`;
    returns the state dict, the losses and the first step's views."""
    from video_rep_learning_tpu_torch.train import Trainer

    tr = Trainer(tiny_step_cfg(), no_eval=True, build_loaders=False, device="cpu")
    whole = _uint8_batch(world)
    batch = {k: v[rank:rank + 1] for k, v in whole.items()}
    losses, views = [], None
    for it in range(2):
        dev = tr.device_batch(batch)
        if it == 0:
            views = tr.augment(batch, dev, 0, 0, it).numpy()
        losses.append(float(tr.train_step(batch, dev, 0, it, 1e-2)))
    return {"state": {k: v.numpy() for k, v in tr.model.state_dict().items()},
            "losses": losses, "views": views}


def _rank_two_steps(rank, world):
    return _two_steps(rank, world)


def _rank_two_steps_blocked(rank, world):
    """`_two_steps`, and the blocked packages that got loaded (none may)."""
    out = _two_steps(rank, world)
    out["loaded"] = sorted(m for m, mod in sys.modules.items() if mod is not None
                           and m.split(".")[0] in BLOCKED)
    return out


@pytest.mark.timeout(300)
def test_world_one_group_is_bit_identical_to_none(tmp_path):
    """A gloo group of one rank wraps the model in DDP and converts its BN;
    two steps then give the weights, BN statistics and losses of a run
    without a process group, bit for bit."""
    (_, _, got), = run_ranks("_rank_two_steps", tmp_path, world=1)
    want = _two_steps()
    assert got["losses"] == want["losses"]
    for k, v in want["state"].items():
        np.testing.assert_array_equal(got["state"][k], v, err_msg=k)


@pytest.mark.timeout(300)
def test_two_ranks_stay_one_model(tmp_path):
    """Two ranks of one clip each: after two steps every parameter and BN
    statistic is bit-identical across the ranks, each rank's first views
    are its rows of a one-process draw for the global batch, and the
    ranks' losses differ (their clips do)."""
    res = [r for _, _, r in run_ranks("_rank_two_steps", tmp_path)]
    for k, v in res[0]["state"].items():
        np.testing.assert_array_equal(res[1]["state"][k], v, err_msg=k)
    assert res[0]["losses"] != res[1]["losses"]
    from video_rep_learning_tpu_torch.train import Trainer

    tr = Trainer(tiny_step_cfg(), no_eval=True, build_loaders=False, device="cpu")
    whole = _uint8_batch(2)
    views = tr.augment(whole, tr.device_batch(whole), 0, 0, 0).numpy()
    for rank, r in enumerate(res):
        np.testing.assert_array_equal(r["views"], views[rank:rank + 1])


def _rank_given_step(rank, world, cfg, state, batch, lr, env=None):
    """One train step of the port's trainer (`cfg` a plain dict over
    `get_cfg()`, weights `state` in the reference layout) on this rank's
    rows of the global `batch`, whose videos are the augmented views: the
    trainer's own augmentation is bypassed. Returns the rank's loss and
    state dict (the JAX parity of `tests/test_torch_ddp.py`)."""
    from video_rep_learning_tpu_torch.models.weights import (load_model_state,
                                                             state_dict_from_numpy)
    from video_rep_learning_tpu_torch.train import Trainer

    os.environ.update(env or {})
    c = get_cfg()
    c.merge_from(cfg)
    tr = Trainer(c, no_eval=True, build_loaders=False, device="cpu")
    load_model_state(tr.model, state_dict_from_numpy(state))
    n = batch["videos"].shape[0] // world
    local = {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}
    dev = tr.device_batch(local)
    tr.augment = lambda batch, dev_batch, *a: dev_batch["videos"]
    loss = float(tr.train_step(local, dev, 0, 0, lr))
    return {"loss": loss, "state": {k: v.numpy() for k, v in tr.model.state_dict().items()}}


def _rank_probe(rank, world, cfg, train, val, fraction, probe_init):
    """The FineGym probe on this rank's shard of the embedding files
    (`tests/test_torch_finegym.py`): its accuracy and trained weights."""
    from video_rep_learning_tpu_torch.evaluation import finegym

    c = get_cfg()
    c.merge_from(cfg)
    out = {}
    acc = finegym.train_linear_probe(c, train, val, fraction, 0, None, "cpu",
                                     init=probe_init, probe_out=out)
    return {"acc": acc, "weight": out["probe"].weight.detach().numpy(),
            "bias": out["probe"].bias.detach().numpy()}


def _rank_harness(rank, world, cfg, state, vit_name, vit_args):
    """The FineGym harness on this rank's shard of a gym99-format set, the
    model a test ViT's (`tests/test_torch_finegym.py`): the accuracies and
    the file lists the rank saw."""
    from video_rep_learning_tpu_torch.data import construct_dataloader
    from video_rep_learning_tpu_torch.evaluation import finegym
    from video_rep_learning_tpu_torch.models import build_model, vit
    from video_rep_learning_tpu_torch.models.weights import (load_model_state,
                                                             state_dict_from_numpy)

    vit.VIT_SPECS[vit_name] = vit.ViTSpec(*vit_args[0], **vit_args[1])
    c = get_cfg()
    c.merge_from(cfg)
    model = build_model(c, "cpu")
    load_model_state(model, state_dict_from_numpy(state))
    loaders = {s: construct_dataloader(c, s)[1][0] for s in ("train", "val")}
    lists = []
    real = finegym.train_linear_probe

    def probe(cfg_, train, val, *args, **kwargs):
        lists.append((list(train), list(val)))
        return real(cfg_, train, val, *args, **kwargs)

    finegym.train_linear_probe = probe
    accs = finegym.evaluate_loaders(c, model, loaders["train"], loaders["val"], 0, None,
                                    "cpu")
    return {"accs": accs, "lists": lists,
            "shard": {s: len(loader) for s, loader in loaders.items()}}


# ---------------------------------------------------------------------------
# failure: a rank whose peer died raises
# ---------------------------------------------------------------------------

def _rank_peer_dies(rank, world):
    from video_rep_learning_tpu_torch.parallel import all_reduce_sum

    if rank == 1:
        os._exit(3)
    time.sleep(1.0)
    all_reduce_sum(1.0)
    return "reduced without its peer"


@pytest.mark.timeout(300)
def test_a_rank_whose_peer_died_fails(tmp_path):
    t0 = time.time()
    res = run_ranks("_rank_peer_dies", tmp_path, expect_ok=False,
                    timeout=RANK_TIMEOUT_S + 120)
    assert res[1][0] == 3
    assert res[0][0] not in (0, None) and res[0][2] is None, res[0][1][-2000:]
    assert time.time() - t0 < RANK_TIMEOUT_S + 60  # failed, did not wait on


# ---------------------------------------------------------------------------
# the train CLI at two ranks, with a mid-epoch resume
# ---------------------------------------------------------------------------

class _Preempted(Exception):
    pass


def _cli_argv(data, logdir, port, rank, world):
    return ["--workdir", data, "--logdir", logdir, "--device", "cpu",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world),
            "--process_id", str(rank), "--opts", *SMALL_OPTS, "TRAIN.MAX_EPOCHS", "1",
            "CHECKPOINT.SAVE_EVERY_N_ITERS", "1", "EVAL.TASKS", "[kendalls_tau]"]


def _rank_cli(rank, world, data, logdirs, ports):
    """The train CLI on this rank: uninterrupted, then preempted after the
    first mid-epoch save and resumed. Returns each run's state and who
    wrote which checkpoint."""
    from video_rep_learning_tpu_torch.train import checkpoint, cli
    from video_rep_learning_tpu_torch.train import trainer as trainer_mod

    writes, starts = [], []
    real_write, real_mid = checkpoint._write, trainer_mod.save_mid_checkpoint
    real_resume = trainer_mod.resume

    def write(path, *args, **kwargs):
        writes.append(os.path.basename(path))
        return real_write(path, *args, **kwargs)

    def stop_after_first(logdir, model, optimizer, epoch, next_iter, cfg=None):
        out = real_mid(logdir, model, optimizer, epoch, next_iter, cfg)
        if logdir == logdirs[1] and next_iter == 1:
            raise _Preempted
        return out

    def resume(*args, **kwargs):
        starts.append(real_resume(*args, **kwargs))
        return starts[-1]

    checkpoint._write = write
    trainer_mod.save_mid_checkpoint = stop_after_first
    trainer_mod.resume = resume
    once = cli.main(_cli_argv(data, logdirs[0], ports[0], rank, world))
    try:
        cli.main(_cli_argv(data, logdirs[1], ports[1], rank, world))
        raise AssertionError("the preempted run ran on")
    except _Preempted:
        torch.distributed.destroy_process_group()
    resumed = cli.main(_cli_argv(data, logdirs[1], ports[2], rank, world))
    state = lambda tr: {k: v.numpy() for k, v in tr.model.state_dict().items()}  # noqa: E731
    return {"once": state(once), "resumed": state(resumed), "writes": writes,
            "starts": starts,
            "steps": len(once.train_loader), "count": resumed.optimizer.count}


@pytest.mark.timeout(600)
def test_train_cli_at_two_ranks_resumes_mid_epoch(tmp_path):
    """`python -m video_rep_learning_tpu_torch.train`'s function at two gloo
    ranks over a 4-video set (2 steps a rank), a mid-epoch checkpoint every
    step, then the evaluation on rank 0: only rank 0 writes checkpoints; a
    run stopped after its first mid save and started again in its logdir
    resumes at (epoch 0, iteration 1) and ends bit-identical to the
    uninterrupted one, on both ranks, and the ranks are one model."""
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring

    make_pouring(str(tmp_path / "data" / "pouring"), num_train=4, num_val=2,
                 min_len=14, max_len=20, size=40, seed=0)
    logdirs = [str(tmp_path / "once"), str(tmp_path / "cut")]
    res = [r for _, _, r in run_ranks(
        "_rank_cli", tmp_path / "ranks", init=False, timeout=540,
        data=str(tmp_path / "data"), logdirs=logdirs,
        ports=[free_port() for _ in range(3)])]
    assert res[1]["writes"] == []
    assert res[0]["writes"] == [
        "checkpoint_iter_00000_0000001.pth", "checkpoint_iter_00000_0000002.pth",
        "checkpoint_epoch_00000.pth",  # uninterrupted
        "checkpoint_iter_00000_0000001.pth",  # preempted after it
        "checkpoint_iter_00000_0000002.pth", "checkpoint_epoch_00000.pth"]
    for logdir in logdirs:
        assert os.listdir(os.path.join(logdir, "checkpoints")) == [
            "checkpoint_epoch_00000.pth"]
    for r in res:
        assert r["steps"] == 2 and r["starts"] == [None, None, (0, 1)]
        assert r["count"] == 2
        for k, v in r["once"].items():
            np.testing.assert_array_equal(r["resumed"][k], v, err_msg=k)
    for k, v in res[0]["once"].items():
        np.testing.assert_array_equal(res[1]["once"][k], v, err_msg=k)



@pytest.mark.timeout(300)
def test_ddp_cards_tool_on_cpu(tmp_path, capsys, monkeypatch):
    """`python -m video_rep_learning_tpu_torch.tools.ddp_cards --device cpu`:
    a world of 1 and one of 2 gloo ranks, each rank's warm steps with the
    ranks bit-identical after each, one JSON line a world."""
    from video_rep_learning_tpu_torch.data.synthetic import make_pouring
    from video_rep_learning_tpu_torch.tools import ddp_cards

    make_pouring(str(tmp_path / "pouring"), num_train=4, num_val=2, min_len=14,
                 max_len=20, size=40, seed=0)
    monkeypatch.chdir(REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ddp_cards.main(["--workdir", str(tmp_path), "--cfg_file",
                    "configs/scl_transformer_config.yml", "--worlds", "1", "2",
                    "--steps", "1", "--device", "cpu", "--timeout", "240", "--opts",
                    *SMALL_OPTS])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert [d["world"] for d in lines] == [1, 2]
    for d in lines:
        assert len(d["ms_by_rank"]) == d["world"] and d["clips_per_s"] > 0
        assert all(np.isfinite(d["losses_rank0"])) and d["device"] == {"platform": "cpu"}
