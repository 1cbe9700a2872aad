"""Data parallelism across processes: the port against the JAX package.

The port runs one process a rank (gloo on the CPU, ``torch_dist_workers``:
each rank process imports the port only and is joined with a timeout);
this process holds the JAX package's single-controller runs on the same
inputs. The mapping (``paddle_tpu_torch/distributed/__init__.py``): row r
of the reference's local-shard view is rank r's tensor; the global batch
is the ranks' local batches in rank order; the reference's parameters
after a step are every rank's.

  * every collective, at 2 and 4 ranks, against the reference's local-shard
    view row by row (``reduce``: the ``dst`` row, the reference fills
    every row; ``ReduceOp.PROD`` on positive inputs within 1e-5 relative:
    the reference's exp-of-log-sum drops the sign), point-to-point against
    the reference's send/recv pairing;
  * ``GradReducer.partition`` equal to the reference's for three bucket
    sizes;
  * ``DataParallel`` at 2 and 4 ranks: 3 ``AdamW`` steps of
    ``LlamaConfig.tiny()`` on the global B=4 x S=16 batch whose labels are
    -100 where the rows hold 11, 11, 15 and 14 valid targets (rows 0-1
    hold 22, rows 2-3 hold 29), small buckets (several flushes a step):
    losses within 1e-5 relative and parameters within 1e-5 absolute of the
    JAX package's ``DataParallel`` on a mesh of the same size. The labels
    are -100 at the end of each row (padding). With them at the start (a
    prompt) one element of ``model.layers.1.mlp.gate_proj``
    ([62, 4]) gets a step-1 gradient near Adam's epsilon, where the update
    lr * g / (|g| + eps) turns a last-bit difference of g into ~1e-4: the
    JAX package's own ``DataParallel`` run moves it 1.6e-4 from its
    unsharded run (2 ranks; the port 5.2e-5 from the JAX ``DataParallel``
    run), so no two summation orders agree there to 1e-5. That layout is
    held on its losses (1e-5 relative) at 2 ranks;
  * ``tie_word_embeddings=True`` under ``DataParallel`` at 2 ranks (the
    shared weight's bucket flushes once, after both uses): losses as
    above, parameters under the per-step bar (the test says why);
  * ``accumulate_steps=2`` under ``DataParallel``: one flush a bucket a
    step, the losses within 1e-5 of the JAX package's;
  * ``no_sync``: no flush inside (from backward or ``finish``), each rank's
    local gradient kept, ``TrainStep`` refused there; the next backward
    flushes every bucket and averages;
  * a parameter frozen after the step is built leaves its bucket (every
    bucket still flushes during backward; it is not updated); a loss
    function that cannot take ``count_group`` is refused;
  * ``fleet.init`` / ``distributed_model`` / ``distributed_optimizer`` with
    ``dp_degree`` and with ``sharding_degree`` (stage 2) against the JAX
    package's ``DataParallel`` run (its fleet wraps both modes in
    ``DataParallel``);
  * the launcher: two ranks succeed; a failing rank makes it exit nonzero
    within its timeout and leaves no rank process behind.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import collective as JC
from paddle_tpu.distributed.data_parallel import DataParallel as JaxDP
from paddle_tpu.distributed.data_parallel import GradReducer as JaxReducer
from paddle_tpu.distributed.mesh import init_mesh, set_mesh
from paddle_tpu.jit import TrainStep as JaxTrainStep
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama

import torch_dist_workers as W
from paddle_tpu_torch.distributed.data_parallel import GradReducer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: valid targets of each row of the global batch (15 a row at most)
VALID = (11, 11, 15, 14)
#: DataParallel's buckets here: MB a bucket, MB the first
BUCKET_MB, FIRST_MB = 0.1, 0.02


def global_batch(prompt_masked=False):
    """The global batch: ``VALID[r]`` labelled targets in row r, the rest
    -100 at the row's end (padding), or at its start (a prompt)."""
    ids = np.random.default_rng(1).integers(0, 256, size=(4, 16))
    labels = ids.copy()
    for r, v in enumerate(VALID):
        if prompt_masked:
            labels[r, 1:1 + 15 - v] = -100
        else:
            labels[r, 1 + v:] = -100
    return ids, labels


def write_inputs(out):
    """The JAX model's initial parameters (``paddle.seed(0)``; ``t.``: of
    the tied-embedding model) and the global batch, for the rank
    processes."""
    ids, labels = global_batch()
    _, prompt_labels = global_batch(prompt_masked=True)
    arrays = {}
    for prefix, kw in (("p.", {}), ("t.", {"tie_word_embeddings": True})):
        paddle.seed(0)
        m = JaxLlama(JaxConfig.tiny(**kw))
        arrays.update({prefix + n: np.asarray(p._array)
                       for n, p in m.named_parameters()})
    np.savez(os.path.join(out, "inputs.npz"), ids=ids, labels=labels,
             prompt_labels=prompt_labels, **arrays)


@functools.lru_cache(maxsize=None)
def jax_run(place, world, opt="AdamW", steps=3, accumulate=1,
            prompt_masked=False, cfg=()):
    """The JAX package's 3-step run at ``place`` on a ``world`` mesh
    (``cfg``: ``LlamaConfig.tiny`` keywords as items; ``SGD`` at lr 1.0,
    whose step reads off the gradient): (losses, {name: parameter})."""
    from paddle_tpu.distributed.sharding import group_sharded_parallel

    paddle.seed(0)
    m = JaxLlama(JaxConfig.tiny(**dict(cfg)))
    o = getattr(jopt, opt)(learning_rate=1.0 if opt == "SGD" else 1e-3,
                           parameters=m.parameters())
    model = m
    try:
        if place == "dp":
            model = JaxDP(m, comm_buffer_size=BUCKET_MB,
                          last_comm_buffer_size=FIRST_MB,
                          mesh=init_mesh([world], ["dp"]), dp_axis="dp")
        elif place != "single":
            model, o, _ = group_sharded_parallel(
                m, o, level=place, mesh=init_mesh([world], ["dp"]))
        step = JaxTrainStep(model, lambda lg, lb: m.loss(lg, lb), o,
                            accumulate_steps=accumulate)
        ids, labels = global_batch(prompt_masked)
        if accumulate > 1:
            # microbatch i is every rank's i-th local share, in rank order
            ids, labels = (a.reshape(world, accumulate, -1, a.shape[-1])
                           .transpose(1, 0, 2, 3)
                           .reshape(accumulate, -1, a.shape[-1])
                           for a in (ids, labels))
        x = paddle.to_tensor(ids.astype(np.int64))
        y = paddle.to_tensor(labels.astype(np.int64))
        losses = [float(step(x, y)) for _ in range(steps)]
        return losses, {n: np.asarray(a) for n, a in step.params.items()}
    finally:
        set_mesh(None)
        JC.destroy_process_group()


def assert_run_matches(got, ref, ltol=1e-5, wtol=1e-5):
    losses, params = ref
    np.testing.assert_allclose(got["losses"], losses, rtol=ltol)
    names = sorted(k[2:] for k in got if k.startswith("p."))
    assert names == sorted(params)
    for n in names:
        np.testing.assert_allclose(got["p." + n], params[n], rtol=0,
                                   atol=wtol, err_msg=n)


def _dp(world, **kw):
    return {"case": "train", "placement": "dp", "bucket_mb": BUCKET_MB,
            "first_mb": FIRST_MB, **kw}


def _jax_runs_of_two_ranks():
    """The JAX package's runs the 2-rank tests read (cached), computed
    while the port's ranks run."""
    jax_run("dp", 2)
    jax_run("dp", 2, cfg=(("tie_word_embeddings", True),))
    jax_run("dp", 2, prompt_masked=True)
    jax_run("dp", 2, accumulate=2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dist"))
    write_inputs(out)
    W.run_ranks(2, ["collectives", _dp(2, tag="dp2"),
                    _dp(2, tag="dp2_prompt", labels="prompt_labels"),
                    _dp(2, tag="dp2_tied", cfg={"tie_word_embeddings": True}),
                    _dp(2, tag="dp2_acc", accumulate=2),
                    "no_sync", "step_guards",
                    {"case": "train", "placement": "fleet_dp",
                     "tag": "fleet_dp2"},
                    {"case": "train", "placement": "fleet_sharding",
                     "stage": 2, "tag": "fleet_sharding2"}], out,
                meanwhile=_jax_runs_of_two_ranks)
    W.run_ranks(4, ["collectives", _dp(4, tag="dp4")], out,
                meanwhile=lambda: jax_run("dp", 4))
    return out


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------
def _view(world, i):
    """The reference's local-shard view of ``_rank_input(i, r)``."""
    return np.stack([W._rank_input(i, r) for r in range(world)])


def _t(a):
    return paddle.to_tensor(np.ascontiguousarray(a, dtype=np.float32))


def _reference_collectives(world):
    init_mesh([world], ["x"])
    JC.destroy_process_group()
    try:
        ref = {}
        for op in ("sum", "max", "min", "prod", "avg"):
            ref[f"all_reduce_{op}"] = JC.all_reduce(_t(_view(world, 0)),
                                                    op).numpy()
        g = JC.all_gather(None, _t(_view(world, 1))).numpy()
        ref["all_gather"] = g.reshape(world, world, 8)
        pay = np.stack([np.stack([_view(world, 2)[r] + 100.0 * j
                                  for j in range(world)])
                        for r in range(world)])
        ref["reduce_scatter"] = JC.reduce_scatter(None, _t(pay)).numpy()
        ref["broadcast"] = JC.broadcast(_t(_view(world, 3)),
                                        src=world - 1).numpy()
        ref["reduce"] = JC.reduce(_t(_view(world, 0)), world - 1).numpy()
        ref["all_to_all"] = JC.all_to_all(
            None, _t(pay.reshape(world * world, 8))).numpy().reshape(
                world, world, 8)
        buf = _t(np.zeros((world, 8)))
        JC.send(_t(_view(world, 2)), dst=1)
        JC.recv(buf, src=0)
        ref["send_0_to_1"] = buf.numpy()[1]
        return ref
    finally:
        set_mesh(None)
        JC.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_match_the_local_shard_view(runs, world):
    ref = _reference_collectives(world)
    got = [W.load(runs, f"collectives{world}", r) for r in range(world)]
    for r in range(world):
        for op in ("sum", "max", "min", "avg"):
            np.testing.assert_allclose(got[r][f"all_reduce_{op}"],
                                       ref[f"all_reduce_{op}"][r],
                                       rtol=1e-6, err_msg=op)
        # PROD is the true product here; the reference's exp-of-log-sum
        # agrees on positive inputs up to its rounding
        np.testing.assert_allclose(got[r]["all_reduce_prod"],
                                   ref["all_reduce_prod"][r], rtol=1e-5)
        np.testing.assert_array_equal(got[r]["all_gather"],
                                      ref["all_gather"][r])
        np.testing.assert_array_equal(got[r]["all_gather_list"],
                                      ref["all_gather"][r])
        np.testing.assert_array_equal(got[r]["reduce_scatter"],
                                      ref["reduce_scatter"][r])
        np.testing.assert_array_equal(got[r]["reduce_scatter_list"],
                                      ref["reduce_scatter"][r])
        np.testing.assert_array_equal(got[r]["broadcast"],
                                      ref["broadcast"][r])
        np.testing.assert_array_equal(got[r]["all_to_all"],
                                      ref["all_to_all"][r])
        np.testing.assert_array_equal(
            got[r]["scatter"], np.full(8, float(r)) + W._rank_input(3, 0))
        prv = (r - 1) % world
        for name, i in (("batch_isend_irecv", 1), ("send_recv", 2),
                        ("isend_irecv", 0)):
            np.testing.assert_array_equal(got[r][name],
                                          W._rank_input(i, prv))
    # reduce: the dst row (the reference fills every row)
    np.testing.assert_array_equal(got[world - 1]["reduce"],
                                  ref["reduce"][world - 1])
    np.testing.assert_array_equal(got[1]["send_recv"], ref["send_0_to_1"])
    two = _view(2, 0).sum(0)
    for r in range(2):
        np.testing.assert_array_equal(got[r]["new_group_sum"], two)


# ---------------------------------------------------------------------------
# the reducer and DataParallel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mb", [(25.0, 1.0), (0.1, 0.02), (0.01, 0.05)])
def test_partition_matches_the_reference(mb):
    paddle.seed(0)
    m = JaxLlama(JaxConfig.tiny())
    sized = [(n, int(np.prod(p.shape)) * 4)
             for n, p in list(m.named_parameters())[::-1]]
    want = JaxReducer(*mb).partition(sized)
    assert GradReducer(*mb).partition(sized) == want
    if mb[0] < 1:
        assert len(want) > 1


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_matches_jax(runs, world):
    got = W.load(runs, f"dp{world}")
    assert got["buckets"] > 1
    assert got["flushes"] == 3 * got["buckets"]
    assert_run_matches(got, jax_run("dp", world))


def test_data_parallel_tied_embeddings(runs):
    """The tied embedding's gradient accumulates twice in a backward (the
    lookup and the head); its bucket flushes once, after both. Losses
    within 1e-5 relative; parameters under ``test_torch_train.py``'s
    per-step bar (every element within 5e-3, all but 4 a tensor within
    1e-5): on this model the JAX package's own ``DataParallel`` run moves
    2 elements of ``layers.1.mlp.up_proj`` 2.4e-5 from its unsharded run
    (4.6e-5 at 4 ranks), Adam's step-1 conditioning again. A flush before
    the head's share would move every element of the tied weight."""
    got = W.load(runs, "dp2_tied")
    assert got["flushes"] == 3 * got["buckets"]
    losses, params = jax_run("dp", 2, cfg=(("tie_word_embeddings", True),))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for n, ref in params.items():
        diff = np.abs(got["p." + n] - ref)
        assert diff.max() <= 5e-3, (n, diff.max())
        assert (diff > 1e-5).sum() <= 4, (n, (diff > 1e-5).sum())


def test_data_parallel_prompt_masked_losses(runs):
    """The prompt-masked layout: losses only (module docstring)."""
    losses, _ = jax_run("dp", 2, prompt_masked=True)
    np.testing.assert_allclose(W.load(runs, "dp2_prompt")["losses"], losses,
                               rtol=1e-5)


def test_gradient_merge_flushes_once_a_step(runs):
    got = W.load(runs, "dp2_acc")
    assert got["flushes"] == 3 * got["buckets"]
    losses, _ = jax_run("dp", 2, accumulate=2)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)


def test_no_sync_holds_the_flush(runs):
    got = [W.load(runs, "no_sync2", r) for r in range(2)]
    for g in got:
        assert g["flushed_inside"] == 0 and g["finished_inside"] == 0
        assert g["step_refused"] and g["untouched"]
        assert g["flushes_after"] == g["buckets"]
    names = [k[len("local."):] for k in got[0] if k.startswith("local.")]
    for n in names:
        # inside: each rank's own gradient; after: the ranks' mean
        assert not np.array_equal(got[0]["local." + n], got[1]["local." + n])
        np.testing.assert_array_equal(got[0]["reduced." + n],
                                      got[1]["reduced." + n])


def test_step_guards(runs):
    """A frozen parameter leaves its bucket, so every bucket still flushes
    during backward; a loss function without ``count_group`` is
    refused."""
    for r in range(2):
        g = W.load(runs, "step_guards2", r)
        assert "model.layers.0.mlp.up_proj.weight" not in set(
            g["live"].tolist())
        assert int(g["live_buckets"]) > 2
        assert int(g["flushed_in_backward"]) == int(g["live_buckets"])
        assert g["frozen_kept"] and g["loss_fn_refused"]


@pytest.mark.parametrize("mode", ["fleet_dp2", "fleet_sharding2"])
def test_fleet_front_end(runs, mode):
    got = W.load(runs, mode)
    assert (int(got["worker_index"]), int(got["worker_num"]),
            bool(got["first"])) == (0, 2, True)
    assert str(got["wrapped"]) == ("DataParallel" if mode == "fleet_dp2"
                                   else "LlamaForCausalLM")
    losses, params = jax_run("dp", 2)
    assert_run_matches(got, (losses, params))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
RANK_SCRIPT = """
import os, sys, time
import torch.distributed as dist
from paddle_tpu_torch.distributed import all_reduce, init_parallel_env
import torch
init_parallel_env(device="cpu")
x = torch.ones(3) * (dist.get_rank() + 1)
all_reduce(x)
print("rank", os.environ["PADDLE_TRAINER_ID"], "of",
      os.environ["PADDLE_TRAINERS_NUM"], "device",
      os.environ["FLAGS_selected_gpus"], "sum", x.tolist(), flush=True)
if sys.argv[1] == "fail" and dist.get_rank() == 1:
    sys.exit(3)
if sys.argv[1] == "fail":
    open(sys.argv[2], "w").write(str(os.getpid()))
    time.sleep(600)
"""


def _launch(tmp_path, mode, timeout):
    script = tmp_path / "rank.py"
    script.write_text(RANK_SCRIPT)
    pid_file = tmp_path / "pid"
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices", "0,0", "--grace_s", "2",
         "--log_dir", str(tmp_path / "log"), str(script), mode,
         str(pid_file)], env=env, capture_output=True, text=True,
        timeout=timeout)
    return proc, time.monotonic() - t0, pid_file


def test_launcher_runs_two_ranks(tmp_path):
    proc, _, _ = _launch(tmp_path, "ok", 60)
    assert proc.returncode == 0, proc.stderr
    logs = [(tmp_path / "log" / f"workerlog.{r}").read_text()
            for r in range(2)]
    for r, log in enumerate(logs):
        assert f"rank {r} of 2 device 0 sum [3.0, 3.0, 3.0]" in log, log


def test_launcher_stops_the_ranks_when_one_fails(tmp_path):
    proc, took, pid_file = _launch(tmp_path, "fail", 60)
    assert proc.returncode == 3, proc.stderr
    assert took < 45
    assert "rank 1 exited with code 3" in proc.stderr
    pid = int(pid_file.read_text())
    with pytest.raises(ProcessLookupError):
        os.kill(pid, 0)


@pytest.mark.parametrize("extra", [["--nnodes", "2"], ["--rank", "auto"],
                                   ["--max_restarts", "1"],
                                   ["--elastic_watch", "on"]])
def test_launcher_refuses_what_is_not_ported(extra):
    from paddle_tpu_torch.distributed.launch.main import launch

    with pytest.raises(NotImplementedError, match="not ported"):
        launch([*extra, "x.py"])
