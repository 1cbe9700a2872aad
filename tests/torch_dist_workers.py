"""Rank processes of the port's distributed CPU tests.

``run_ranks`` starts ``world`` processes of this file (gloo on the CPU, a
``FileStore`` under the test's tmp dir, one thread each), joins each with
its own timeout and kills the rest on a timeout or a failure; the parent
may compute the JAX package's references meanwhile. Each rank
runs the named cases in order and rank 0 (or every rank, for the
collectives) writes each case's result to ``<out>/<case>.<rank>.npz``.
This file imports the port only: the parent test holds the JAX package's
runs, on the same inputs, which it writes to ``<out>/inputs.npz``.

Inputs (``inputs.npz``): ``ids`` and ``labels`` / ``prompt_labels`` (the
global batch, split over the ranks in rank order) and ``p.<name>`` (the
initial parameters; ``t.<name>``: of the tied-embedding model; the tensor-
parallel tests add ``h.<name>``: of the 8-head model, and ``L.<name>``:
the per-layer gates' arrays).

Tensor parallelism: a rank's parameters are its shards, and the tests
read every result gathered over the model-parallel group
(``bridge.gather_tp_params``); the dp ranks split the global batch in
dp-rank order and the mp ranks of one dp group take the same rows.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def run_ranks(world, cases, out_dir, timeout_s=60.0, *, meanwhile=None):
    """Run ``cases`` on ``world`` ranks (``meanwhile()``, if given, runs in
    this process while they do); raise with the ranks' logs when one
    fails or outlives ``timeout_s``. No rank process outlives it."""
    store = os.path.join(out_dir, f"store.{world}.{time.monotonic_ns()}")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = []
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        for r in range(world):
            log = open(os.path.join(out_dir, f"rank{r}.{world}.log"), "wb")
            procs.append((subprocess.Popen(
                [sys.executable, __file__, str(r), str(world), store,
                 out_dir, json.dumps(cases)], env=env, stdout=log,
                stderr=subprocess.STDOUT), log))
        if meanwhile is not None:
            meanwhile()
        for p, _ in procs:
            try:
                code = p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = "timed out"
                break
            if code != 0:
                failed = f"exited with {code}"
                break
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    if failed:
        logs = "".join(
            open(os.path.join(out_dir, f"rank{r}.{world}.log")).read()[-3000:]
            for r in range(world))
        raise RuntimeError(f"a rank {failed}:\n{logs}")


def load(out_dir, case, rank=0):
    with np.load(os.path.join(out_dir, f"{case}.{rank}.npz"),
                 allow_pickle=True) as f:
        return dict(f)


# ---------------------------------------------------------------------------
# inside a rank
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _flags_set(**values):
    """The port's flags at ``values`` inside, restored after."""
    from paddle_tpu_torch.framework import flags

    old = {k: flags.get_flag(k) for k in values}
    flags.set_flags(values)
    try:
        yield
    finally:
        flags.set_flags(old)


def _save(out_dir, case, rank, **arrays):
    np.savez(os.path.join(out_dir, f"{case}.{rank}.npz"), **arrays)


def _rank_input(i, rank):
    return np.arange(8, dtype=np.float32) * (i + 1) + 10.0 * rank + 1.0


def case_collectives(rank, world, out_dir, inputs):
    """Every collective on rank-dependent inputs (``_rank_input``)."""
    import torch

    from paddle_tpu_torch.distributed import collective as C

    x = [torch.tensor(_rank_input(i, rank)) for i in range(4)]
    out = {}
    for op in ("sum", "max", "min", "prod", "avg"):
        out[f"all_reduce_{op}"] = C.all_reduce(x[0].clone(), op).numpy()
    out["all_gather"] = C.all_gather(None, x[1]).numpy()
    lst = []
    C.all_gather(lst, x[1])
    out["all_gather_list"] = torch.stack(lst).numpy()
    payload = torch.stack([x[2] + 100.0 * j for j in range(world)])
    out["reduce_scatter"] = C.reduce_scatter(None, payload).numpy()
    out["reduce_scatter_list"] = C.reduce_scatter(
        torch.empty(8), list(payload.unbind(0))).numpy()
    out["broadcast"] = C.broadcast(x[3].clone(), src=world - 1).numpy()
    parts = [torch.full((8,), float(j)) + x[3] for j in range(world)]
    out["scatter"] = C.scatter(torch.empty(8), parts, src=0).numpy()
    red = x[0].clone()
    C.reduce(red, dst=world - 1)
    out["reduce"] = red.numpy()
    out["all_to_all"] = C.all_to_all(None, payload).numpy()
    # a ring: rank r sends to r + 1 and receives from r - 1
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    got = torch.empty(8)
    ops = [C.P2POp(C.isend, x[1], nxt), C.P2POp(C.irecv, got, prv)]
    tasks = C.batch_isend_irecv(ops)
    out["batch_isend_irecv"] = tasks[1].wait().numpy()
    got2 = torch.empty(8)
    if rank % 2 == 0:
        C.send(x[2], nxt)
        C.recv(got2, prv)
    else:
        C.recv(got2, prv)
        C.send(x[2], nxt)
    out["send_recv"] = got2.numpy()
    t = C.isend(x[0], nxt)
    got3 = C.irecv(torch.empty(8), prv).wait()
    t.wait()
    out["isend_irecv"] = got3.numpy()
    C.barrier()
    g = C.new_group([0, 1])
    if rank < 2:
        out["new_group_sum"] = C.all_reduce(x[0].clone(), group=g).numpy()
    _save(out_dir, f"collectives{world}", rank, **out)


def _model(cfg_kw, inputs):
    import torch

    from paddle_tpu_torch.models.bridge import load_numpy_params
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    m = LlamaForCausalLM(LlamaConfig.tiny(**cfg_kw), device="cpu")
    prefix = "t." if cfg_kw.get("tie_word_embeddings") else "p."
    load_numpy_params(m, {k[2:]: v for k, v in inputs.items()
                          if k.startswith(prefix)})
    return m, torch


def _local(inputs, rank, world, accumulate, labels="labels"):
    import torch

    ids, labels = inputs["ids"], inputs[labels]
    b = ids.shape[0] // world
    ids, labels = ids[rank * b:(rank + 1) * b], labels[rank * b:(rank + 1) * b]
    if accumulate > 1:
        ids = ids.reshape(accumulate, -1, ids.shape[-1])
        labels = labels.reshape(accumulate, -1, labels.shape[-1])
    return torch.tensor(ids), torch.tensor(labels)


def _gathered_params(model, plan):
    return {n: (plan.full_param(n) if plan is not None else p.detach())
            .float().numpy() for n, p in model.named_parameters()}


def case_train(rank, world, out_dir, inputs, spec):
    """A few ``TrainStep``s at one placement: ``spec`` holds placement
    (single, dp, os, os_g, p_g_os, fleet_dp, fleet_sharding), opt (AdamW,
    AdamW8bit), steps, accumulate, clip, cfg (LlamaConfig.tiny kw), flags
    (set for this case only), tag."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import (DataParallel, fleet,
                                              group_sharded_parallel)
    from paddle_tpu_torch.jit import TrainStep

    with _flags_set(**spec.get("flags", {})):
        _train(rank, world, out_dir, inputs, spec, nn, optimizer,
               DataParallel, fleet, group_sharded_parallel, TrainStep)


def _train(rank, world, out_dir, inputs, spec, nn, optimizer, DataParallel,
           fleet, group_sharded_parallel, TrainStep):
    m, torch = _model(spec.get("cfg", {}), inputs)
    clip = (nn.ClipGradByGlobalNorm(spec["clip"]) if spec.get("clip")
            else None)
    opt = getattr(optimizer, spec.get("opt", "AdamW"))(
        learning_rate=1e-3, parameters=m.parameters(), grad_clip=clip)
    place = spec["placement"]
    model, plan = m, None
    if place == "dp":
        model = DataParallel(m, comm_buffer_size=spec.get("bucket_mb", 25),
                             last_comm_buffer_size=spec.get("first_mb", 1))
    elif place in ("os", "os_g", "p_g_os"):
        model, opt, _ = group_sharded_parallel(m, opt, place)
    elif place.startswith("fleet"):
        strategy = fleet.DistributedStrategy()
        key = "dp_degree" if place == "fleet_dp" else "sharding_degree"
        strategy.hybrid_configs = dict(strategy.hybrid_configs,
                                       **{key: world})
        strategy.sharding_configs["stage"] = spec.get("stage", 2)
        fleet.init(is_collective=True, strategy=strategy, device="cpu")
        out_fleet = {"worker_index": fleet.fleet.worker_index,
                     "worker_num": fleet.fleet.worker_num,
                     "first": fleet.fleet.is_first_worker()}
        fleet.fleet.barrier_worker()
        model = fleet.distributed_model(m)
        opt = fleet.distributed_optimizer(opt)
    plan = getattr(model, "_zero_plan", None)
    accumulate = spec.get("accumulate", 1)
    step = TrainStep(model, m.loss, opt,
                     accumulate_steps=accumulate)
    ids, labels = _local(inputs, rank, world, accumulate,
                         spec.get("labels", "labels"))
    red = getattr(model, "_grad_reducer", None)
    losses = []
    for _ in range(spec.get("steps", 3)):
        losses.append(float(step(ids, labels)))
    out = {"losses": np.asarray(losses)}
    if place.startswith("fleet"):
        out.update({k: np.asarray(v) for k, v in out_fleet.items()})
        out["wrapped"] = np.asarray(type(model).__name__)
    out.update({"p." + k: v for k, v in _gathered_params(m, plan).items()})
    if red is not None:
        out["flushes"] = np.asarray(red.flushes)
        out["buckets"] = np.asarray(len(red._buckets))
    if clip is not None:
        out["global_norm"] = np.asarray(float(opt._grad_clip.last_global_norm))
    if plan is not None:
        out["prefetches"] = np.asarray(plan.prefetches)
    if rank == 0 or spec.get("all_ranks"):
        _save(out_dir, spec["tag"], rank, **out)


def case_no_sync(rank, world, out_dir, inputs):
    """Under ``no_sync`` a backward flushes nothing and leaves each rank's
    local gradient, ``finish`` flushes nothing either, and ``TrainStep``
    refuses to run (parameters untouched); the next backward outside it
    flushes every bucket."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.jit import TrainStep

    m, torch = _model({}, inputs)
    m.train()
    dp = DataParallel(m)
    red = dp._grad_reducer
    ids, labels = _local(inputs, rank, world, 1)
    step = TrainStep(dp, m.loss, optimizer.AdamW(
        learning_rate=1e-3, parameters=m.parameters()))
    before = {n: p.detach().clone() for n, p in m.named_parameters()}
    red.prepare()
    with dp.no_sync():
        m.loss(dp(ids), labels).backward()
        finished = red.finish()
        try:
            step(ids, labels)
            step_refused = False
        except RuntimeError:
            step_refused = True
    local = {n: p.grad.clone() for n, p in m.named_parameters()}
    flushed_inside = red.flushes
    untouched = all(torch.equal(p, before[n])
                    for n, p in m.named_parameters())
    for p in m.parameters():
        p.grad = None
    red.prepare()
    m.loss(dp(ids), labels).backward()
    red.finish()
    out = {"flushed_inside": np.asarray(flushed_inside),
           "finished_inside": np.asarray(len(finished)),
           "step_refused": np.asarray(step_refused),
           "untouched": np.asarray(untouched),
           "flushes_after": np.asarray(red.flushes),
           "buckets": np.asarray(len(red._buckets))}
    out.update({"local." + n: g.numpy() for n, g in local.items()})
    out.update({"reduced." + n: p.grad.numpy()
                for n, p in m.named_parameters()})
    _save(out_dir, f"no_sync{world}", rank, **out)


def case_step_guards(rank, world, out_dir, inputs):
    """A parameter frozen after the step is built (``TrainStep`` turns
    every gradient on) is left out of its bucket: every bucket still
    flushes during backward (before ``finish``) and the frozen parameter
    is not updated. A loss function that cannot take ``count_group`` is
    refused when the step is built."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import DataParallel
    from paddle_tpu_torch.jit import TrainStep

    m, torch = _model({}, inputs)
    dp = DataParallel(m, comm_buffer_size=0.01, last_comm_buffer_size=0.01)
    red = dp._grad_reducer
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    try:
        TrainStep(dp, lambda o, lb: m.loss(o, lb), opt)
        refused = False
    except TypeError:
        refused = True
    step = TrainStep(dp, m.loss, opt)
    frozen = dict(m.named_parameters())["model.layers.0.mlp.up_proj.weight"]
    frozen.requires_grad_(False)
    before = frozen.detach().clone()
    at_finish = []
    finish = red.finish

    def recording_finish():
        at_finish.append(red.flushes)
        return finish()

    red.finish = recording_finish
    ids, labels = _local(inputs, rank, world, 1)
    step(ids, labels)
    _save(out_dir, f"step_guards{world}", rank,
          live=np.asarray(sorted(n for b in red._buckets for n, _ in b.live)),
          flushed_in_backward=np.asarray(at_finish[0]),
          live_buckets=np.asarray(sum(1 for b in red._buckets if b.live)),
          frozen_kept=np.asarray(torch.equal(frozen, before)),
          loss_fn_refused=np.asarray(refused))


def _gather_flat(plan, t, name, per_block):
    """Gather each rank's shard ``t`` of ``name`` (``per_block`` elements a
    quantization block: 2048 for codes, 1 for scales) into the full flat
    layout."""
    import torch
    import torch.distributed as dist

    lay = plan.layouts[name]
    seg = lay.seg // 2048 * per_block
    dtype = t.dtype
    if dtype == torch.float8_e4m3fn:       # gloo moves them as bytes
        t = t.view(torch.uint8)
    buf = torch.zeros(seg, dtype=t.dtype)
    buf[:t.numel()] = t.reshape(-1)
    out = torch.empty(seg * plan.group.nranks, dtype=t.dtype)
    dist.all_gather_into_tensor(out, buf)
    return out.view(dtype)


def case_k8_bitwise(rank, world, out_dir, inputs, spec):
    """One ``AdamW8bit`` step at ``spec["placement"]``: the gathered
    parameters, masters, codes and scales against this rank's unsharded
    update (K8's plain version) of the same initial state on the same
    reduced gradients; and the same comparison of a shard map moved by one
    block (the control)."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.ops.kernels.fused_optimizer_update import (
        adamw8bit_update, init_state)

    cfg = spec.get("cfg", {})
    m, torch = _model(cfg, inputs)
    init = {n: p.detach().clone() for n, p in m.named_parameters()}
    opt = optimizer.AdamW8bit(learning_rate=1e-3, parameters=m.parameters())
    model, opt, _ = group_sharded_parallel(m, opt, spec["placement"])
    plan = model._zero_plan
    seen = {}
    inner_step = opt.step

    def recording_step(*, grads=None):
        seen.update({n: g.clone() for n, g in (
            grads if grads is not None else
            {n: p.grad for n, p in m.named_parameters()}).items()})
        inner_step(grads=grads)

    opt.step = recording_step
    step = TrainStep(model, m.loss, opt)
    ids, labels = _local(inputs, rank, world, 1)
    step(ids, labels)
    bad, checked, moved_bad = [], 0, 0
    for name, p in m.named_parameters():
        lay = plan.layouts[name]
        g = seen[name]
        if plan.stage == 1:
            g = g.reshape(-1)[lay.lo:lay.hi]
        full_g = _gather_flat(plan, g, name, 2048)[:lay.numel]
        st = opt._state.get(name)
        empty = torch.zeros(0)
        got = {k: _gather_flat(plan, (st[k] if st is not None else
                                      empty.to(dt)), name, per)
               for k, dt, per in (("m_q", torch.float8_e4m3fn, 2048),
                                  ("v_q", torch.float8_e4m3fn, 2048),
                                  ("m_s", torch.float32, 1),
                                  ("v_s", torch.float32, 1))}
        full_p = plan.full_param(name).reshape(-1)
        ref_p = init[name].clone()
        ref_st = init_state(ref_p, False)
        adamw8bit_update(ref_p, full_g.view(ref_p.shape), ref_st, 1e-3, 1,
                         0.01, 1.0, 0.9, 0.999, 1e-8)
        nb = ref_st["m_s"].numel()
        pairs = [("param", full_p, ref_p.reshape(-1))] + [
            (k, got[k][:ref_st[k].numel()], ref_st[k]) for k in got]
        for k, a, b in pairs:
            checked += 1
            if not torch.equal(a.view(torch.uint8) if a.dtype ==
                               torch.float8_e4m3fn else a,
                               b.view(torch.uint8) if b.dtype ==
                               torch.float8_e4m3fn else b):
                bad.append(f"{name}.{k}")
        # the control: every shard moved one block later
        if nb > 1:
            moved = torch.roll(got["m_s"][:nb], 1)
            moved_bad += int(not torch.equal(moved, ref_st["m_s"]))
    _save(out_dir, spec["tag"], rank, bad=np.asarray(bad, dtype=object)
          if bad else np.zeros(0), checked=np.asarray(checked),
          moved_bad=np.asarray(moved_bad),
          launches_plan=np.asarray(sum(
              1 for n in plan.layouts
              if plan.layouts[n].hi > plan.layouts[n].lo)),
          states=np.asarray(len(opt._state)))


def case_save(rank, world, out_dir, inputs, spec):
    """``save_group_sharded_model`` after one step: the saved weights are
    the gathered ones, every rank's state file carries its ranges."""
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import (group_sharded_parallel,
                                              save_group_sharded_model)
    from paddle_tpu_torch.jit import TrainStep

    m, torch = _model({}, inputs)
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.parameters())
    model, opt, _ = group_sharded_parallel(m, opt, spec["placement"])
    TrainStep(model, m.loss, opt)(
        *_local(inputs, rank, world, 1))
    prefix = os.path.join(out_dir, spec["tag"])
    save_group_sharded_model(model, prefix, opt)
    st = torch.load(prefix + f".rank{rank}.pdopt")
    opt.set_state_dict(st)
    _save(out_dir, spec["tag"], rank, ranges=np.asarray(
        sorted((n, lo, hi) for n, (lo, hi) in st["shard_ranges"].items()),
        dtype=object))


# ---------------------------------------------------------------------------
# tensor and sequence parallelism
# ---------------------------------------------------------------------------
def _tp_model(spec, inputs):
    """The tiny Llama of ``spec["cfg"]`` loaded with the ``spec["prefix"]``
    parameters (default ``p.``)."""
    from paddle_tpu_torch.models.bridge import load_numpy_params
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    pre = spec.get("prefix", "p.")
    m = LlamaForCausalLM(LlamaConfig.tiny(**spec.get("cfg", {})),
                         device="cpu")
    load_numpy_params(m, {k[len(pre):]: v for k, v in inputs.items()
                          if k.startswith(pre)})
    return m


def case_tp_train(rank, world, out_dir, inputs, spec):
    """``TrainStep``s of the tiny Llama under tensor parallelism: ``spec``
    holds dp, mp, sp (sequence parallelism), cm (``collective_matmul``),
    cfg and prefix (the model), opt (AdamW, AdamW8bit), steps, clip, fleet
    (through ``fleet.init`` / ``distributed_model``), control ("skip row
    all-reduce": layer 0's o_proj output never all-reduced; "skip sp
    hooks": the norm weights' sequence-parallel all-reduce removed) and
    tag. Saves the losses, the gathered parameters
    (``p.``), the gathered step-1 gradients (``g.``) and the clip's norm."""
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import (TensorParallel,
                                              create_hybrid_group, fleet,
                                              overlap)
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.models.bridge import (gather_tp_params,
                                                tp_shards_from_numpy)
    from paddle_tpu_torch.models.llama import (apply_llama_tensor_parallel,
                                               llama_sharding_plan)

    dp, mp = spec.get("dp", 1), spec["mp"]
    with _flags_set(collective_matmul=spec.get("cm", True)):
        m = _tp_model(spec, inputs)
        clip = (nn.ClipGradByGlobalNorm(spec["clip"]) if spec.get("clip")
                else None)
        opt = getattr(optimizer, spec.get("opt", "AdamW"))(
            learning_rate=1e-3, parameters=m.parameters(), grad_clip=clip)
        if spec.get("fleet"):
            strategy = fleet.DistributedStrategy()
            strategy.hybrid_configs = dict(strategy.hybrid_configs,
                                           dp_degree=dp, mp_degree=mp)
            fleet.init(is_collective=True, strategy=strategy, device="cpu")
            hcg = fleet.get_hybrid_communicate_group()
            apply_llama_tensor_parallel(m, hcg.mesh,
                                        sequence_parallel=spec.get("sp"))
            model = fleet.distributed_model(m)
            opt = fleet.distributed_optimizer(opt)
        else:
            hcg = create_hybrid_group(dp=dp, mp=mp)
            apply_llama_tensor_parallel(m, hcg.mesh,
                                        sequence_parallel=spec.get("sp"))
            model = TensorParallel(m, hcg) if dp > 1 else m
        step = TrainStep(model, m.loss, opt)
        applied = {n: p.detach().numpy().copy()
                   for n, p in m.named_parameters()}
        control = spec.get("control")
        if control == "skip sp hooks":
            for h in m._sp_hooks:
                h.remove()
        restore = None
        if control == "skip row all-reduce":
            real = overlap.matmul_ar
            o_proj = m.model.layers[0].self_attn.o_proj.weight

            def skipping(x, w, *a, **k):
                return x @ w if w is o_proj else real(x, w, *a, **k)

            overlap.matmul_ar, restore = skipping, real
        seen = {}
        inner = opt.step

        def recording_step(*, grads=None):
            if not seen:
                seen.update({n: (grads[n] if grads is not None
                                 else p.grad).detach().clone()
                             for n, p in m.named_parameters()})
            inner(grads=grads)

        opt.step = recording_step
        ids, labels = _local(inputs, hcg.get_data_parallel_rank(), dp, 1)
        try:
            losses = [float(step(ids, labels))
                      for _ in range(spec.get("steps", 3))]
        finally:
            if restore is not None:
                overlap.matmul_ar = restore
        out = {"losses": np.asarray(losses),
               "wrapped": np.asarray(type(model).__name__)}
        out.update({"p." + k: v.float().numpy()
                    for k, v in gather_tp_params(m).items()})
        out.update({"g." + k: v.float().numpy()
                    for k, v in gather_tp_params(m, seen).items()})
        if clip is not None:
            out["global_norm"] = np.asarray(
                float(opt._grad_clip.last_global_norm))
        out["distributed"] = np.asarray(sorted(
            n for n, p in m.named_parameters()
            if getattr(p, "mp_cut", False)))
        # the bridge's cut of the full tree is this rank's shards
        cut = tp_shards_from_numpy(
            {k[len(spec.get("prefix", "p.")):]: v for k, v in inputs.items()
             if k.startswith(spec.get("prefix", "p."))},
            llama_sharding_plan(m, hcg.mesh), "mp", mp,
            hcg.get_model_parallel_rank())
        out["bridge_cut_ok"] = np.asarray(all(
            np.array_equal(cut[n], applied[n]) for n in applied))
    if rank == 0:
        _save(out_dir, spec["tag"], rank, **out)


def case_tp_topology(rank, world, out_dir, inputs, spec):
    """This rank's groups under ``create_hybrid_group`` at ``spec``'s
    degrees (dp, sep, mp): each axis's rank list and this rank's
    coordinate."""
    from paddle_tpu_torch.distributed import create_hybrid_group

    hcg = create_hybrid_group(dp=spec.get("dp", 1), sep=spec.get("sep", 1),
                              mp=spec.get("mp", 1))
    _save(out_dir, spec["tag"], rank,
          mp=np.asarray(hcg.get_model_parallel_group().ranks),
          dp=np.asarray(hcg.get_data_parallel_group().ranks),
          sep=np.asarray(hcg.get_sep_parallel_group().ranks),
          coord=np.asarray([hcg.get_data_parallel_rank(),
                            hcg.get_sep_parallel_rank(),
                            hcg.get_model_parallel_rank()]),
          mode=np.asarray(hcg.get_parallel_mode()))


class _FakeCuda:
    """Stands for a CUDA tensor where there is none: what the collectives'
    backend check reads."""
    is_cuda = True

    def contiguous(self):
        return self


def case_tp_refusals(rank, world, out_dir, inputs, spec):
    """The ring's hop refuses a CUDA tensor on a gloo group (gloo has no
    point-to-point transfer of CUDA tensors): NotImplementedError, and no
    switch to the monolithic form."""
    from paddle_tpu_torch.distributed import create_hybrid_group, overlap

    hcg = create_hybrid_group(mp=world)
    try:
        overlap._Hop(_FakeCuda(), hcg.get_model_parallel_group(), -1,
                     "ag_matmul", 0)
        msg = ""
    except NotImplementedError as e:
        msg = str(e)
    _save(out_dir, "tp_refusals", rank, ring_cuda_gloo=np.asarray(msg))


def _shard(a, dim, rank, n):
    size = a.shape[dim] // n
    return np.take(a, range(rank * size, (rank + 1) * size), axis=dim)


def _share(a, rank, n):
    """Rank ``rank``'s share of a cotangent whose shares sum to ``a``
    (the per-rank cotangent behind a column-cut consumer)."""
    return a * (rank + 1) / (n * (n + 1) / 2)


def case_tp_layers(rank, world, out_dir, inputs, spec):
    """The per-layer gates on ``L.*`` inputs with ``collective_matmul`` at
    ``spec["cm"]``: each layer's forward and input / weight gradients for
    the cotangent ``L.cot_*``, gathered over the group (results under
    ``<layer>.<what>``); mp layers and overlap products over an mp group
    of ``world`` ranks, ``ulysses_attention`` over a sep group."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import (create_hybrid_group, mp_layers,
                                              overlap)
    from paddle_tpu_torch.distributed import sequence_parallel as SP
    from paddle_tpu_torch.nn.layer import Layer

    L = {k[2:]: v for k, v in inputs.items() if k.startswith("L.")}
    n, out = world, {}
    T = torch.tensor

    def gather(t, dim):
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.detach().contiguous())
        return torch.cat(parts, dim).numpy()

    def leaf(a):
        return T(np.ascontiguousarray(a)).requires_grad_(True)

    def load(layer, w, b, wdim, bdim):
        with torch.no_grad():
            layer.weight.copy_(T(w if wdim is None else _shard(w, wdim,
                                                               rank, n)))
            if getattr(layer, "bias", None) is not None:
                layer.bias.copy_(T(b if bdim is None else _shard(b, bdim,
                                                                 rank, n)))
        layer.train()

    def record(name, y, y_dim, cot, x, x_dim, layer=None, w_dim=None,
               b_dim=None):
        (y * T(np.ascontiguousarray(cot))).sum().backward()
        out[name + ".y"] = gather(y, y_dim) if y_dim is not None else             y.detach().numpy()
        out[name + ".dx"] = gather(x.grad, x_dim) if x_dim is not None             else x.grad.numpy()
        if layer is not None:
            out[name + ".dw"] = gather(layer.weight.grad, w_dim)                 if w_dim is not None else layer.weight.grad.numpy()
            if layer.bias is not None:
                out[name + ".db"] = gather(layer.bias.grad, b_dim)                     if b_dim is not None else layer.bias.grad.numpy()

    with _flags_set(collective_matmul=spec["cm"]):
        hcg = create_hybrid_group(mp=n)
        x, cot = L["x"], L["cot_col"]            # (B, S, K), (B, S, F)
        # ColumnParallelLinear, gathered output
        col = mp_layers.ColumnParallelLinear(16, 32, gather_output=True,
                                             device="cpu")
        load(col, L["w_col"], L["b_col"], 1, 0)
        xi = leaf(x)
        record("col_gather", col(xi), None, cot, xi, None, col, 1, 0)
        # ColumnParallelLinear, output left cut
        col = mp_layers.ColumnParallelLinear(16, 32, gather_output=False,
                                             device="cpu")
        load(col, L["w_col"], L["b_col"], 1, 0)
        xi = leaf(x)
        record("col_cut", col(xi), 2, _shard(cot, 2, rank, n), xi, None,
               col, 1, 0)
        # RowParallelLinear on a cut input / on a replicated one
        xr, cot_r = L["x_row"], L["cot_row"]       # (B, S, F), (B, S, K)
        for name, par in (("row_par", True), ("row_rep", False)):
            row = mp_layers.RowParallelLinear(32, 16, input_is_parallel=par,
                                              device="cpu")
            load(row, L["w_row"], L["b_row"], 0, None)
            xi = leaf(_shard(xr, 2, rank, n) if par else xr)
            record(name, row(xi), None, cot_r, xi, 2 if par else None, row,
                   0, None)
        # VocabParallelEmbedding
        emb = mp_layers.VocabParallelEmbedding(64, 16, device="cpu")
        load(emb, L["w_emb"], None, 0, None)
        y = emb(T(L["ids"]))
        (y * T(L["cot_emb"])).sum().backward()
        out["emb.y"] = y.detach().numpy()
        out["emb.dw"] = gather(emb.weight.grad, 0)
        # ParallelCrossEntropy on vocab-cut logits
        lg = leaf(_shard(L["logits"], 1, rank, n))
        loss = mp_layers.ParallelCrossEntropy()(lg, T(L["labels"]))
        (loss * T(L["cot_ce"])).sum().backward()
        out["ce.y"] = loss.detach().numpy()
        out["ce.dx"] = gather(lg.grad, 1)
        # the sequence-parallel pair
        csp = SP.ColumnSequenceParallelLinear(16, 32, device="cpu")
        load(csp, L["w_col"], L["b_col"], 1, 0)
        xi = leaf(_shard(x, 1, rank, n))
        record("col_sp", csp(xi), 2, _shard(cot, 2, rank, n), xi, 1, csp,
               1, 0)

        class Holder(Layer):
            def __init__(self, inner):
                super().__init__()
                self.inner = inner

        rsp = SP.RowSequenceParallelLinear(32, 16, device="cpu")
        load(rsp, L["w_row"], L["b_row"], 0, None)
        SP.register_sequence_parallel_allreduce_hooks(Holder(rsp))
        xi = leaf(_shard(xr, 2, rank, n))
        record("row_sp", rsp(xi), 1, _shard(cot_r, 1, rank, n), xi, 2, rsp,
               0, None)
        # scatter and all_gather
        xi = leaf(x)
        record("scatter", SP.scatter(xi), 1, _shard(L["cot_x"], 1, rank, n),
               xi, None)
        xi = leaf(_shard(x, 1, rank, n))
        record("all_gather", SP.all_gather(xi), None, _share(L["cot_x"],
                                                             rank, n), xi, 1)
        # the overlap products
        mesh = hcg.mesh
        wc, wr = T(L["w_col"]), T(L["w_row"])
        xi, wi = leaf(_shard(x, 1, rank, n)), leaf(_shard(L["w_col"], 1,
                                                          rank, n))
        y = overlap.ag_matmul(xi, wi, mesh, "mp")
        (y * T(_shard(cot, 2, rank, n))).sum().backward()
        out.update({"ag_matmul.y": gather(y, 2),
                    "ag_matmul.dx": gather(xi.grad, 1),
                    "ag_matmul.dw": gather(wi.grad, 1)})
        xi, wi = leaf(_shard(xr, 2, rank, n)), leaf(_shard(L["w_row"], 0,
                                                           rank, n))
        y = overlap.matmul_rs(xi, wi, mesh, "mp")
        (y * T(_shard(cot_r, 1, rank, n))).sum().backward()
        out.update({"matmul_rs.y": gather(y, 1),
                    "matmul_rs.dx": gather(xi.grad, 2),
                    "matmul_rs.dw": gather(wi.grad, 0)})
        xi, wi = leaf(_shard(xr, 2, rank, n)), leaf(_shard(L["w_row"], 0,
                                                           rank, n))
        y = overlap.matmul_ar(xi, wi, mesh, "mp")
        (y * T(cot_r)).sum().backward()
        out.update({"matmul_ar.y": y.detach().numpy(),
                    "matmul_ar.dx": gather(xi.grad, 2),
                    "matmul_ar.dw": gather(wi.grad, 0)})
        xi = leaf(_shard(x, 2, rank, n))
        y = overlap.ring_all_gather(xi, mesh, "mp", dim=2)
        (y * T(_share(L["cot_x"], rank, n))).sum().backward()
        out.update({"ring_all_gather.y": y.detach().numpy(),
                    "ring_all_gather.dx": gather(xi.grad, 2)})
        xi = leaf(x)
        y = overlap.shard_seq(xi, mesh, "mp", dim=1)
        (y * T(_shard(L["cot_x"], 1, rank, n))).sum().backward()
        out.update({"shard_seq.y": gather(y, 1),
                    "shard_seq.dx": xi.grad.numpy()})
        del wc, wr
        # Ulysses over a sep group of the same ranks
        hcg = create_hybrid_group(sep=n)
        qkv = [leaf(_shard(L[k], 1, rank, n)) for k in ("q", "k", "v")]
        y = SP.ulysses_attention(*qkv)
        (y * T(_shard(L["cot_att"], 1, rank, n))).sum().backward()
        out["ulysses.y"] = gather(y, 1)
        for k, t in zip("qkv", qkv):
            out[f"ulysses.d{k}"] = gather(t.grad, 1)
    if rank == 0:
        _save(out_dir, spec["tag"], rank, **out)


def main(argv):
    rank, world, store, out_dir, cases = (int(argv[1]), int(argv[2]),
                                          argv[3], argv[4],
                                          json.loads(argv[5]))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(world)
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import init_parallel_env
    from paddle_tpu_torch.distributed.mesh import init_mesh

    init_parallel_env(device="cpu", store=dist.FileStore(store, world))
    with np.load(os.path.join(out_dir, "inputs.npz")) as f:
        inputs = dict(f)
    for case in cases:
        name, spec = (case, None) if isinstance(case, str) else \
            (case["case"], case)
        fn = globals()["case_" + name]
        if spec is None:
            fn(rank, world, out_dir, inputs)
        else:
            fn(rank, world, out_dir, inputs, spec)
        dist.barrier()
        # the next case starts from the default mesh and group
        init_mesh()
        C._default_group = None
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
