"""The port's public callables take the JAX package's positional order.

For every public function, class and public method that the port
(``paddle_tpu_torch``) and the JAX package (``paddle_tpu``) both define at
the same module path, ``inspect.signature`` must show:

  * each of the reference's positional parameters at the same position in
    the port, with the same name and the same default (a dtype default
    compares by its name: ``torch.float32`` is ``jnp.float32``);
  * no positional parameter of the port's own: port-only parameters
    (``device``, ``plain``, ``generator``, ``return_logits`` ...) are
    keyword-only.

A reference parameter the port does not implement is there all the same
and raises ``NotImplementedError`` naming it when it is set to anything but
its default; ``test_unported_parameter_raises`` holds a case of each.
There is no allowlist.
"""

from __future__ import annotations

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import paddle_tpu_torch

P = inspect.Parameter
POSITIONAL = (P.POSITIONAL_ONLY, P.POSITIONAL_OR_KEYWORD)


def _module_pairs():
    """(port module name, reference module name) for every port module
    whose path exists in the reference (``__main__`` entry scripts
    aside)."""
    out = []
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        if info.name.endswith(".__main__"):
            continue    # an entry script: importing it runs it
        ref = "paddle_tpu." + info.name[len("paddle_tpu_torch."):]
        try:
            spec = importlib.util.find_spec(ref)
        except ImportError:
            spec = None
        if spec is not None:
            out.append((info.name, ref))
    return out


def _public(obj, modname):
    """Public functions and classes a module defines itself."""
    for name, val in vars(obj).items():
        if name.startswith("_"):
            continue
        if (inspect.isfunction(val) or inspect.isclass(val)) and \
                getattr(val, "__module__", None) == modname:
            yield name, val


def _methods(cls):
    for name, val in vars(cls).items():
        if name.startswith("_") and name not in ("__init__", "__call__"):
            continue
        if isinstance(val, (staticmethod, classmethod)):
            val = val.__func__
        if inspect.isfunction(val):
            yield name, val


def _callables():
    """(label, port callable, reference callable) of every shared public
    function and every public method both classes define or inherit."""
    out = []
    for tname, rname in _module_pairs():
        tmod = importlib.import_module(tname)
        rmod = importlib.import_module(rname)
        for name, tobj in _public(tmod, tname):
            robj = getattr(rmod, name, None)
            if robj is None:
                continue
            label = f"{tname[len('paddle_tpu_torch.'):]}.{name}"
            if inspect.isfunction(tobj) and inspect.isfunction(robj):
                out.append((label, tobj, robj))
            elif inspect.isclass(tobj) and inspect.isclass(robj):
                for mname, tm in _methods(tobj):
                    rm = getattr(robj, mname, None)
                    if rm is None or not callable(rm):
                        continue
                    if isinstance(inspect.getattr_static(robj, mname),
                                  property):
                        continue
                    if mname == "__init__" and rm is object.__init__:
                        continue
                    # a class or static method compares unbound, as
                    # ``_methods`` gives the port's
                    static = inspect.getattr_static(robj, mname)
                    if isinstance(static, (staticmethod, classmethod)):
                        rm = static.__func__
                    out.append((f"{label}.{mname}", tm, rm))
    return out


CALLABLES = _callables()


def _norm_default(d):
    if d is P.empty or d is None or isinstance(d, (bool, int, float, str)):
        return d
    if isinstance(d, torch.dtype):
        return str(d).replace("torch.", "")
    try:
        return np.dtype(d).name
    except TypeError:
        return repr(d)


def _positional(fn):
    return [(p.name, _norm_default(p.default))
            for p in inspect.signature(fn).parameters.values()
            if p.kind in POSITIONAL]


def test_the_walk_covers_the_shared_surface():
    labels = {c[0] for c in CALLABLES}
    assert len(CALLABLES) >= 120
    for must in ("inference.continuous_batching.ContinuousBatcher.__init__",
                 "models.kv_cache.create_paged_cache",
                 "models.llama.LlamaForCausalLM.generate_paged",
                 "nn.norm.RMSNorm.__init__", "nn.common.Linear.__init__",
                 "optimizer.optimizers.AdamW.__init__",
                 "ops.loss_ops.cross_entropy", "jit.TrainStep.__init__",
                 "distributed.overlap.ag_matmul",
                 "distributed.overlap.zero_prefetch",
                 "distributed.mp_layers.ColumnParallelLinear.__init__",
                 "distributed.mp_layers.ParallelCrossEntropy.forward",
                 "distributed.sequence_parallel.ulysses_attention",
                 "distributed.tensor_parallel.TensorParallel.__init__",
                 "models.llama.apply_llama_tensor_parallel",
                 "models.llama.llama_sharding_plan"):
        assert must in labels, must


@pytest.mark.parametrize("label,port,ref", CALLABLES,
                         ids=[c[0] for c in CALLABLES])
def test_positional_parameters_match_the_reference(label, port, ref):
    got, want = _positional(port), _positional(ref)
    assert got == want, (
        f"{label}: port {got}\n  reference {want} (port-only parameters "
        f"must be keyword-only)")


def _tiny_llama():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    return LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")


def _cases():
    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.nn.common import Embedding, Linear
    from paddle_tpu_torch.nn.norm import RMSNorm
    from paddle_tpu_torch.ops import loss_ops
    from paddle_tpu_torch.optimizer import AdamW

    kw = dict(dtype=torch.float32, device="cpu")
    x = torch.zeros((2, 4))
    lab = torch.zeros((2,), dtype=torch.long)

    def step(**k):
        def go():
            m = Linear(4, 4, **kw)
            opt = AdamW(parameters=m.parameters())
            return TrainStep(m, lambda o, t: o.sum(), opt, **k)
        return go

    return {
        "RMSNorm.weight_attr": (lambda: RMSNorm(4, 1e-6, "w", **kw),
                                "weight_attr"),
        "Linear.weight_attr": (lambda: Linear(4, 4, "w", **kw),
                               "weight_attr"),
        "Linear.bias_attr": (lambda: Linear(4, 4, None, "b", **kw),
                             "bias_attr"),
        "Embedding.padding_idx": (lambda: Embedding(8, 4, 0, **kw),
                                  "padding_idx"),
        "Embedding.sparse": (lambda: Embedding(8, 4, None, True, **kw),
                             "sparse"),
        "AdamW.lr_ratio": (lambda: AdamW(1e-3, 0.9, 0.999, 1e-8, [x],
                                         0.01, lambda n: 1.0),
                           "lr_ratio"),
        "cross_entropy.weight": (
            lambda: loss_ops.cross_entropy(x, lab, x[0]), "weight"),
        "cross_entropy.soft_label": (
            lambda: loss_ops.cross_entropy(x, lab, soft_label=True),
            "soft_label"),
        "cross_entropy.label_smoothing": (
            lambda: loss_ops.cross_entropy(x, lab, label_smoothing=0.1),
            "label_smoothing"),
        "linear_cross_entropy.bias": (
            lambda: loss_ops.linear_cross_entropy(x, x, lab, x[0]),
            "bias"),
        "TrainStep.in_shardings": (step(in_shardings=[None]),
                                   "in_shardings"),
        "TrainStep.donate": (step(donate=False), "donate"),
        **_tp_cases(),
    }


def _tp_cases():
    """The tensor- and sequence-parallel surface's unported parameters."""
    from paddle_tpu_torch.distributed import mp_layers, overlap
    from paddle_tpu_torch.distributed import sequence_parallel as sp
    from paddle_tpu_torch.distributed.mesh import ProcessMesh
    from paddle_tpu_torch.models.llama import apply_llama_tensor_parallel

    x = torch.zeros((1, 2, 4))
    mesh = ProcessMesh(np.arange(1).reshape(1, 1), ["fsdp", "mp"])
    return {
        "ColumnParallelLinear.weight_attr": (
            lambda: mp_layers.ColumnParallelLinear(4, 4, "w"),
            "weight_attr"),
        "RowParallelLinear.fuse_matmul_bias": (
            lambda: mp_layers.RowParallelLinear(4, 4, None, True, False,
                                                True), "fuse_matmul_bias"),
        "VocabParallelEmbedding.weight_attr": (
            lambda: mp_layers.VocabParallelEmbedding(8, 4, "w"),
            "weight_attr"),
        "RowSequenceParallelLinear.input_is_parallel": (
            lambda: sp.RowSequenceParallelLinear(4, 4, None, True, False),
            "input_is_parallel"),
        "register_sequence_parallel_allreduce_hooks.accumulation_steps": (
            lambda: sp.register_sequence_parallel_allreduce_hooks(
                _tiny_llama(), 2), "accumulation_steps"),
        "matmul_ar.seq_axis": (
            lambda: overlap.matmul_ar(x, x[0], mesh, "mp", "dp", "sp"),
            "seq_axis"),
        "apply_llama_tensor_parallel.fsdp_axis": (
            lambda: apply_llama_tensor_parallel(_tiny_llama(), mesh, "mp",
                                                "fsdp"), "fsdp_axis"),
    }


CASES = sorted(_cases())


@pytest.mark.parametrize("case", CASES)
def test_unported_parameter_raises(case):
    call, name = _cases()[case]
    with pytest.raises(NotImplementedError, match=name):
        call()


def _ported_cases():
    """Reference parameters that raised until the port gained their
    feature, each with a check of what it now does (sampling and
    multi-LoRA serving; ``TrainStep``'s ``mesh``, kept as the reference
    keeps it, since data parallelism)."""
    from paddle_tpu_torch.inference import ContinuousBatcher
    from paddle_tpu_torch.models.lora import AdapterPool

    def temperature():
        m = _tiny_llama()
        ids = np.arange(1, 5, dtype=np.int32)[None]
        greedy = m.generate_paged(ids, 3)
        assert torch.equal(m.generate_paged(ids, 3, 16, 0.7, 1, None, 0),
                           greedy)
        out = m.generate_paged(ids, 3, 16, 0.7, None, 0.9, 3)
        assert out.shape == greedy.shape

    def lora_max_rank():
        eng = ContinuousBatcher(_tiny_llama(), lora=True, lora_max_rank=8)
        assert eng._adapters.max_rank == 8

    def lora_hbm_adapters():
        eng = ContinuousBatcher(_tiny_llama(), lora=True,
                                lora_hbm_adapters=2, unified_arena=False)
        assert eng._adapters.hbm_slots == 2

    def adapter_pool():
        m = _tiny_llama()
        with pytest.raises(ValueError, match="needs lora serving"):
            ContinuousBatcher(m, adapter_pool=AdapterPool(m, 2, 2))
        pool = AdapterPool(m, 2, 2)
        assert ContinuousBatcher(m, lora=True,
                                 adapter_pool=pool)._adapters is pool

    def adapter_id():
        with pytest.raises(ValueError, match="needs lora serving"):
            ContinuousBatcher(_tiny_llama()).submit([1, 2], 2, adapter_id=3)
        with pytest.raises(ValueError, match="not registered"):
            ContinuousBatcher(_tiny_llama(), lora=True).submit(
                [1, 2], 2, adapter_id=3)

    def train_step_mesh():
        from paddle_tpu_torch.jit import TrainStep
        from paddle_tpu_torch.nn.common import Linear
        from paddle_tpu_torch.optimizer import AdamW

        m = Linear(4, 4, dtype=torch.float32, device="cpu")
        mesh = object()
        step = TrainStep(m, lambda o, t: o.sum(), AdamW(
            parameters=m.parameters()), mesh=mesh)
        assert step.mesh is mesh and step._plan is None

    return {"TrainStep.mesh": train_step_mesh,
            "generate_paged.temperature": temperature,
            "ContinuousBatcher.lora_max_rank": lora_max_rank,
            "ContinuousBatcher.lora_hbm_adapters": lora_hbm_adapters,
            "ContinuousBatcher.adapter_pool": adapter_pool,
            "ContinuousBatcher.submit.adapter_id": adapter_id}


@pytest.mark.parametrize("case", sorted(_ported_cases()))
def test_ported_parameter_is_served(case):
    _ported_cases()[case]()
