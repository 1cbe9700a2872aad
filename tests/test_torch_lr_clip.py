"""Learning-rate schedulers and gradient clipping: the port vs the JAX
package, on CPU.

  * every scheduler of ``optimizer/lr.py`` (the fifteen schedules, two
    nested in ``LinearWarmup``): its first 50 learning rates, stepped as
    ``TrainStep`` steps them, EQUAL to the JAX package's (both are pure
    Python floats over ``math``), and a ``state_dict`` taken mid-way and
    loaded into a fresh scheduler continues as the JAX package's does;
  * ``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``
    on the same f32 gradients (numpy, seeded), one parameter excluded
    with ``need_clip = False``: each clipped gradient within 1e-6
    relative of the JAX package's (the f32 norms sum in other orders),
    the excluded one untouched; ``clip_grad_norm_`` (2-norm and inf-norm)
    likewise, with its returned total;
  * the optimizer with a scheduler: ``get_lr`` reads it, ``set_lr``
    raises, ``state_dict`` carries ``LR_Scheduler``.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.framework.tensor import Parameter as JaxParameter
from paddle_tpu.optimizer import lr as jlr

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.optimizer import lr as tlr


def _schedulers(lr):
    """name -> a fresh scheduler of module ``lr`` (the same arguments for
    both packages)."""
    return {
        "NoamDecay": lambda: lr.NoamDecay(512, 10, learning_rate=2.0),
        "PiecewiseDecay": lambda: lr.PiecewiseDecay([5, 17], [0.1, 0.05,
                                                               0.01]),
        "NaturalExpDecay": lambda: lr.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lambda: lr.InverseTimeDecay(0.5, 0.3),
        "PolynomialDecay": lambda: lr.PolynomialDecay(0.1, 20, power=2.0),
        "PolynomialDecay_cycle": lambda: lr.PolynomialDecay(
            0.1, 7, end_lr=0.01, cycle=True),
        "LinearWarmup_float": lambda: lr.LinearWarmup(0.1, 8, 0.0, 0.1),
        "LinearWarmup_cosine": lambda: lr.LinearWarmup(
            lr.CosineAnnealingDecay(1e-4, T_max=30), 2, 1e-5, 1e-4),
        "ExponentialDecay": lambda: lr.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lambda: lr.MultiStepDecay(0.5, [3, 11, 30], 0.5),
        "StepDecay": lambda: lr.StepDecay(0.5, 7, 0.3),
        "LambdaDecay": lambda: lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "ReduceOnPlateau": lambda: lr.ReduceOnPlateau(0.5, patience=2,
                                                      cooldown=1),
        "CosineAnnealingDecay": lambda: lr.CosineAnnealingDecay(0.3, 13,
                                                                0.01),
        "CosineAnnealingWarmRestarts": lambda: lr.CosineAnnealingWarmRestarts(
            0.3, 5, T_mult=2, eta_min=0.01),
        "OneCycleLR": lambda: lr.OneCycleLR(0.5, 40),
        "CyclicLR": lambda: lr.CyclicLR(0.01, 0.1, 4, 6,
                                        mode="triangular2"),
    }


def _run(sched, n, start=0):
    """n learning rates, read before each step as ``TrainStep`` reads them
    (``ReduceOnPlateau`` steps on a metric that stalls in places)."""
    out = []
    for i in range(start, start + n):
        out.append(sched())
        if isinstance(sched, (jlr.ReduceOnPlateau, tlr.ReduceOnPlateau)):
            sched.step(float(10 - min(i, 4) + (i % 3 == 0) * 0.5))
        else:
            sched.step()
    return out


def test_every_scheduler_is_covered():
    names = {n for n, c in vars(tlr).items()
             if isinstance(c, type) and issubclass(c, tlr.LRScheduler)}
    assert names == {n for n, c in vars(jlr).items()
                     if isinstance(c, type) and issubclass(c, jlr.LRScheduler)}
    assert len(names) == 16
    covered = {type(f()).__name__ for f in _schedulers(tlr).values()}
    assert covered | {"LRScheduler"} == names


@pytest.mark.parametrize("name", sorted(_schedulers(tlr)))
def test_scheduler_matches_jax_exactly(name):
    jsched, tsched = _schedulers(jlr)[name](), _schedulers(tlr)[name]()
    got, want = _run(tsched, 50), _run(jsched, 50)
    assert got == want
    assert all(isinstance(x, float) for x in got)
    # state_dict round trip mid-way: a fresh scheduler continues the run
    t2, j2 = _schedulers(tlr)[name](), _schedulers(jlr)[name]()
    _run(t2, 20)
    _run(j2, 20)
    fresh, j_fresh = _schedulers(tlr)[name](), _schedulers(jlr)[name]()
    fresh.set_state_dict(t2.state_dict())
    j_fresh.set_state_dict(j2.state_dict())
    assert fresh.state_dict() == t2.state_dict() == j2.state_dict()
    assert _run(fresh, 30, 20) == _run(j_fresh, 30, 20)


def _grads(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * sc
            for s, sc in (((7, 5), 3.0), ((11,), 0.2), ((4, 4, 3), 1.0),
                          ((2, 9), 5.0))]


def _jax_pairs(grads, exclude):
    out = []
    for i, g in enumerate(grads):
        p = JaxParameter(jnp.zeros(g.shape, jnp.float32))
        p.need_clip = i != exclude
        out.append((p, paddle.to_tensor(g)))
    return out


def _torch_pairs(grads, exclude):
    out = []
    for i, g in enumerate(grads):
        p = torch.nn.Parameter(torch.zeros(g.shape))
        if i == exclude:
            p.need_clip = False
        out.append((p, torch.tensor(g)))
    return out


@pytest.mark.parametrize("kind,arg", [
    ("ClipGradByValue", (0.7,)), ("ClipGradByValue", (0.7, -0.2)),
    ("ClipGradByNorm", (1.5,)), ("ClipGradByNorm", (100.0,)),
    ("ClipGradByGlobalNorm", (1.0,)), ("ClipGradByGlobalNorm", (1e3,))])
def test_clip_matches_jax(kind, arg):
    grads = _grads()
    exclude = 2
    want = [np.asarray(g._array) for _, g in
            getattr(jnn, kind)(*arg)(_jax_pairs(grads, exclude))]
    clip = getattr(tnn, kind)(*arg)
    got = [g.numpy() for _, g in clip(_torch_pairs(grads, exclude))]
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7, err_msg=i)
    np.testing.assert_array_equal(got[exclude], grads[exclude])
    if kind == "ClipGradByGlobalNorm":
        kept = [g for i, g in enumerate(grads) if i != exclude]
        norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in kept))
        assert clip.last_global_norm.item() == pytest.approx(norm,
                                                             rel=1e-6)


@pytest.mark.parametrize("norm_type", [2.0, float("inf")])
@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clip_grad_norm_matches_jax(norm_type, max_norm):
    grads = _grads(1)
    jps, tps = [], []
    for g in grads:
        jp = JaxParameter(jnp.zeros(g.shape, jnp.float32))
        jp.grad = paddle.to_tensor(g)
        jps.append(jp)
        tp = torch.nn.Parameter(torch.zeros(g.shape))
        tp.grad = torch.tensor(g)
        tps.append(tp)
    jt = jnn.clip_grad_norm_(jps, max_norm, norm_type)
    tt = tnn.clip_grad_norm_(tps, max_norm, norm_type)
    np.testing.assert_allclose(tt.item(), float(np.asarray(jt._array)),
                               rtol=1e-6)
    for jp, tp in zip(jps, tps):
        np.testing.assert_allclose(tp.grad.numpy(),
                                   np.asarray(jp.grad._array), rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_with_a_scheduler():
    sched = tlr.LinearWarmup(tlr.CosineAnnealingDecay(1e-3, T_max=10), 2,
                             1e-4, 1e-3)
    p = torch.nn.Parameter(torch.ones(3))
    opt = topt.AdamW(learning_rate=sched, parameters=[("w", p)],
                     grad_clip=tnn.ClipGradByGlobalNorm(1.0))
    assert opt.get_lr() == sched() == 1e-4
    with pytest.raises(RuntimeError):
        opt.set_lr(0.1)
    p.grad = torch.full((3,), 10.0)
    opt.step()
    sched.step()
    assert opt.get_lr() == sched()
    sd = opt.state_dict()
    assert sd["LR_Scheduler"] == sched.state_dict()
    assert sd["global_step"] == 1 and "w.moment1" in sd
    other = topt.AdamW(learning_rate=tlr.LinearWarmup(
        tlr.CosineAnnealingDecay(1e-3, T_max=10), 2, 1e-4, 1e-3),
        parameters=[("w", p)])
    other.set_state_dict(sd)
    assert other.get_lr() == opt.get_lr()
    assert torch.equal(other.state()["w"]["moment1"],
                       opt.state()["w"]["moment1"])
    with pytest.raises(TypeError):
        topt.AdamW(learning_rate="0.1", parameters=[("w", p)])
