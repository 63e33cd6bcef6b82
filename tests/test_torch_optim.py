"""The port's last optimizer leftovers against optax through the JAX
package's ``build_optimizer``: ``type='SGD'`` (momentum, not Nesterov) and
``policy='fixed'``, with and without the grad clip and the frozen stem.

Tolerance: 1e-6 absolute on every parameter and on the SGD trace after
each of 3 steps (the same fp32 operations on both sides); the SGD state's
save and restore through ``train/state.py`` is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cnrma_torch.train import optim as topt
from cnrma_torch.train.state import TrainState, load_checkpoint, \
    save_checkpoint
from cnrma_tpu.train import optim as jopt
from _torch_threads import _few_threads  # noqa: F401

SHAPES = {"tower2d/resnet/stem/conv/kernel": (3, 4),
          "tower2d/fuse/p2_head0/conv/kernel": (5,),
          "detector/head/cls_bias": (2, 3)}
STEM = "tower2d.resnet.stem.conv.kernel"


def _tree(flat):
    out = {}
    for k, v in flat.items():
        node = out
        *mods, leaf = k.split("/")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return out


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_trace(state):
    """The SGD trace inside optax's chain state, as flat leaves."""
    found = []

    def visit(node):
        if isinstance(node, optax.TraceState):
            found.append(node.trace)
        elif isinstance(node, (tuple, list)):
            for x in node:
                visit(x)
        elif isinstance(node, dict):
            for x in node.values():
                visit(x)
        elif hasattr(node, "inner_states"):
            visit(node.inner_states)
        elif hasattr(node, "inner_state"):
            visit(node.inner_state)
    visit(state)
    assert len(found) == 1
    return {k: v for k, v in _flat(found[0]).items()
            if v.shape != ()}          # a frozen leaf is a masked node


def _module(params):
    model = torch.nn.Module()
    for k, v in params.items():
        node = model
        *mods, leaf = k.split("/")
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, torch.nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, torch.nn.Parameter(
            torch.from_numpy(v.copy())))
    return model


def test_fixed_policy_matches_optax():
    want = jopt.build_lr_schedule({"policy": "fixed"}, 3e-3, 5)
    got = topt.build_lr_schedule({"policy": "fixed", "step": [1]}, 3e-3, 5)
    for count in range(12):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-7)
    with pytest.raises(ValueError):
        topt.build_lr_schedule({"policy": "cosine"}, 1e-3, 1)


@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("policy", ["fixed", "step"])
def test_sgd_matches_optax(clip, frozen, policy):
    """Three SGD steps (momentum 0.8) from the same leaves and gradients:
    the parameters and the trace within 1e-6; the clip is active in steps
    1 and 3; a frozen stem keeps its value and has no trace; the step
    schedule drops the rate for step 3."""
    rng = np.random.RandomState(11)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = {"type": "SGD", "lr": 1e-2, "momentum": 0.8, "weight_decay": 0.5}
    schedule = {"policy": policy, "step": [1], "gamma": 0.5}
    prefixes = jopt.FROZEN_PREFIXES_FREEZE_AT_2 if frozen else ()
    jtx = jopt.build_optimizer(cfg, jopt.build_lr_schedule(schedule, 1e-2, 2),
                               grad_clip=clip, params=_tree(params),
                               frozen_prefixes=prefixes)
    jparams = _tree(params)
    jstate = jtx.init(jparams)
    model = _module(params)
    opt = topt.build_optimizer(
        cfg, model, topt.build_lr_schedule(schedule, 1e-2, 2),
        grad_clip=clip,
        frozen_prefixes=topt.FROZEN_PREFIXES_FREEZE_AT_2 if frozen else ())
    assert opt.kind == "sgd" and opt.momentum == 0.8
    assert set(opt.state_dict()) == {"count", "trace"}
    named = dict(model.named_parameters())
    for scale in (3.0, 0.01, 2.0):
        grads = {k: (rng.randn(*s) * scale).astype(np.float32)
                 for k, s in SHAPES.items()}
        upd, jstate = jtx.update(_tree(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        opt.step({k.replace("/", "."): torch.from_numpy(v)
                  for k, v in grads.items()})
        for k, v in _flat(jparams).items():
            np.testing.assert_allclose(
                named[k.replace("/", ".")].detach().numpy(), v, atol=1e-6,
                rtol=0, err_msg=k)
        trace = _jax_trace(jstate)
        assert set(trace) == {k for k in SHAPES
                              if not (frozen and "stem" in k)}
        assert {k.replace(".", "/") for k in opt.trace} == set(trace)
        for k, v in trace.items():
            np.testing.assert_allclose(opt.trace[k.replace("/", ".")].numpy(),
                                       v, atol=1e-6, rtol=0, err_msg=k)
    if frozen:
        np.testing.assert_array_equal(
            named[STEM].detach().numpy(),
            params["tower2d/resnet/stem/conv/kernel"])


def test_sgd_state_survives_a_checkpoint(tmp_path):
    """The SGD trace and count go through ``save_checkpoint`` and
    ``load_checkpoint`` exactly, and the restored optimizer's next step
    equals the uninterrupted one; an Adam checkpoint does not load into
    SGD."""
    rng = np.random.RandomState(12)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    cfg = {"type": "SGD", "lr": 1e-2}
    sched = topt.build_lr_schedule({"policy": "fixed"}, 1e-2, 1)
    grads = [{k.replace("/", "."): torch.from_numpy(
        rng.randn(*s).astype(np.float32)) for k, s in SHAPES.items()}
        for _ in range(3)]
    model = _module(params)
    frozen = topt.FROZEN_PREFIXES_FREEZE_AT_2
    opt = topt.build_optimizer(cfg, model, sched, grad_clip=10,
                               frozen_prefixes=frozen)
    for g in grads[:2]:
        opt.step(g)
    path = save_checkpoint(str(tmp_path / "sgd.pt"),
                           TrainState(model, opt, step=2, epoch=1))
    fresh = _module(params)
    restored = TrainState(fresh, topt.build_optimizer(
        cfg, fresh, sched, grad_clip=10, frozen_prefixes=frozen))
    load_checkpoint(path, restored)
    assert restored.step == 2 and restored.optimizer.count == 2
    assert set(restored.optimizer.trace) == set(opt.trace) and len(
        opt.trace) == 2
    for n, t in opt.trace.items():
        assert torch.equal(restored.optimizer.trace[n], t)
    opt.step(grads[2])
    restored.optimizer.step(grads[2])
    for (n, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), n

    adam = topt.build_optimizer({"type": "AdamW"}, model, sched)
    adam_path = save_checkpoint(str(tmp_path / "adam.pt"),
                                TrainState(model, adam))
    with pytest.raises(KeyError, match="trace"):
        load_checkpoint(adam_path, restored)
