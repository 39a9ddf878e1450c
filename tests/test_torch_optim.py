"""The port's optimizers (`train/optim.py`, on torch.optim) against the JAX
package's optax chains (`train/optim.py::define_optim`) on a small tree:
three steps from the same parameters and the same gradients, rtol 1e-5
(f32 arithmetic in another order; adam's first steps divide small
numbers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lanedetection_end2end_tpu.train import optim as jo
from lanedetection_end2end_tpu_torch.train import optim as to
from test_torch_threads import one_torch_thread  # noqa: F401

SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}


def _run_both(name, weight_decay, clip, lr=0.05, steps=3):
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(0, 1, s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 2, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]

    tx = jo.define_optim(name, lr, weight_decay, clip)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = to.define_optim(tp.values(), name, lr, weight_decay, clip)
    for g in grads:
        opt.zero_grad()
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return tp, jp


@pytest.mark.parametrize("name,weight_decay,clip", [
    ("adam", 0.0, 0.0), ("sgd", 0.0, 0.0), ("rmsprop", 0.0, 0.0),
    ("adam", 0.01, 0.0), ("sgd", 0.01, 0.0), ("rmsprop", 0.01, 0.0),
    ("adam", 0.0, 1.0), ("sgd", 0.0, 1.0), ("adam", 0.01, 0.5),
    ("sgd", 0.0, 1e6)])
def test_optimizer_matches_optax(name, weight_decay, clip):
    tp, jp = _run_both(name, weight_decay, clip)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_unknown_optimizer_raises_like_jax():
    with pytest.raises(KeyError):  # optax builds the chain at init
        jo.define_optim("lion", 0.1).init({"a": jnp.zeros(1)})
    with pytest.raises(KeyError):
        to.define_optim([torch.nn.Parameter(torch.zeros(1))], "lion", 0.1)


def test_set_and_get_lr():
    p = torch.nn.Parameter(torch.ones(3))
    opt = to.define_optim([p], "sgd", 0.1)
    assert to.get_lr(opt) == pytest.approx(0.1)
    to.set_lr(opt, 0.01)
    assert to.get_lr(opt) == pytest.approx(0.01)
    p.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 0.99, rtol=1e-6)
