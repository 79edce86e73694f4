"""fdt_torch's MultiBox loss against fdt's (fdt/train/multibox_loss.py):
the values and their gradients (torch.autograd against jax.grad of fdt's
loss), to 1e-5 relative of the gradient's scale.

Cases: random logits; no positive prior anywhere (the empty-selection and
N == 0 rules); tied CE values, where only stable sorts pick fdt's
negatives; the bipartite matcher.
"""
import functools
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from tests.test_torch_matching import grid_priors  # noqa: E402

# the modules (each package's __init__ exports a function of the same name)
jax_loss = importlib.import_module("fdt.train.multibox_loss")
port_loss = importlib.import_module("fdt_torch.train.multibox_loss")

torch.set_num_threads(1)

TOL = 1e-5


def inputs(name: str):
    rng = np.random.RandomState(sum(map(ord, name)))
    priors = grid_priors(10)
    b, p, g = 2, len(priors), 3
    loc = rng.randn(b, p, 4).astype(np.float32)
    conf = (rng.randn(b, p, 2) * 2).astype(np.float32)
    xy = rng.rand(b, g, 2) * 0.6
    gt = np.concatenate([xy, xy + 0.1 + rng.rand(b, g, 2) * 0.3], -1).astype(np.float32)
    labels = np.zeros((b, g), np.int32)
    valid = np.ones((b, g), bool)
    valid[1, 2] = False
    if name == "no-positives":
        valid[:] = False
    elif name == "tied-ce":
        # four logit pairs only: thousands of equal CE values, so which
        # negatives fill the 3:1 quota depends on the sort's stability
        conf = rng.choice([-1.0, 0.0, 0.5, 2.0], size=(b, p, 2)).astype(np.float32)
    return loc, conf, priors, gt, labels, valid


@functools.lru_cache(maxsize=None)
def _jax_grad(cfg):
    """jax.value_and_grad of fdt's loss (+ 2 × its CE part), jitted once a
    config: the cases share their shapes."""
    def total(loc, conf, priors, gt, labels, valid):
        l_l, l_c = jax_loss.multibox_loss(loc, conf, priors, gt, labels, valid, cfg)
        return l_l + 2.0 * l_c, (l_l, l_c)
    return jax.jit(jax.value_and_grad(total, argnums=(0, 1), has_aux=True))


def both(name, cfg_kw):
    loc, conf, priors, gt, labels, valid = inputs(name)
    jcfg = jax_loss.MultiBoxLossConfig(**cfg_kw)
    pcfg = port_loss.MultiBoxLossConfig(**cfg_kw)

    (_, (jl, jc)), (gl_j, gc_j) = _jax_grad(jcfg)(jnp.asarray(loc), jnp.asarray(conf),
                                                 jnp.asarray(priors), jnp.asarray(gt),
                                                 jnp.asarray(labels), jnp.asarray(valid))
    loc_t = torch.from_numpy(loc).requires_grad_()
    conf_t = torch.from_numpy(conf).requires_grad_()
    pl, pc = port_loss.multibox_loss(loc_t, conf_t, torch.from_numpy(priors), torch.from_numpy(gt),
                                     torch.from_numpy(labels), torch.from_numpy(valid), pcfg)
    (pl + 2.0 * pc).backward()
    return ((float(pl.detach()), float(pc.detach())), (float(jl), float(jc)),
            (loc_t.grad.numpy(), conf_t.grad.numpy()), (np.asarray(gl_j), np.asarray(gc_j)))


@pytest.mark.parametrize("name", ["random", "no-positives", "tied-ce"])
@pytest.mark.parametrize("bipartite", [False, True], ids=["default", "bipartite"])
def test_loss_and_gradients_match_fdt(name, bipartite):
    got, want, grads, jgrads = both(name, {"bipartite": bipartite})
    np.testing.assert_allclose(got, want, rtol=TOL)
    for g, j in zip(grads, jgrads):
        np.testing.assert_allclose(g, j, rtol=0, atol=TOL * max(np.abs(j).max(), 1e-12))
    if name == "no-positives":
        # no positive: N = batch size; the negatives' CE is still selected
        assert got[0] == 0.0 and got[1] > 0


def test_empty_selection_gives_ten():
    """No positive and P - 1 = 0 negatives allowed: nothing is selected, so
    loss_c = 10 with N = 1, as fdt's rule says."""
    loc = torch.zeros(1, 1, 4, requires_grad=True)
    conf = torch.zeros(1, 1, 2, requires_grad=True)
    l_l, l_c = port_loss.multibox_loss_from_targets(loc, conf, torch.zeros(1, 1, 4),
                                                    torch.zeros(1, 1, dtype=torch.long))
    jl, jc = jax_loss.multibox_loss_from_targets(jnp.zeros((1, 1, 4)), jnp.zeros((1, 1, 2)),
                                                 jnp.zeros((1, 1, 4)), jnp.zeros((1, 1), jnp.int32))
    assert (float(l_l.detach()), float(l_c.detach())) == (float(jl), float(jc)) == (0.0, 10.0)


def test_no_gradient_reaches_the_targets():
    """loc_t enters detached, as fdt's stop_gradient: a target tensor that
    records gradients gets none."""
    loc = torch.randn(1, 5, 4, requires_grad=True)
    conf = torch.randn(1, 5, 2, requires_grad=True)
    loc_t = torch.randn(1, 5, 4, requires_grad=True)
    l_l, l_c = port_loss.multibox_loss_from_targets(loc, conf, loc_t,
                                                    torch.tensor([[1, 0, 0, 1, 0]]))
    (l_l + l_c).backward()
    assert loc_t.grad is None and loc.grad is not None
