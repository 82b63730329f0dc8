"""The port's Mixture-of-Experts FFN (``models/moe.py``) against the
reference's on the same parameters and inputs (numpy, from a seed), on
the reduced granite-moe-1b-a400m (d 256, 4 experts, top-2, d_ff 512,
f32).

Held: the output, both aux losses, and the gradients of the output
(against a fixed cotangent) plus the aux losses with respect to x and
the router, each within 2e-6 of the largest magnitude of the
reference's tensor (f32: the packages' matmuls sum 256 and 512 products
in different orders; the largest difference seen is 1.08e-6 of it); the
routing - each assignment's expert and whether it drops - equal to the
reference's.  The cases: the three
scenarios of the reference's own tests (tests/test_mamba_moe.py), a
capacity factor that drops assignments, ``moe_group`` small enough that
the tokens span several groups, and a router with two equal columns, so
that every token ties and ``jax.lax.top_k``'s order (the lower expert
first) decides.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = 2e-6


def _close(got, want):
    """Within TOL of the largest magnitude of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1.0))


def _cfgs(**kw):
    return (dataclasses.replace(jget_config("granite-moe-1b-a400m").reduced(),
                                **kw),
            dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                                **kw))


def _params(jcfg, seed, tie=False):
    """The reference's ``moe_init`` params (numpy) and the port's MoE
    holding them; ``tie`` copies router column 0 into column 1."""
    p, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = {k: np.array(v) for k, v in p.items()}
    if tie:
        p["router"][:, 1] = p["router"][:, 0]
    tm = moe.MoE(jcfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, val in p.items():
            getattr(tm, name).copy_(torch.from_numpy(val))
    return p, tm


def _ref_routing(p, x, cfg):
    """The reference's routing (``moe_apply``'s lines up to ``keep``):
    (top-k expert indices, keep) a (group, token, choice)."""
    b, s, d = x.shape
    t = b * s
    auto = cfg.moe_group or min(jmoe.GROUP_SIZE, 4 * max(cfg.d_ff, 128))
    g = min(auto, t)
    while t % g:
        g //= 2
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = max(int(np.ceil(g / e * cfg.capacity_factor * k)), k)
    @jax.jit
    def routing(xx, router):
        logits = jnp.einsum("Ntd,de->Nte", xx.reshape(t // g, g, d), router)
        _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
        oh = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t // g, g * k,
                                                             e)
        pos = jnp.max(jnp.cumsum(oh, axis=1) * oh - 1, axis=-1)
        return idx, pos.reshape(idx.shape) < cap

    idx, keep = routing(jnp.asarray(x), jnp.asarray(p["router"]))
    return np.asarray(idx), np.asarray(keep)


def _compare(jcfg, tcfg, p, tm, x, seed=0):
    """Out, aux, routing and gradients of both packages; returns the
    port's (out, aux, routing)."""
    cot = np.random.default_rng(seed + 100).standard_normal(
        x.shape).astype(np.float32)

    def jloss(xx, router):
        out, aux = jmoe.moe_apply(dict(p, router=router), xx, jcfg)
        return (jnp.sum(out * cot) + aux["load_balance"] + aux["router_z"],
                (out, aux))

    (_, (jout, jaux)), (gx, grouter) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jnp.asarray(x),
                                              jnp.asarray(p["router"]))
    xt = torch.from_numpy(x).requires_grad_(True)
    routing = moe.route(tm, xt, tcfg)
    out, aux = moe.moe_apply(tm, xt, tcfg, routing=routing)
    (torch.sum(out * torch.from_numpy(cot)) + aux["load_balance"]
     + aux["router_z"]).backward()
    _close(out.detach().numpy(), jout)
    for key in ("load_balance", "router_z"):
        _close(float(aux[key].detach()), float(jaux[key]))
    _close(xt.grad.numpy(), gx)
    _close(tm.router.grad.numpy(), grouter)
    idx, keep = _ref_routing(p, x, jcfg)
    np.testing.assert_array_equal(routing["idx"].numpy(), idx)
    np.testing.assert_array_equal(routing["keep"].numpy(), keep)
    return out.detach().numpy(), aux, routing


def _x(seed, b, s, d):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def test_output_finite_and_weighted():
    """tests/test_mamba_moe.py::test_moe_output_finite_and_weighted on
    both packages."""
    jcfg, tcfg = _cfgs()
    p, tm = _params(jcfg, 0)
    out, aux, _ = _compare(jcfg, tcfg, p, tm, _x(0, 2, 16, jcfg.d_model))
    assert np.isfinite(out).all() and float(aux["load_balance"].detach()) > 0


def test_capacity_drops_tokens():
    """tests/test_mamba_moe.py::test_moe_capacity_drops_tokens on both
    packages: capacity factor 0.05 against 16."""
    outs = {}
    for cf in (0.05, 16.0):
        jcfg, tcfg = _cfgs(capacity_factor=cf)
        p, tm = _params(jcfg, 1)
        outs[cf] = _compare(jcfg, tcfg, p, tm, _x(1, 2, 32, jcfg.d_model))[0]
    assert np.abs(outs[0.05]).mean() < np.abs(outs[16.0]).mean()


def test_high_capacity_is_exact_topk():
    """tests/test_mamba_moe.py::test_moe_high_capacity_is_exact_topk on
    both packages: at capacity factor 32 every token reaches its experts,
    and the port's output equals every expert run densely and combined by
    the top-k weights (numpy, 1e-3 as there)."""
    jcfg, tcfg = _cfgs(capacity_factor=32.0)
    p, tm = _params(jcfg, 2)
    s = 8
    x = _x(2, 1, s, jcfg.d_model)
    out, _, routing = _compare(jcfg, tcfg, p, tm, x)
    assert bool(routing["keep"].all())
    xt = x.reshape(s, -1)
    logits = xt @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs = probs / probs.sum(-1, keepdims=True)
    topk = np.argsort(-probs, axis=-1)[:, :jcfg.moe_top_k]
    ref = np.zeros_like(xt)
    for t in range(s):
        w = probs[t, topk[t]] / probs[t, topk[t]].sum()
        for j, e in enumerate(topk[t]):
            g = xt[t] @ p["wg"][e]
            u = xt[t] @ p["wu"][e]
            ref[t] += w[j] * (((g / (1 + np.exp(-g))) * u) @ p["wd"][e])
    np.testing.assert_allclose(out.reshape(s, -1), ref, atol=1e-3)


@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_dropping_capacity_drops_the_same_assignments(cf):
    """A capacity factor under 1: assignments drop, and the same ones in
    both packages (the slot order is token-major)."""
    jcfg, tcfg = _cfgs(capacity_factor=cf)
    p, tm = _params(jcfg, 3)
    _, _, routing = _compare(jcfg, tcfg, p, tm, _x(3, 3, 20, jcfg.d_model))
    keep = routing["keep"].numpy()
    assert 0 < (~keep).sum() < keep.size


@pytest.mark.parametrize("group", [4, 8])
def test_small_groups_span_several(group):
    """``moe_group`` under the token count: per-group capacity and aux
    over several groups (t = 40: groups of 4 or 8)."""
    jcfg, tcfg = _cfgs(moe_group=group, capacity_factor=1.0)
    p, tm = _params(jcfg, 4)
    _, _, routing = _compare(jcfg, tcfg, p, tm, _x(4, 2, 20, jcfg.d_model))
    assert routing["idx"].shape[0] == 40 // group
    assert not bool(routing["keep"].all())


def test_router_ties_break_to_the_lower_expert():
    """Router columns 0 and 1 equal: every token's probabilities of
    experts 0 and 1 tie exactly.  The top-k indices (and so the slots and
    the drops) are ``jax.lax.top_k``'s: expert 0 before expert 1, and
    expert 0 chosen where the pair straddles the k-th place."""
    jcfg, tcfg = _cfgs(capacity_factor=1.0)
    p, tm = _params(jcfg, 5, tie=True)
    _, _, routing = _compare(jcfg, tcfg, p, tm, _x(5, 2, 24, jcfg.d_model))
    probs = routing["probs"].detach().numpy()
    assert (probs[..., 0] == probs[..., 1]).all()
    idx = routing["idx"].numpy()
    both = (idx == 0).any(-1) & (idx == 1).any(-1)
    straddle = (idx == 0).any(-1) & ~(idx == 1).any(-1)
    assert both.any() and straddle.any()
    assert not ((idx == 1).any(-1) & ~(idx == 0).any(-1)).any()
