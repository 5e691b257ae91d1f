"""The port's AggregaThor step against the JAX package, piece by piece.

  - the folded attack+GAR path equals the port's where-path and the JAX
    package's fold, on the same stacked gradient tree;
  - with the same weights and batches, the per-slot gradients and BN
    statistics of a small ResNet match the JAX unroll;
  - a 3-step median+lie trajectory of ``make_trainer`` matches
    ``garfield_tpu.parallel.aggregathor.make_trainer``;
  - the optimizer matches the JAX package's optax chain;
  - options outside the port's first slice raise.

Inputs are made from seeds with numpy and handed to both packages; leaves
are compared one by one through ``models.convert`` (the two packages order
and lay out leaves differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from garfield_tpu.aggregators import gars as jax_gars
from garfield_tpu.attacks import (
    plan_gradient_attack_fold as jax_plan_fold,
)
from garfield_tpu.models.resnet import BasicBlock as JaxBasicBlock
from garfield_tpu.models.resnet import ResNet as JaxResNet
from garfield_tpu.parallel import aggregathor as jax_aggregathor
from garfield_tpu.parallel import core as jax_core
from garfield_tpu.parallel import mesh as jax_mesh
from garfield_tpu.parallel.fold import (
    folded_tree_aggregate as jax_folded_tree_aggregate,
)
from garfield_tpu.utils import selectors as jax_selectors
from garfield_tpu_torch import aggregators
from garfield_tpu_torch.attacks import (
    apply_gradient_attack_tree,
    plan_gradient_attack_fold,
)
from garfield_tpu_torch.models import convert
from garfield_tpu_torch.models.resnet import BasicBlock, ResNet
from garfield_tpu_torch.parallel import aggregathor, core
from garfield_tpu_torch.parallel.fold import folded_tree_aggregate
from garfield_tpu_torch.utils import selectors

N, F = 8, 2
BATCH, SIDE = 2, 16
LR, MOMENTUM, WD = 0.2, 0.9, 5e-4


def _tree(seed, n=N):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((n, 5, 3)).astype(np.float32),
        "b": rng.standard_normal((n, 7)).astype(np.float32),
        "s": rng.standard_normal((n, 1)).astype(np.float32),
    }


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


# --- the fold ----------------------------------------------------------------


@pytest.mark.parametrize("gar_name", ["median", "tmean"])
@pytest.mark.parametrize("attack", ["lie", "empire", "reverse", "crash"])
def test_fold_matches_where_path_and_jax_fold(gar_name, attack):
    tree = _tree(3)
    mask = core.default_byz_mask(N, F)
    gar = aggregators.gars[gar_name]
    plan = plan_gradient_attack_fold(attack, mask)
    folded = folded_tree_aggregate(gar, plan, _torch_tree(tree), f=F)
    where = gar.tree_aggregate(
        apply_gradient_attack_tree(attack, _torch_tree(tree), mask), f=F
    )
    jax_out = jax_folded_tree_aggregate(
        jax_gars[gar_name], jax_plan_fold(attack, mask),
        {k: jnp.asarray(v) for k, v in tree.items()}, f=F,
    )
    for k in tree:
        # Fold vs where-path (both the port): the fake row's f32 moments
        # are summed over the f gathered rows on one side and over all n
        # masked rows on the other, which may differ in the last ulp.
        np.testing.assert_allclose(folded[k].numpy(), where[k].numpy(),
                                   rtol=1e-6, atol=1e-7)
        want = np.asarray(jax_out[k])
        if gar_name == "median":
            # Selection over the same values: bitwise.
            np.testing.assert_array_equal(folded[k].numpy(), want)
        else:
            # The JAX package's XLA path (no TPU here) averages with
            # jnp.mean, the port with the kernel's sequential chain.
            np.testing.assert_allclose(folded[k].numpy(), want,
                                       rtol=1e-6, atol=1e-7)


def test_fold_raises_for_gram_rules():
    class GramRule:
        name = "krum"
        tree_aggregate_ext = None

    plan = plan_gradient_attack_fold("lie", core.default_byz_mask(N, F))
    with pytest.raises(NotImplementedError, match="Gram branch"):
        folded_tree_aggregate(GramRule(), plan, _torch_tree(_tree(0)), f=F)


def test_plan_is_none_without_byzantine_slots():
    assert plan_gradient_attack_fold("lie", np.zeros(N, bool)) is None
    assert plan_gradient_attack_fold(None, core.default_byz_mask(N, F)) is None


# --- the model and per-worker gradients ---------------------------------------


def _models(seed=0):
    """The JAX ResNet(BasicBlock, (1, 1)) and the port's twin carrying the
    same weights and BN statistics."""
    jm = JaxResNet(JaxBasicBlock, (1, 1))
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, SIDE, SIDE, 3)), train=False)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    tm = ResNet(BasicBlock, (1, 1))
    tm.load_state_dict(convert.from_flax(variables["params"],
                                         variables["batch_stats"]))
    return jm, variables, tm


def _batches(seed, steps=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((steps, N, BATCH, SIDE, SIDE, 3)).astype(np.float32)
    y = rng.integers(0, 10, (steps, N, BATCH)).astype(np.int32)
    return x, y


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def test_convert_round_trip():
    _, variables, tm = _models()
    back = convert.to_flax_layout(tm.state_dict())
    flat_a = jax.tree_util.tree_leaves_with_path(variables)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_per_slot_grads_match_jax_unroll():
    jm, variables, tm = _models(seed=1)
    x, y = _batches(seed=2)
    loss = "cross-entropy"
    _, jax_grad_fn, _ = jax_core.make_worker_fns(
        jm, jax_selectors.select_loss(loss))
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    jgrads, (jloss, jms) = jax_core.per_slot_grads(
        jax_grad_fn, variables["params"],
        {"batch_stats": variables["batch_stats"]},
        jnp.asarray(x[0]), jnp.asarray(y[0]), keys, force_unroll=True,
    )
    _, grad_fn, _ = core.make_worker_fns(tm, selectors.select_loss(loss))
    xt = torch.from_numpy(x[0]).permute(0, 1, 4, 2, 3).contiguous()
    grads, (losses, stacked_ms) = core.per_slot_grads(
        grad_fn, xt, torch.from_numpy(y[0]))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jloss), rtol=1e-6)
    got = convert.to_flax_layout({**grads, **stacked_ms}, stacked=True)
    want = {"params": jgrads, "batch_stats": jms["batch_stats"]}
    pairs = zip(jax.tree_util.tree_leaves_with_path(want),
                jax.tree_util.tree_leaves_with_path(got))
    count = 0
    for (pa, a), (pb, b) in pairs:
        assert pa == pb
        # f32 conv and BN reductions in another order (XLA:CPU vs torch):
        # rounding-level differences, 1e-5 relative L2 per slot and leaf.
        for k in range(N):
            assert _rel_l2(np.asarray(a)[k], b[k]) <= 1e-5, (pa, k)
        count += 1
    assert count == 32  # 20 parameter leaves + 6 BN layers' 12 statistics


# --- the trainer ----------------------------------------------------------------


def test_three_step_median_lie_trajectory_matches_jax(monkeypatch):
    """Params and BN statistics after each of 3 steps, leaf by leaf.

    Tolerance |port - jax| <= 1e-5 + 1e-3 |jax| per element: XLA:CPU and
    torch reassociate the f32 conv and BN reductions differently (per-slot
    gradients agree to ~1e-6 relative), and three SGD steps at lr 0.2 with
    momentum 0.9 carry that drift; the median itself is a selection and
    adds none. Measured worst case about 5e-6 absolute."""
    monkeypatch.setenv("GARFIELD_NO_SLOTFUSED", "1")
    jm = JaxResNet(JaxBasicBlock, (1, 1))
    tm = ResNet(BasicBlock, (1, 1))
    xs, ys = _batches(seed=4, steps=3)
    mesh = jax_mesh.make_mesh({"workers": 1}, devices=jax.devices()[:1])
    jinit, jstep, _ = jax_aggregathor.make_trainer(
        jm, jax_selectors.select_loss("cross-entropy"),
        jax_selectors.select_optimizer("sgd", lr=LR, momentum=MOMENTUM,
                                       weight_decay=WD),
        "median", num_workers=N, f=F, attack="lie", mesh=mesh,
    )
    jstate = jinit(jax.random.PRNGKey(3), xs[0, 0])
    tinit, tstep, _ = aggregathor.make_trainer(
        tm, selectors.select_loss("cross-entropy"),
        selectors.select_optimizer("sgd", lr=LR, momentum=MOMENTUM,
                                   weight_decay=WD),
        "median", num_workers=N, f=F, attack="lie", device="cpu",
    )
    tstate = tinit(0)
    tm.load_state_dict(convert.from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.model_state["batch_stats"]),
    ))
    for s in range(3):
        jstate, jmet = jstep(jstate, jnp.asarray(xs[s]), jnp.asarray(ys[s]))
        tstate, tmet = tstep(tstate, xs[s], ys[s])
        assert tstate.step == s + 1
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        want = {
            "params": jax.tree_util.tree_map(np.asarray, jstate.params),
            "batch_stats": jax.tree_util.tree_map(
                np.asarray, jstate.model_state["batch_stats"]),
        }
        got = convert.to_flax_layout(tm.state_dict())
        for (pa, a), (pb, b) in zip(
            jax.tree_util.tree_leaves_with_path(want),
            jax.tree_util.tree_leaves_with_path(got),
        ):
            assert pa == pb
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5,
                                       err_msg=f"step {s} {pa}")


def test_sgd_matches_optax_chain():
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal(64).astype(np.float32)
    grads = rng.standard_normal((3, 64)).astype(np.float32)
    tx = jax_selectors.select_optimizer("sgd", lr=LR, momentum=MOMENTUM,
                                        weight_decay=WD)
    pj = jnp.asarray(p0)
    opt_state = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = selectors.select_optimizer("sgd", lr=LR, momentum=MOMENTUM,
                                     weight_decay=WD)([pt])
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
        pj = pj + upd
        pt.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                                   rtol=1e-6, atol=1e-7)


def test_where_path_without_attack_runs_and_counts_honest_loss():
    """No attack: no fold plan; the where-path aggregates the raw rows and
    the loss is the mean over all slots."""
    _, _, tm = _models(seed=6)
    init_fn, step_fn, eval_fn = aggregathor.make_trainer(
        tm, selectors.select_loss("cross-entropy"),
        selectors.select_optimizer("sgd", lr=0.1), "tmean",
        num_workers=N, f=1, device="cpu",
    )
    state = init_fn(7)
    before = {k: v.detach().clone() for k, v in state.params.items()}
    xs, ys = _batches(seed=8)
    state, metrics = step_fn(state, xs[0], ys[0])
    assert np.isfinite(float(metrics["loss"]))
    assert any(not torch.equal(before[k], v) for k, v in state.params.items())
    logits = eval_fn(state, xs[0, 0])
    assert logits.shape == (BATCH, 10)


def _tiny_trainer(**kwargs):
    args = dict(num_workers=N, f=F, attack="lie", device="cpu")
    args.update(kwargs)
    gar = args.pop("gar", "median")
    return aggregathor.make_trainer(
        ResNet(BasicBlock, (1, 1)), selectors.select_loss("cross-entropy"),
        selectors.select_optimizer("sgd", lr=0.1), gar, **args,
    )


@pytest.mark.parametrize("kwargs,match", [
    (dict(gar="krum"), "Queue A item 1"),
    (dict(gar="average"), "Queue A item 1"),
    (dict(gar="bulyan"), "Queue A item 2"),
    (dict(gar="cclip"), "Queue A item 5"),
    (dict(attack="random"), "Queue A item 6"),
    (dict(attack="drop"), "Queue A item 6"),
    (dict(attack="adaptive-lie"), "Queue A item 9"),
    (dict(subset=6), "Queue A item 6"),
    (dict(granularity="layer"), "Queue A item 6"),
    (dict(tree_path=False), "Queue A item 6"),
    (dict(worker_momentum=0.9), "Queue A item 6"),
    (dict(telemetry=True), "Queue A item 7"),
    (dict(staleness={"max_staleness": 2}), "Queue A item 9"),
    (dict(defense={"power": 1.0}), "Queue A item 9"),
    (dict(wire={"dtype": "int8"}), "Queue A item 9"),
])
def test_unported_options_raise(kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        _tiny_trainer(**kwargs)


def test_unknown_option_and_bad_rule_contract():
    with pytest.raises(TypeError, match="unexpected argument"):
        _tiny_trainer(mesh=None)
    with pytest.raises(AssertionError, match="cannot be used"):
        _tiny_trainer(gar="tmean", f=4)
    with pytest.raises(ValueError, match="unknown GAR"):
        _tiny_trainer(gar="nope")
