"""The port's learned sampler and learned update rule against the JAX
package, on the same seeded numpy inputs and the same learned weights
(carried by ``convert.learned_from_numpy``), and their behavioral twins of
tests/test_learned_sampler.py and tests/test_learned_optimizer.py with the
port's own generators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccv_mppi_path_tracker_tpu import diff as jdiff
from ccv_mppi_path_tracker_tpu.core.types import RefWindow as JaxRefWindow
from ccv_mppi_path_tracker_tpu.core import ControllerState as JaxControllerState
from ccv_mppi_path_tracker_tpu.diff.learned_sampler import (
    proposal_features as jax_proposal_features,
)
from ccv_mppi_path_tracker_tpu.paths.resample import (
    resample_reference as jax_resample_reference,
)
from ccv_mppi_path_tracker_tpu_torch import diff
from ccv_mppi_path_tracker_tpu_torch.convert import learned_from_numpy
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState, RefWindow
from ccv_mppi_path_tracker_tpu_torch.diff.learned_optimizer import solved_cost
from ccv_mppi_path_tracker_tpu_torch.diff.learned_sampler import proposal_features
from ccv_mppi_path_tracker_tpu_torch.ops.softmax_update import softmax_weights
from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer, resample_reference
from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step
from test_torch_solver import Case

F64 = dict(rtol=1e-9, atol=1e-12)
GRAD = dict(rtol=1e-7, atol=1e-12)


def close(port, ref, tol=F64):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def _window(rng, T=10):
    xy = np.cumsum(rng.uniform(0.05, 0.15, (T, 2)), axis=0)
    return xy, rng.uniform(-np.pi, np.pi, T)


def test_proposal_features_match_jax():
    rng = np.random.RandomState(0)
    xy, yaw = _window(rng)
    state = np.array([0.3, -0.2, 2.9])
    got = proposal_features(torch.as_tensor(state),
                            RefWindow(torch.as_tensor(xy), torch.as_tensor(yaw)))
    ref = jax_proposal_features(jnp.asarray(state), JaxRefWindow(jnp.asarray(xy),
                                                                 jnp.asarray(yaw)))
    close(got, ref)


def test_proposal_features_invariant_to_world_pose():
    """Twin of tests/test_learned_sampler.py:22-39."""
    xy = np.stack([np.linspace(0, 1.4, 15), 0.1 * np.arange(15)], -1)
    ref = RefWindow(torch.tensor(xy, dtype=torch.float32), torch.full((15,), 0.2))
    f0 = proposal_features(torch.zeros(3), ref)
    tx, ty, a = 3.0, -2.0, 0.7
    rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    ref2 = RefWindow(torch.tensor(xy @ rot.T + [tx, ty], dtype=torch.float32),
                     torch.full((15,), 0.2 + a))
    f2 = proposal_features(torch.tensor([tx, ty, a]), ref2)
    np.testing.assert_allclose(f2.numpy(), f0.numpy(), atol=1e-5)


def _jax_rule(seed, u_dim=2, hidden=16):
    """A JAX UpdateRule away from identity: every parameter nonzero."""
    rng = np.random.RandomState(seed)
    rule = jdiff.UpdateRule.init_identity(jax.random.PRNGKey(seed), u_dim, hidden,
                                          dtype=jnp.float64)
    return jdiff.UpdateRule(w1=rule.w1, b1=jnp.asarray(rng.randn(hidden) * 0.1),
                            w2=jnp.asarray(rng.randn(hidden, 1) * 0.3),
                            b2=jnp.asarray(rng.randn(1) * 0.1),
                            log_gain=jnp.asarray(rng.randn(u_dim) * 0.2))


def test_sampler_net_and_update_rule_on_carried_weights_match_jax():
    rng = np.random.RandomState(1)
    jnet = jdiff.SamplerNet.init(jax.random.PRNGKey(2), 30, 32, 18, jnp.float64)
    net = learned_from_numpy(diff.SamplerNet, jnet, dtype=torch.float64)
    assert isinstance(net, torch.nn.Module)
    assert [n for n, _ in net.named_parameters()] == ["w1", "b1", "w2", "b2"]
    feats = rng.randn(7, 30)
    close(net(torch.as_tensor(feats)).detach(), jnet(jnp.asarray(feats)))

    jrule = _jax_rule(3)
    rule = learned_from_numpy(diff.UpdateRule,
                              {k: np.asarray(v) for k, v in vars(jrule).items()},
                              dtype=torch.float64)
    costs = rng.rand(64) * 50
    close(rule.logit_correction(torch.as_tensor(costs / 25)).detach(),
          jrule.logit_correction(jnp.asarray(costs / 25)))
    close(diff.learned_weights(rule, torch.as_tensor(costs), 2.0).detach(),
          jdiff.learned_weights(jrule, jnp.asarray(costs), 2.0))


def test_identity_rule_weights_are_mppi_softmax():
    """Twin of tests/test_learned_optimizer.py:22-29."""
    costs = torch.tensor(np.random.RandomState(0).rand(64) * 50, dtype=torch.float32)
    gen = torch.Generator()
    gen.manual_seed(3)
    rule = diff.UpdateRule.init_identity(2, gen)
    np.testing.assert_allclose(diff.learned_weights(rule, costs, 2.0).detach().numpy(),
                               softmax_weights(costs, 2.0)[0].numpy(), rtol=1e-6)


def test_identity_rule_step_matches_vanilla_mppi():
    """Twin of tests/test_learned_optimizer.py:32-53: the same injected
    noise, float32."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=128, horizon=10, device="cpu")
    path = PathBuffer.from_points(course, 0.1, device="cpu")
    state = torch.tensor([0.0, float(course[0, 1]), 0.0])
    noise = torch.tensor(np.random.RandomState(1).randn(9, 128, 2), dtype=torch.float32)
    ctrl = ControllerState.initial(0, 10, 2, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(5)
    rule = diff.UpdateRule.init_identity(2, gen)
    _, vanilla = mppi_step(cfg, ctrl, state, path, 0.1, sp, cp, noise=noise)
    nxt, learned = diff.learned_update_step(cfg, rule, ctrl, state, path, 0.1, sp, cp,
                                            noise=noise)
    np.testing.assert_allclose(learned.u_opt.detach().numpy(), vanilla.u_opt.numpy(),
                               rtol=1e-5, atol=1e-6)
    assert nxt.step == 1 and nxt.seed == 0


@pytest.mark.parametrize("model,steer_off", [("unicycle", False), ("full_body", True)],
                         ids=["unicycle", "full_body-steer_off"])
def test_learned_update_step_matches_jax(model, steer_off):
    case = Case(64, model=model, steer_off=steer_off, horizon=8)
    u_dim = case.u_prev.shape[1]
    jrule = _jax_rule(4, u_dim)
    rule = learned_from_numpy(diff.UpdateRule, jrule, dtype=torch.float64)
    jctrl = JaxControllerState(u_prev=jnp.asarray(case.u_prev), key=jax.random.PRNGKey(0),
                               step=jnp.zeros((), jnp.int32))
    _, jres = jdiff.learned_update_step(case.jcfg, jrule, jctrl, jnp.asarray(case.state),
                                        case.jpath, 0.1, case.jsp, case.jcp,
                                        model_params=case.jmp, noise=jnp.asarray(case.noise))
    _, res = diff.learned_update_step(case.cfg, rule, ControllerState(case.tu, 0, 0),
                                      torch.as_tensor(case.state), case.path, 0.1, case.sp,
                                      case.cp, model_params=case.mp,
                                      noise=torch.as_tensor(case.noise))
    close(res.u_opt.detach(), jres.u_opt)
    close(res.opt_states.detach(), jres.opt_states)
    for name in ("min_cost", "mean_cost", "ess"):
        close(res.stats[name].detach(), jres.stats[name])


def _jax_solved_cost(case, rule, state, noise):
    """The body of the JAX package's solved_cost (learned_optimizer.py:179-204)
    at float64: that function fixes its cold start at float32."""
    ctrl = JaxControllerState(u_prev=jnp.zeros_like(jnp.asarray(case.u_prev)),
                              key=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    for _ in range(2):
        ctrl, _ = jdiff.learned_update_step(case.jcfg, rule, ctrl, state, case.jpath, 0.1,
                                            case.jsp, case.jcp, noise=noise)
    ref = jax_resample_reference(case.jpath, state[:2], case.jcp.v_ref, 0.1, case.horizon)
    return jdiff.make_trajectory_cost(case.jcfg)(ctrl.u_prev, state, ref, 0.1, case.jcp)


def test_solved_cost_gradient_matches_jax():
    """d(realized cost)/d(rule) through two cold-start cycles, the same noise
    in both (the JAX function repeats its one draw every cycle), float64."""
    case = Case(48, model="unicycle", horizon=8)
    jrule = _jax_rule(5)
    rule = learned_from_numpy(diff.UpdateRule, jrule, dtype=torch.float64)
    state, noise = jnp.asarray(case.state), jnp.asarray(case.noise)
    jgrad = jax.jit(jax.grad(lambda r: _jax_solved_cost(case, r, state, noise)))(jrule)
    cost = solved_cost(case.cfg, rule, torch.as_tensor(case.state), case.path, 0.1, case.sp,
                       case.cp, iterations=2,
                       noise=torch.as_tensor(np.stack([case.noise, case.noise])))
    grads = torch.autograd.grad(cost, list(rule.parameters()))
    for (name, _), g in zip(rule.named_parameters(), grads):
        assert float(g.abs().max()) > 0, name
        close(g, getattr(jgrad, name), GRAD)


def test_learned_proposal_beats_cold_start():
    """Twin of tests/test_learned_sampler.py:42-82: diff_drive K=256 T=10,
    96 imitation states, hidden 32, 300 steps; the learned center wins the
    first cycle's min cost on at least 5 of 6 held-out poses."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=256, horizon=10, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    feats, targets = diff.collect_imitation_data(cfg, sp, cp, course, gen, num_states=96,
                                                 solve_cycles=6)
    assert feats.shape == (96, 30) and targets.shape == (96, 9, 2)
    gen.manual_seed(1)
    net, losses = diff.fit_sampler(feats, targets, gen, hidden=32, num_steps=300)
    assert losses[-1] < losses[0] * 0.5

    path = PathBuffer.from_points(course, 0.1, device="cpu")
    dt = torch.tensor(0.1)
    rng = np.random.RandomState(7)
    wins, trials = 0, 6
    for i in range(trials):
        j = rng.randint(0, len(course) - 2)
        yaw0 = np.arctan2(course[j + 1, 1] - course[j, 1], course[j + 1, 0] - course[j, 0])
        state = torch.tensor([course[j, 0], course[j, 1] + rng.randn() * 0.3,
                              yaw0 + rng.randn() * 0.3], dtype=torch.float32)
        ref = resample_reference(path, state[:2], cp.v_ref, dt, cfg.horizon)
        with torch.no_grad():
            u_net = torch.clamp(diff.proposal_mean(net, cfg, state, ref), sp.u_min, sp.u_max)

        def first_cost(u_prev, seed):
            _, res = mppi_step(cfg, ControllerState(u_prev, seed, 0), state, path, dt, sp, cp)
            return float(res.stats["min_cost"])

        wins += first_cost(u_net, 100 + i) <= first_cost(torch.zeros_like(u_net), 100 + i)
    assert wins >= trials - 1, f"learned proposal won only {wins}/{trials}"


def test_meta_trained_rule_beats_vanilla_update():
    """Twin of tests/test_learned_optimizer.py:56-72: K=64 T=8, batch 32, 120
    steps, 2 iterations; the loss falls (mean of the last 20 steps below the
    first 20's: one batch's loss is noisy) and the learned rule beats the
    vanilla update on held-out poses."""
    cfg, sp, cp, course = diff_drive_launch(num_samples=64, horizon=8, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    rule, losses = diff.meta_train(cfg, sp, cp, course, gen, num_steps=120, batch=32,
                                   iterations=2)
    assert losses.shape == (120,) and np.isfinite(losses).all()
    assert losses[-20:].mean() < losses[:20].mean()
    held_out = [torch.Generator().manual_seed(1234) for _ in range(2)]
    vanilla = diff.evaluate_rule(cfg, None, sp, cp, course, held_out[0], iterations=2)
    learned = diff.evaluate_rule(cfg, rule, sp, cp, course, held_out[1], iterations=2)
    assert learned < vanilla, f"learned update {learned:.3f} not better than {vanilla:.3f}"
