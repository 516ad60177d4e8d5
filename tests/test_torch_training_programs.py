"""The differentiable side's compiled programs (diff/optim.py: scans of one
Adam step) against the JAX package, on the CPU at float64: the functional
Adam against ``optax.adam`` over 50 steps (rtol 1e-12); the system-ID fits
and the sampler fit against the JAX functions, from weights carried with
``convert.py`` (rtol 1e-8, losses too); one meta-training step against a JAX
step composed here from the body of JAX's ``solved_cost``, ``jax.value_and_grad``
and ``optax.adam`` on the same poses, noise and rule (rtol 1e-8); each scan
bit-equal to a Python loop of its step; meta-training a function of its
generator's seed; and the order of its draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ccv_mppi_path_tracker_tpu import diff as jdiff
from ccv_mppi_path_tracker_tpu.models import get_model as jax_get_model
from ccv_mppi_path_tracker_tpu.models.full_body import default_params as jax_default_params
from ccv_mppi_path_tracker_tpu.models.full_body import zmp_chain as jax_zmp_chain
from ccv_mppi_path_tracker_tpu_torch import diff
from ccv_mppi_path_tracker_tpu_torch.convert import learned_from_numpy
from ccv_mppi_path_tracker_tpu_torch.core.presets import diff_drive_launch
from ccv_mppi_path_tracker_tpu_torch.core.types import make_key
from ccv_mppi_path_tracker_tpu_torch.diff import learned_optimizer, learned_sampler, system_id
from ccv_mppi_path_tracker_tpu_torch.diff.optim import Program, adam_init, adam_update
from ccv_mppi_path_tracker_tpu_torch.models.full_body import FullBodyParams
from ccv_mppi_path_tracker_tpu_torch.ops.sampling import draw_standard_normals
from ccv_mppi_path_tracker_tpu_torch.utils.cuda_graph import split_tensors
from test_torch_learned import _jax_rule, _jax_solved_cost
from test_torch_solver import Case

ADAM = dict(rtol=1e-12, atol=1e-15)
FIT = dict(rtol=1e-8)
DT = 0.1


def close(port, ref, tol=FIT):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), **tol)


def test_functional_adam_matches_optax():
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (4,), ()]
    params = [np.asarray(rng.randn(*s)) for s in shapes]
    opt = optax.adam(0.05)
    jparams = [jnp.asarray(p) for p in params]
    jstate = opt.init(jparams)
    tparams = tuple(torch.as_tensor(p) for p in params)
    tstate = adam_init(tparams)
    for _ in range(50):
        grads = [np.asarray(rng.randn(*s) * rng.choice([1e-3, 1.0, 30.0])) for s in shapes]
        updates, jstate = opt.update([jnp.asarray(g) for g in grads], jstate)
        jparams = optax.apply_updates(jparams, updates)
        tparams, tstate = adam_update(tparams, tuple(map(torch.as_tensor, grads)), tstate,
                                      0.05)
    adam_state = jstate[0]
    assert int(tstate[2]) == int(adam_state.count) == 50
    for t, j, m, jm, v, jv in zip(tparams, jparams, tstate[0], adam_state.mu, tstate[1],
                                  adam_state.nu):
        close(t, j, ADAM)
        close(m, jm, ADAM)
        close(v, jv, ADAM)


def _transitions(model, n, seed, gains):
    rng = np.random.RandomState(seed)
    m = jax_get_model(model)
    states, controls = rng.randn(n, m.num_states) * 0.5, rng.randn(n, m.num_controls)
    next_states = np.asarray(m.step(jnp.asarray(states), jnp.asarray(controls * gains), DT))
    return states, controls, next_states


@pytest.mark.parametrize("model,gains", [("steering_unicycle", [0.9, 1.2, 1.05]),
                                         ("rate_limited_steering", [1.15, 0.8, 0.95])])
def test_fit_control_gains_from_an_init_matches_jax(model, gains):
    data = _transitions(model, 256, 4, np.asarray(gains))
    init = np.asarray([1.05, 0.95, 1.0])
    jfit, jlosses = jdiff.fit_control_gains(
        model, *map(jnp.asarray, data), DT, num_steps=80, learning_rate=0.05,
        init=jdiff.ControlGains(gains=jnp.asarray(init)))
    fit, losses = diff.fit_control_gains(
        model, *map(torch.as_tensor, data), DT, num_steps=80, learning_rate=0.05,
        init=diff.ControlGains(gains=torch.as_tensor(init)))
    close(fit.gains, jfit.gains)
    close(losses, jlosses)


def test_fit_full_body_params_from_a_moved_mass_matches_jax():
    rng = np.random.RandomState(5)
    states, controls = rng.randn(10, 32, 5) * 0.2, rng.randn(9, 32, 5) * 0.5
    true = jax_default_params(np.float64)
    observed = np.asarray(jax_zmp_chain(jnp.asarray(states), jnp.asarray(controls), DT,
                                        true)[..., 1])
    jinit = dataclasses.replace(true, mass=np.asarray(float(true.mass) * 1.2),
                                base2com=np.asarray(0.55))
    jfit, jlosses = jdiff.fit_full_body_params(
        jnp.asarray(states), jnp.asarray(controls), jnp.asarray(observed), DT, jinit,
        num_steps=150, learning_rate=0.03)
    fit, losses = diff.fit_full_body_params(
        torch.as_tensor(states), torch.as_tensor(controls), torch.as_tensor(observed), DT,
        learned_from_numpy(FullBodyParams, jinit, dtype=torch.float64), num_steps=150,
        learning_rate=0.03)
    for name in ("mass", "base2com", "inertia", "gravity_z"):
        close(getattr(fit, name), getattr(jfit, name))
    close(losses, jlosses, dict(FIT, atol=1e-12 * float(jlosses[0])))


def test_fit_sampler_from_carried_weights_matches_jax():
    rng = np.random.RandomState(6)
    feats, targets = rng.randn(40, 30), rng.randn(40, 9, 2) * 0.3
    key = jax.random.PRNGKey(3)
    jnet, jlosses = jdiff.fit_sampler(jnp.asarray(feats), jnp.asarray(targets), key,
                                      hidden=16, num_steps=120, learning_rate=3e-3)
    # JAX's fit_sampler draws its start as SamplerNet.init(key, ...) does
    start = tuple(p.detach() for p in learned_from_numpy(
        diff.SamplerNet, jdiff.SamplerNet.init(key, 30, 16, 18, jnp.float64),
        dtype=torch.float64).parameters())
    feats_t = torch.as_tensor(feats)
    (params, _), losses = Program(
        learned_sampler.SAMPLER_FIT,
        ((start, adam_init(start)), feats_t, torch.as_tensor(targets).reshape(40, -1), 3e-3),
        120)()
    for p, name in zip(params, ("w1", "b1", "w2", "b2")):
        close(p, getattr(jnet, name))
    close(losses, jlosses)


def test_one_meta_training_step_matches_a_jax_step():
    """``_meta_step`` on the noise JAX's solved_cost repeats every cycle
    (stacked for the port's two cycles) against jax.value_and_grad of the
    mean of that body over the same poses, then optax.adam."""
    case = Case(32, model="unicycle", horizon=8)
    batch, lr = 3, 3e-3
    rng = np.random.RandomState(8)
    poses = case.state + rng.randn(batch, 3) * np.array([0.1, 0.2, 0.3])
    noise = rng.randn(batch, 7, 32, 2)
    jrule = _jax_rule(9)

    def jloss(rule):
        return jnp.mean(jax.vmap(lambda s, nz: _jax_solved_cost(case, rule, s, nz))(
            jnp.asarray(poses), jnp.asarray(noise)))

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jrule)
    opt = optax.adam(lr)
    updates, jstate = opt.update(jg, opt.init(jrule))
    jnew = optax.apply_updates(jrule, updates)

    rule = learned_from_numpy(diff.UpdateRule, jrule, dtype=torch.float64)
    params = rule.tensors()
    carry = (params, adam_init(params), make_key(0, 0, "cpu"))
    dt = torch.full((), DT, dtype=torch.float64)
    (new, (mu, nu, count), key), loss = learned_optimizer._meta_step(
        carry, case.cfg, case.sp, case.cp, case.path, dt, torch.as_tensor(poses)[None], 2,
        lr, torch.as_tensor(np.stack([noise, noise])))
    close(loss, jl)
    assert key.tolist() == [0, 1] and int(count) == 1
    # b2 shifts every logit alike, which the softmax ignores: its gradient is
    # round-off (~1e-16) in both, so the moments get an absolute floor
    moments = dict(FIT, atol=1e-15)
    for i, name in enumerate(("w1", "b1", "w2", "b2", "log_gain")):
        close(new[i], getattr(jnew, name))
        close(mu[i], getattr(jstate[0].mu, name), moments)
        close(nu[i], getattr(jstate[0].nu, name), moments)


def _programs():
    """Each scanned program at a small size on the CPU, float64."""
    rng = np.random.RandomState(10)
    f64 = dict(dtype=torch.float64)
    states, controls = torch.tensor(rng.randn(64, 3), **f64), torch.tensor(rng.randn(64, 2),
                                                                           **f64)
    nxt = states + 0.1 * torch.tensor(rng.randn(64, 3), **f64)
    init = learned_from_numpy(FullBodyParams, jax_default_params(np.float64),
                              dtype=torch.float64)
    zs, zc = torch.tensor(rng.randn(8, 16, 5) * 0.2, **f64), torch.tensor(
        rng.randn(7, 16, 5) * 0.5, **f64)
    gen = torch.Generator()
    gen.manual_seed(2)
    cfg, sp, cp, course = diff_drive_launch(num_samples=16, horizon=5, dtype=torch.float64,
                                            device="cpu")
    return {
        "gains": system_id._fit_control_gains_program("unicycle", states, controls, nxt, DT,
                                                      num_steps=6),
        "zmp": system_id._fit_full_body_params_program(
            zs, zc, torch.tensor(rng.randn(6, 16), **f64) * 0.01, DT, init, num_steps=6),
        "sampler": learned_sampler._fit_sampler_program(
            torch.tensor(rng.randn(20, 12), **f64), torch.tensor(rng.randn(20, 4, 2), **f64),
            gen, hidden=8, num_steps=6),
        "meta_train": learned_optimizer._meta_train_program(cfg, sp, cp, course, gen,
                                                            num_steps=3, batch=4),
    }


@pytest.mark.parametrize("name", ["gains", "zmp", "sampler", "meta_train"])
def test_the_scan_is_a_python_loop_of_its_step(name):
    program = _programs()[name]
    (carry, *fixed) = program.args
    losses = []
    for _ in range(program.length):
        carry, loss = program.graphed.fn(carry, *fixed)
        losses.append(loss)
    scanned, scanned_losses = program()
    assert torch.equal(scanned_losses, torch.stack(losses))
    flat, flat_scanned = [], []
    split_tensors(carry, flat)
    split_tensors(scanned, flat_scanned)
    assert len(flat) == len(flat_scanned)
    assert all(torch.equal(a, b) for a, b in zip(flat, flat_scanned))


def test_meta_train_is_a_function_of_the_generator_seed():
    cfg, sp, cp, course = diff_drive_launch(num_samples=16, horizon=5, device="cpu")
    runs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(11)
        runs.append(diff.meta_train(cfg, sp, cp, course, gen, num_steps=3, batch=4))
    (rule_a, losses_a), (rule_b, losses_b) = runs
    np.testing.assert_array_equal(losses_a, losses_b)
    assert all(torch.equal(a, b) for a, b in zip(rule_a.parameters(), rule_b.parameters()))


def test_a_meta_training_step_draws_the_philox_stream_of_seed_and_step():
    """Step i's noise for cycle c of pose b is robot word c * B + b of the
    Philox stream (seed, i)."""
    cfg, _, _, _ = diff_drive_launch(num_samples=16, horizon=5, device="cpu")
    noise = learned_optimizer._step_noise(cfg, make_key(7, 3, "cpu"), 2, 4, torch.float32)
    assert noise.shape == (2, 4, 4, 16, 2)
    for c in range(2):
        for b in range(4):
            one = draw_standard_normals(None, 7, 3, (4, 16, 2), robot=c * 4 + b,
                                        device="cpu")
            assert torch.equal(noise[c, b], one)
