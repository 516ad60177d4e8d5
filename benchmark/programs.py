"""The system under test, as the traffic kinds drive it.

:class:`Port` reaches ``ccv_mppi_path_tracker_tpu_torch`` through its public
entry points only: ``core.presets``, ``paths.PathBuffer``,
``core.types.ControllerState``, ``solver.compile_step``, ``solver.init_fleet``
/ ``build_fleet_step``, ``runtime.loop.ControlLoop``, ``runtime.gating.InputGate``
and ``solver.command.command_from_solution`` / ``steering_mode``.

The configuration's ``program`` block may hold ``options``: keyword options
of ``mppi_step`` (``refine_steps``, ``refine_method``, ``elite_frac``,
``adapt_sigma``, ...), which the port's update gets as written. Before any
timing :class:`Port` refuses, with :class:`ConfigMismatch`, an option that
``mppi_step`` does not know, one that is an argument of a call rather than a
setting, and one that the traffic's path cannot honour; no option is dropped.

:class:`Control` is the control of the correctness check: the
configuration's plain reference, computed in bfloat16, put in the place of
the update (the port's serving glue stays). The harness's runs never use it;
``benchmark.readings`` and the tests do.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from benchmark import reference


class ConfigMismatch(ValueError):
    """The preset the configuration names does not hold the configuration's
    numbers, or the port cannot run the options it names as written."""


# mppi_step's keywords that are a call's arguments or the program block's own
# keys, not options of a configuration
NOT_OPTIONS = ("model_params", "noise", "elite_stale_thresh", "group", "num_samples",
               "first_sample", "use_kernel", "lean")


def _check(name, got, want):
    got = np.asarray(got.detach().cpu().double() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want, dtype=np.float32).astype(np.float64)
    if got.shape != want.shape or not np.array_equal(got, want):
        raise ConfigMismatch(f"the preset's {name} is {got.tolist()}, the configuration "
                             f"file says {want.tolist()}")


class Port:
    """The port at one configuration (a configuration file's dict) on
    ``device``; ``course`` is the harness's (the port is handed it as a path
    by the traffic kind), ``ref`` the configuration's reference module
    (``benchmark/reference.py`` by default; the port never reads it)."""

    def __init__(self, config: dict, device, course=None, ref=reference):
        import inspect

        from ccv_mppi_path_tracker_tpu_torch.core import presets
        from ccv_mppi_path_tracker_tpu_torch.solver import mppi_step

        self.config, self.device = config, device
        preset = getattr(presets, config["program"]["preset"])
        self.cfg, self.sp, self.cp, _ = preset(num_samples=config["num_samples"],
                                               horizon=config["horizon"], device=device)
        if self.cfg.model != config["model"]:
            raise ConfigMismatch(f"the preset runs {self.cfg.model}, not {config['model']}")
        sol, cost = config["solver"], config["cost"]
        for name in ("control_noise", "lam", "u_min", "u_max", "noise_beta"):
            _check(name, getattr(self.sp, name), sol[name])
        for name in ("v_ref", "path_weight", "v_weight", "zmp_weight", "roll_v_weight",
                     "back_weight", "yaw_weight"):
            _check(name, getattr(self.cp, name), cost[name])
        if self.cfg.steer_off != sol["steer_off"]:
            raise ConfigMismatch("steer_off differs from the configuration file")
        self.num_controls = len(sol["u_min"])
        self.ref = ref
        self.options = dict(config["program"].get("options", {}))
        known = inspect.signature(mppi_step).parameters
        for name in self.options:
            if name not in known or known[name].default is inspect.Parameter.empty:
                raise ConfigMismatch(f"mppi_step has no option {name!r}")
            if name in NOT_OPTIONS:
                raise ConfigMismatch(f"{name!r} is not an option of a configuration: it is an "
                                     f"argument of a call or a key of the program block")

    def _refuse(self, names, path: str):
        """ConfigMismatch where the configuration names one of ``names``,
        options that ``path`` cannot honour."""
        bad = sorted(set(self.options) & set(names))
        if bad:
            raise ConfigMismatch(f"{path} cannot honour the option(s) {', '.join(bad)}")

    def path(self, course):
        from ccv_mppi_path_tracker_tpu_torch.paths import PathBuffer

        return PathBuffer.from_points(course, self.config["course"]["resolution"],
                                      device=self.device)

    def initial(self, seed: int):
        from ccv_mppi_path_tracker_tpu_torch.core.types import ControllerState

        return ControllerState.initial(seed, self.config["horizon"], self.num_controls,
                                       device=self.device)

    def update_step(self):
        """step(ctrl, state, path, dt) -> (ctrl, u_opt (T-1, U)): the compiled
        kernel-lean update, under the configuration's options."""
        from ccv_mppi_path_tracker_tpu_torch.solver import compile_step

        opts = self.config["program"]
        compiled = compile_step(self.cfg, use_kernel=opts["use_kernel"], lean=opts["lean"],
                                **self.options)
        sp, cp = self.sp, self.cp

        def step(ctrl, state, path, dt):
            ctrl, res = compiled(ctrl, state, path, dt, sp, cp)
            return ctrl, res.u_opt
        return step

    def init_fleet(self, robots: int, seed: int):
        from ccv_mppi_path_tracker_tpu_torch.solver import init_fleet

        return init_fleet(self.cfg, robots, seed=seed, device=self.device)

    def fleet_step(self):
        """step(ctrls, states, path, dt) -> (ctrls, u_opt (B, T-1, U), u0 (B, U))."""
        from ccv_mppi_path_tracker_tpu_torch.solver import build_fleet_step

        self._refuse(self.options, "the fleet tick (build_fleet_step takes no solver options)")

        tick = build_fleet_step(self.cfg, use_kernel=self.config["program"]["use_kernel"])
        sp, cp = self.sp, self.cp

        def step(ctrls, states, path, dt):
            ctrls, res = tick(ctrls, states, path, dt, sp, cp)
            return ctrls, res.u_opt, res.u0
        return step

    def control_loop(self, path, seed: int):
        """A ControlLoop whose controller starts from ``seed``, under the
        configuration's options."""
        from ccv_mppi_path_tracker_tpu_torch.runtime.loop import ControlLoop

        opts = self.config["program"]
        self._refuse(("adapt_sigma",), "the serving loop (ControlLoop sets adapt_sigma from "
                     "its sigma_adapt)")
        loop = ControlLoop(cfg=self.cfg, sp=self.sp, cp=self.cp, path=path,
                           nominal_dt=self.config["dt"],
                           solver_options={"use_kernel": opts["use_kernel"],
                                           "lean": opts["lean"], **self.options})
        loop.ctrl = self.initial(seed)
        return loop

    def gate(self):
        from ccv_mppi_path_tracker_tpu_torch.runtime.gating import InputGate

        return InputGate(stale_policy="hold")

    def command(self, u0, dt: float):
        from ccv_mppi_path_tracker_tpu_torch.solver.command import command_from_solution

        return command_from_solution(self.cfg.model, u0, dt)

    def mode(self, cmd):
        from ccv_mppi_path_tracker_tpu_torch.solver.command import steering_mode

        return steering_mode(cmd.steer_r, cmd.steer_l)


class Control(Port):
    """The port with its update replaced by the configuration's plain
    reference ``ref`` in bfloat16 (the nearest precision below the
    configuration's float32). ``course``: the harness's course, which the
    reference reads as it reads it in the check."""

    dtype = torch.bfloat16

    def __init__(self, config: dict, device, course, ref=reference):
        super().__init__(config, device, ref=ref)
        self.course = course

    def _state(self, seed, step, u_prev):
        return types.SimpleNamespace(u_prev=u_prev, seed=seed, step=step, key=None)

    def initial(self, seed: int):
        tm1 = self.config["horizon"] - 1
        return self._state(seed, 0, torch.zeros((tm1, self.num_controls),
                                                device=self.device))

    def _update(self, u_prev, states, seed, step):
        u = self.ref.update(self.config, self.course, states, u_prev, seed, step,
                            dtype=self.dtype)
        return u.to(torch.float32)

    def update_step(self):
        def step(ctrl, state, path, dt):
            u = self._update(ctrl.u_prev[None], state[None], ctrl.seed, ctrl.step)[0]
            return self._state(ctrl.seed, ctrl.step + 1, u), u
        return step

    def init_fleet(self, robots: int, seed: int):
        tm1 = self.config["horizon"] - 1
        return self._state(seed, 0, torch.zeros((robots, tm1, self.num_controls),
                                                device=self.device))

    def fleet_step(self):
        def step(ctrls, states, path, dt):
            u = self._update(ctrls.u_prev, states, ctrls.seed, ctrls.step)
            return self._state(ctrls.seed, ctrls.step + 1, u), u, u[:, 0]
        return step

    def control_loop(self, path, seed: int):
        outer = self

        class Loop:
            ctrl = self.initial(seed)

            def step(self, pose, dt):
                c = self.ctrl
                u = outer._update(c.u_prev[None], pose[None], c.seed, c.step)[0]
                self.ctrl = outer._state(c.seed, c.step + 1, u)
                return types.SimpleNamespace(u_opt=u, u0=u[0])
        return Loop()
