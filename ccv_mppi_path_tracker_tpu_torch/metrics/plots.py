"""Analysis figures (port of ``metrics/plots.py``): plotting parity with the
reference's offline scripts.

Headless (Agg) matplotlib equivalents of the paper-figure scripts:
- :func:`plot_tracking` — trajectory vs desired path + velocity + steering
  time series (src/graph2.py layout);
- :func:`plot_zmp` — lateral ZMP inside the stability band + velocity + roll
  (src/zmp_graph.py; the reference plots a +/-0.15 m band at :53);
- :func:`plot_feasible_region` — the (V, omega) input region with/without
  steering from wheel-speed and steering-angle limits
  (src/v_w_performance.py:33-46);
- :func:`plot_course_curvature` — course curvature analysis
  (src/calc_curveture.py).

All functions return the matplotlib Figure and optionally save to ``out``.
They take the NumPy logs of ``run_tracking_experiment``. matplotlib is
imported lazily, in each function, so the package imports and runs where it
is not installed (as on the card's machine); only drawing needs it.
"""

from __future__ import annotations

import numpy as np
import torch

ZMP_BAND = 0.15  # plotted stability band, src/zmp_graph.py:53


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_tracking(result: dict, out: str = None, label: str = "MPPI"):
    """3-panel figure from a run_tracking_experiment result dict."""
    plt = _plt()
    logs, course = result["logs"], result["course"]
    states = logs["state"]
    n = len(states)
    t = np.arange(n) * result["metrics"]["time"] / max(n - 1, 1)
    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, figsize=(9, 9))
    ax1.plot(course[:, 0], course[:, 1], "b--", lw=2, label="Desired Path")
    ax1.plot(states[:, 0], states[:, 1], "r-", lw=2, label=label)
    ax1.set_xlabel("X [m]"), ax1.set_ylabel("Y [m]")
    ax1.legend(loc="lower right"), ax1.grid(True)
    ax2.plot(t, np.abs(logs["u0"][:, 0]), "r-", lw=2, label=label)
    ax2.set_xlabel("Time [s]"), ax2.set_ylabel("Velocity [m/s]")
    ax2.legend(loc="lower right"), ax2.grid(True)
    if logs["u0"].shape[1] >= 3:
        sl, sr = _steer_angles(logs["u0"])
        ax3.plot(t, np.degrees(sl), "b-", lw=2, label="Left Steering Angle")
        ax3.plot(t, np.degrees(sr), "r-", lw=2, label="Right Steering Angle")
    else:
        ax3.plot(t, logs["u0"][:, 1], "b-", lw=2, label="Angular Velocity")
    ax3.set_xlabel("Time [s]"), ax3.set_ylabel("Angle [deg]")
    ax3.legend(loc="lower right"), ax3.grid(True)
    fig.tight_layout(pad=2.0)
    if out:
        fig.savefig(out, dpi=120)
    return fig


def _steer_angles(u0):
    """Left and right wheel steering angles (NumPy) of the logged commands
    (v, w, direction, ...), by the port's command geometry."""
    from ccv_mppi_path_tracker_tpu_torch.solver.command import wheel_steer_angles

    u = torch.as_tensor(np.asarray(u0))
    sl, sr = wheel_steer_angles(u[:, 0], u[:, 1], u[:, 2], 0.501)
    return sl.numpy(), sr.numpy()


_CMP_COLORS = ("red", "green", "blue", "orange")


def _cmp_colors(n):
    """One color per run, cycling past the palette (no silent run drops)."""
    import itertools

    return list(itertools.islice(itertools.cycle(_CMP_COLORS), n))


def plot_tracking_comparison(results: dict, out: str = None):
    """TWO-RUN (or more) overlay figure — the reference's actual headline
    comparison plot (src/graph2.py:37-41 overlays the with-steering and
    without-steering runs on one Desired Path): (a) all trajectories over
    the course, (b) |velocity| time series per run, (c) wheel steering
    angles of the first steered run (graph2.py panel (c) plots one run's
    left/right angles).

    results: {label: result dict} from run_tracking_experiment /
    run_pure_pursuit_experiment (insertion order = draw order). The course
    is taken from the first result.
    """
    plt = _plt()
    assert results, "need at least one run"
    first = next(iter(results.values()))
    course = first["course"]
    fig, (ax1, ax2, ax3) = plt.subplots(3, 1, figsize=(9, 9))
    ax1.plot(course[:, 0], course[:, 1], "b--", lw=2, label="Desired Path")
    series = []  # (label, color, t, u0) — one time axis per run, computed once
    for (label, r), color in zip(results.items(), _cmp_colors(len(results))):
        states = r["logs"]["state"]
        ax1.plot(states[:, 0], states[:, 1], color=color, lw=2, label=label)
        u0 = r["logs"].get("u0")
        if u0 is None:
            continue
        n = len(states)
        t = np.arange(len(u0)) * r["metrics"]["time"] / max(n - 1, 1)
        series.append((label, color, t, u0))
        ax2.plot(t, np.abs(u0[:, 0]), color=color, lw=2, label=label)
    ax1.set_xlabel("X [m]"), ax1.set_ylabel("Y [m]")
    ax1.legend(loc="lower right"), ax1.grid(True)
    ax2.set_xlabel("Time [s]"), ax2.set_ylabel("Velocity [m/s]")
    ax2.legend(loc="lower right"), ax2.grid(True)
    steered = next(
        ((lbl, t, u0) for lbl, _, t, u0 in series if u0.shape[1] >= 3), None
    )
    if steered is not None:
        label, t, u0 = steered
        sl, sr = _steer_angles(u0)
        ax3.plot(t, np.degrees(sl), "b-", lw=2, label=f"Left Steering Angle ({label})")
        ax3.plot(t, np.degrees(sr), "r-", lw=2, label=f"Right Steering Angle ({label})")
        ax3.set_ylabel("Angle [deg]")
    else:
        for label, color, t, u0 in series:
            ax3.plot(t, u0[:, 1], color=color, lw=2, label=label)
        ax3.set_ylabel("Angular Velocity [rad/s]")
    ax3.set_xlabel("Time [s]")
    ax3.legend(loc="lower right"), ax3.grid(True)
    fig.tight_layout(pad=2.0)
    if out:
        fig.savefig(out, dpi=120)
    return fig


def plot_zmp_comparison(results: dict, zmp_params, dt: float = 0.1,
                        out: str = None):
    """Controlled-vs-uncontrolled lateral-ZMP overlay — the reference's
    zmp_graph2.py run on its controlled / not_controlled CSVs (the archived
    comparison PNGs log/full_body/robo_sym/{controlled,uncontrolled}.png):
    each run's zmp_y time series inside the +/-0.15 m band, with a
    |velocity| panel underneath.

    results: {label: result dict} of FULL-BODY runs (needs logs.state 5-dim
    and logs.u0 5-dim); the ZMP trace is recomputed from the executed
    trajectory with models/full_body.py zmp_chain (the same model the
    controller and the C++ oracle share) under ``zmp_params``, the port's
    FullBodyParams.
    """
    plt = _plt()
    from ccv_mppi_path_tracker_tpu_torch.models.full_body import zmp_chain

    dev = zmp_params.mass.device

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 7))
    for (label, r), color in zip(results.items(), _cmp_colors(len(results))):
        states = np.asarray(r["logs"]["state"])
        u0 = np.asarray(r["logs"]["u0"])
        n = min(len(states), len(u0) + 1)
        # zmp_chain yields T-2 entries for T states (entry t reads u[t] and
        # u[t+1], the reference's t < horizon_-2 loop)
        zmp = zmp_chain(torch.as_tensor(states[:n], device=dev),
                        torch.as_tensor(u0[: n - 1], device=dev), dt,
                        zmp_params).cpu().numpy()
        ax1.plot(np.arange(len(zmp)) * dt, zmp[:, 1], color=color, lw=2,
                 label=label)
        v = np.abs(u0[: n - 1, 0])
        ax2.plot(np.arange(len(v)) * dt, v, color=color, lw=2, label=label)
    for s in (+1, -1):
        ax1.axhline(s * ZMP_BAND, color="k", ls="--", lw=1)
    ax1.axhline(0.0, color="k", ls=":", lw=0.8)
    ax1.set_ylabel("ZMP y [m]"), ax1.legend(loc="lower right"), ax1.grid(True)
    ax1.set_ylim(-1.5 * ZMP_BAND, 1.5 * ZMP_BAND)
    ax2.set_xlabel("Time [s]"), ax2.set_ylabel("Velocity [m/s]")
    ax2.legend(loc="lower right"), ax2.grid(True)
    fig.tight_layout(pad=2.0)
    if out:
        fig.savefig(out, dpi=120)
    return fig


def path_yaw(course):
    """Central-difference heading along a course (src/graph3.py:26-32).

    First/last points use one-sided differences, interior points the
    centered arctan2 of the two-point chord, exactly as the script.
    """
    c = np.asarray(course)
    fwd = c[1:] - c[:-1]
    yaw = np.empty(len(c))
    yaw[0] = np.arctan2(fwd[0, 1], fwd[0, 0])
    yaw[-1] = np.arctan2(fwd[-1, 1], fwd[-1, 0])
    if len(c) > 2:
        ctr = c[2:] - c[:-2]
        yaw[1:-1] = np.arctan2(ctr[:, 1], ctr[:, 0])
    return yaw


def plot_yaw_comparison(result: dict, out: str = None, label: str = "MPPI"):
    """2-panel trajectory + yaw-vs-path-yaw figure (src/graph3.py layout):
    top X-Y trajectory against the desired path, bottom the robot's yaw and
    the course heading both plotted against X (:39-59)."""
    plt = _plt()
    logs, course = result["logs"], result["course"]
    states = logs["state"]
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 8))
    ax1.plot(course[:, 0], course[:, 1], "b--", lw=2, label="Desired Path")
    ax1.plot(states[:, 0], states[:, 1], "r-", lw=2, label=label)
    ax1.set_xlabel("X [m]"), ax1.set_ylabel("Y [m]")
    ax1.legend(loc="lower right"), ax1.grid(True)
    ax2.plot(course[:, 0], path_yaw(course), "g-", lw=2, label="Path Yaw")
    ax2.plot(states[:, 0], states[:, 2], "b-", lw=2, label="Yaw")
    ax2.set_xlabel("X [m]"), ax2.set_ylabel("Yaw [rad]")
    ax2.legend(loc="lower right"), ax2.grid(True)
    fig.tight_layout(pad=2.0)
    if out:
        fig.savefig(out, dpi=120)
    return fig


def plot_zmp(t, zmp_y, v=None, roll=None, true_zmp=None, out: str = None):
    """ZMP-y within the +/-band, with optional velocity/roll panels
    (src/zmp_graph.py structure)."""
    plt = _plt()
    panels = 1 + (v is not None) + (roll is not None)
    fig, axes = plt.subplots(panels, 1, figsize=(9, 3 * panels), squeeze=False)
    ax = axes[0][0]
    ax.plot(t, np.asarray(zmp_y) * 100, "r-", lw=2, label="Estimated ZMP")
    if true_zmp is not None:
        ax.plot(t, np.asarray(true_zmp) * 100, "b-", lw=1.5, label="True ZMP")
    for s in (+1, -1):
        ax.axhline(s * ZMP_BAND * 100, color="k", ls="--", lw=1)
    ax.set_ylabel("ZMP y [cm]"), ax.legend(), ax.grid(True)
    i = 1
    if v is not None:
        axes[i][0].plot(t, v, lw=2), axes[i][0].set_ylabel("Velocity [m/s]")
        axes[i][0].grid(True)
        i += 1
    if roll is not None:
        axes[i][0].plot(t, np.degrees(np.asarray(roll)), lw=2)
        axes[i][0].set_ylabel("Roll [deg]"), axes[i][0].grid(True)
    axes[-1][0].set_xlabel("Time [s]")
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
    return fig


def feasible_region_points(
    tread: float = 0.5,
    wheel_v_max: float = 3.0,
    steer_max: float = np.radians(30.0),
    n: int = 40,
):
    """(V, omega) reachable sets with and without wheel steering.

    Restates src/v_w_performance.py:33-46: without steering
    omega = (vr - vl)/L; with distinct same-sign steering angles the wheels
    trace radii Rl = sin|dr| L / sin|dl - dr|, Rr = sin|dl| L / sin|dr - dl|
    and omega = (vr - vl)/|Rr - Rl|. Returns (no_steer (M,2), steer (M,2))
    point clouds.
    """
    vr = np.linspace(-wheel_v_max, wheel_v_max, n)
    vl = np.linspace(-wheel_v_max, wheel_v_max, n)
    vr_m, vl_m = np.meshgrid(vr, vl)
    v_fwd = (vr_m + vl_m) / 2.0

    no_steer = np.stack(
        [v_fwd.ravel(), ((vr_m - vl_m) / tread).ravel()], axis=-1
    )

    pts = []
    deltas = np.linspace(-steer_max, steer_max, n)
    for dr in deltas:
        for dl in deltas:
            if dr == dl:
                continue
            if (dr < 0 < dl) or (dr > 0 > dl):
                continue  # ハ-shaped configurations are invalid (check_State)
            rl = np.sin(abs(dr)) * tread / np.sin(abs(dl - dr))
            rr = np.sin(abs(dl)) * tread / np.sin(abs(dr - dl))
            omega = (vr_m - vl_m) / abs(rr - rl)
            pts.append(np.stack([v_fwd.ravel(), omega.ravel()], axis=-1))
    steer = np.concatenate(pts, axis=0) if pts else np.zeros((0, 2))
    return no_steer, steer


def plot_feasible_region(out: str = None, **kw):
    plt = _plt()
    no_steer, steer = feasible_region_points(**kw)
    fig, ax = plt.subplots(figsize=(8, 6))
    if len(steer):
        ax.scatter(steer[:, 0], steer[:, 1], c="r", s=1, label="With Steering")
    ax.scatter(no_steer[:, 0], no_steer[:, 1], c="b", s=1, label="Without Steering")
    ax.set_xlabel("Forward Velocity V [m/s]", fontsize=15)
    ax.set_ylabel("Angular Velocity ω [rad/s]", fontsize=15)
    ax.grid(True), ax.legend(loc="upper right")
    if out:
        fig.savefig(out, dpi=120)
    return fig


def plot_filtered_square_analysis(
    length=20.0, amplitude=2.0, wave_hz=1.0, fs=1000.0, cutoff=1.0, order=6,
    out: str = None,
):
    """Raw vs low-passed square wave and their spectra — the course-design
    analysis of src/ref_path_analyze.py."""
    import math

    from scipy.signal import butter, lfilter, square

    plt = _plt()
    t = np.linspace(0.0, length, int(length * fs), endpoint=False)
    raw = amplitude * square(2.0 * math.pi * wave_hz * t)
    b, a = butter(order, cutoff / (0.5 * fs), btype="low")
    filt = lfilter(b, a, raw)
    freqs = np.fft.rfftfreq(len(t), 1.0 / fs)
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 6))
    ax1.plot(t, raw, "0.7", lw=1, label="Square wave")
    ax1.plot(t, filt, "r-", lw=2, label="Low-passed course")
    ax1.set_xlabel("s [m]"), ax1.set_ylabel("y [m]")
    ax1.legend(), ax1.grid(True)
    for sig, c, lab in ((raw, "0.7", "raw"), (filt, "r", "filtered")):
        mag = np.abs(np.fft.rfft(sig)) / len(sig)
        ax2.semilogy(freqs[1:200], mag[1:200] + 1e-12, color=c, label=lab)
    ax2.axvline(cutoff, color="k", ls="--", lw=1, label="cutoff")
    ax2.set_xlabel("frequency"), ax2.set_ylabel("|Y|")
    ax2.legend(), ax2.grid(True)
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
    return fig


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def plot_solver_debug(res, course=None, out: str = None, max_candidates=64):
    """One control cycle's internals — the rviz view (config/config.rviz):
    candidate rollouts (green), the optimal path (red), the resampled
    reference window (blue). ``res`` is a StepResult produced with
    ``debug_candidates > 0`` (tensors on any device, or arrays)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    if course is not None:
        ax.plot(course[:, 0], course[:, 1], color="0.7", lw=1, label="Course")
    cands = _numpy(res.stats["candidates"])[:max_candidates]
    for i, c in enumerate(cands):
        ax.plot(c[:, 0], c[:, 1], color="g", lw=0.5, alpha=0.3,
                label="Candidate paths" if i == 0 else None)
    ref = _numpy(res.ref.xy)
    ax.plot(ref[:, 0], ref[:, 1], "b.-", lw=2, label="Reference window")
    opt = _numpy(res.opt_states)
    ax.plot(opt[:, 0], opt[:, 1], "r-", lw=2, label="Optimal path")
    ax.set_xlabel("X [m]"), ax.set_ylabel("Y [m]")
    ax.legend(), ax.grid(True), ax.axis("equal")
    if out:
        fig.savefig(out, dpi=120)
    return fig


def plot_course_curvature(course, out: str = None):
    from ccv_mppi_path_tracker_tpu_torch.metrics.tracking import curvature

    plt = _plt()
    k = curvature(course)
    s = np.concatenate([[0], np.cumsum(np.hypot(*np.diff(course, axis=0).T))])
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(9, 6))
    ax1.plot(course[:, 0], course[:, 1], lw=2)
    ax1.set_xlabel("X [m]"), ax1.set_ylabel("Y [m]"), ax1.grid(True)
    ax2.plot(s, k, lw=2)
    ax2.set_xlabel("Arc length [m]"), ax2.set_ylabel("Curvature [1/m]")
    ax2.grid(True)
    fig.tight_layout()
    if out:
        fig.savefig(out, dpi=120)
    return fig
