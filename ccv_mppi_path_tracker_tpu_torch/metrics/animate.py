"""Per-cycle solver animation, the live-rviz-displays equivalent (port of
``metrics/animate.py``).

The reference visualizes each control cycle live in rviz: K candidate paths
as a MarkerArray, the optimal path, and the resampled reference window
(publish_CandidatePath / publish_OptimalPath / publish_RefPath,
src/diff_drive_mppi.cpp:142-154, :265-312; displays in config/config.rviz).
This module renders the same three displays plus the robot trace as a
matplotlib animation exported to standalone HTML (jshtml — no ffmpeg needed)
or GIF (Pillow writer).

Data comes from a tracking run with planned paths logged:

    out = run_tracking_experiment(
        cfg, sp, cp, course, with_paths=True,
        solver_options={"debug_candidates": 24},
    )
    animate_tracking(out, "run.html")

matplotlib is imported when a file is rendered, not when the module is.
"""

from __future__ import annotations

import numpy as np


def animate_tracking(
    result: dict,
    out_path: str,
    every: int = 1,
    max_candidates: int = 32,
    fps: int = 10,
    figsize=(8.0, 6.0),
):
    """Render a closed-loop run to an animation file.

    result: dict from ``run_tracking_experiment(..., with_paths=True)``;
        candidate paths are drawn when the run also used
        ``solver_options={"debug_candidates": N}``.
    out_path: output file; ``.html`` -> standalone jshtml, ``.gif`` -> GIF.
    every: render every n-th control cycle (animation length control).
    Returns the number of rendered frames.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    logs = result["logs"]
    course = np.asarray(result["course"])
    if "opt_xy" not in logs:
        raise ValueError(
            "run the experiment with with_paths=True to log planned paths"
        )
    opt = np.asarray(logs["opt_xy"])  # (N, T, 2)
    ref = np.asarray(logs["ref_xy"])  # (N, T, 2)
    cand = np.asarray(logs["candidates"]) if "candidates" in logs else None
    states = np.concatenate(
        [np.asarray(result["state0"])[None, :2], np.asarray(logs["state"])[:, :2]]
    )
    frames = list(range(0, opt.shape[0], max(1, every)))

    fig, ax = plt.subplots(figsize=figsize)
    ax.plot(course[:, 0], course[:, 1], color="0.75", lw=1.0, label="course")
    pad = 0.5
    ax.set_xlim(course[:, 0].min() - pad, course[:, 0].max() + pad)
    ax.set_ylim(
        min(course[:, 1].min(), states[:, 1].min()) - pad,
        max(course[:, 1].max(), states[:, 1].max()) + pad,
    )
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")

    cand_lines = []
    if cand is not None:
        n_show = min(max_candidates, cand.shape[1])
        for _ in range(n_show):
            (ln,) = ax.plot([], [], color="tab:cyan", lw=0.5, alpha=0.35)
            cand_lines.append(ln)
    (trace_ln,) = ax.plot([], [], color="tab:blue", lw=1.5, label="robot")
    (ref_ln,) = ax.plot([], [], color="tab:green", lw=1.5, ls="--",
                        label="ref window")
    (opt_ln,) = ax.plot([], [], color="tab:red", lw=1.5, label="optimal plan")
    (robot_pt,) = ax.plot([], [], "o", color="tab:blue", ms=6)
    ax.legend(loc="upper right", fontsize=8)
    title = ax.set_title("")

    def draw(i):
        k = frames[i]
        for j, ln in enumerate(cand_lines):
            ln.set_data(cand[k, j, :, 0], cand[k, j, :, 1])
        trace_ln.set_data(states[: k + 1, 0], states[: k + 1, 1])
        ref_ln.set_data(ref[k, :, 0], ref[k, :, 1])
        opt_ln.set_data(opt[k, :, 0], opt[k, :, 1])
        robot_pt.set_data(states[k : k + 1, 0], states[k : k + 1, 1])
        title.set_text(f"cycle {k}")
        return cand_lines + [trace_ln, ref_ln, opt_ln, robot_pt, title]

    anim = animation.FuncAnimation(
        fig, draw, frames=len(frames), interval=1000 // fps, blit=False
    )
    if out_path.endswith(".gif"):
        anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    else:
        with open(out_path, "w") as f:
            f.write(anim.to_jshtml(fps=fps))
    plt.close(fig)
    return len(frames)
