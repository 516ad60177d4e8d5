"""Microseconds the host spends in one call of the compiled tick (span
``call.tick``: perf_counter around the call, which enqueues the work and
returns), mean over the window's calls."""


def read(obs):
    xs = obs["spans"].get("call.tick")
    return 1e6 * sum(xs) / len(xs) if xs else None
