"""Microseconds the host spends in one call of the compiled serve (span
``call.serve``: perf_counter around the call, which enqueues the work and
returns), mean over the window's calls."""


def read(obs):
    xs = obs["spans"].get("call.serve")
    return 1e6 * sum(xs) / len(xs) if xs else None
