"""Microseconds the host spends in one call of the compiled update (span
``call.update``: perf_counter around the call, which enqueues the work and
returns), mean over the window's calls."""


def read(obs):
    xs = obs["spans"].get("call.update")
    return 1e6 * sum(xs) / len(xs) if xs else None
