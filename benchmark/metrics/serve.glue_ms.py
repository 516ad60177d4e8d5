"""Milliseconds a serving cycle spends in the host glue around the compiled
update: the pose copied in, the InputGate, the command geometry, the stale
policy, the steering mode and the stacking of the read (span ``glue``), mean
over the window's cycles. Moves ``cycle_ms_mean``."""


def read(obs):
    xs = obs["spans"].get("glue")
    return 1e3 * sum(xs) / len(xs) if xs else None
