"""Percent of the time inside the traced cycles (each from its pose's due time
to its read) in which no operation ran on the device; the gaps between
cycles, where the loop waits for the next pose, are left out."""


def read(obs):
    bd = obs["traces"].get("cycle")
    return None if bd is None else 100.0 * bd["inside_idle_share"]
