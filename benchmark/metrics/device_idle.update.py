"""Percent of the traced window in which no operation ran on the device
(``benchmark/trace.py breakdown``), the window running from the first
update's start on the host to the last device activity."""


def read(obs):
    bd = obs["traces"].get("update")
    return None if bd is None else 100.0 * bd["device_idle_share"]
