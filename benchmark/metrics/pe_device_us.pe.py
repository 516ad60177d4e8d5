"""Device time of one update over PETS's probabilistic ensemble, in
microseconds: the mean over the traced units of the summed lengths of
their device operations (``obs["units"]``). None where no unit was traced.
Moves ``propagations_per_s``."""


def read(obs):
    units = obs["units"].get("update")
    if units is None or not len(units["unit_us"]):
        return None
    return float(units["dur_us"].sum()) / len(units["unit_us"])
