"""Device operations of one update over PETS's probabilistic ensemble: the
mean count over the traced units (``obs["units"]``), the launches a fused
ensemble would collapse. None where no unit was traced. Moves
``propagations_per_s``."""


def read(obs):
    units = obs["units"].get("update")
    if units is None or not len(units["unit_us"]):
        return None
    return len(units["unit"]) / len(units["unit_us"])
