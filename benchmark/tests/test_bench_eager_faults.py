"""The eager arm's planted faults (``benchmark/readings_eager.py``) at small
sizes on the CPU: each comes out not correct by ``u_gap``, and each is
undone after its run."""

import pytest

from benchmark import readings_eager
from benchmark.tests.test_bench_harness import run

EAGER_CELLS = ["autorally_nn.update", "pets_pe.update"]
CASES = [("half_sequences", c) for c in EAGER_CELLS] + [("half_particles", "pets_pe.update")]


@pytest.mark.parametrize("fault,cell", CASES)
def test_an_eager_fault_fails_u_gap(fault, cell):
    line, _ = run(cell, program=readings_eager.FAULTS[fault])
    assert line["correct"] is False
    assert line["checks"]["u_gap"]["value"] > line["checks"]["u_gap"]["limit"]


def test_the_eager_faults_are_undone():
    from ccv_mppi_path_tracker_tpu_torch.models import pets_pe, registry

    before = (registry.get_model("pets_pe"), pets_pe.particle_states)
    for fault in sorted(readings_eager.FAULTS):
        run("pets_pe.update", program=readings_eager.FAULTS[fault])
    assert (registry.get_model("pets_pe"), pets_pe.particle_states) == before


def test_the_particle_fault_refuses_a_model_without_particles():
    with pytest.raises(ValueError, match="no particles"):
        run("autorally_nn.update", program=readings_eager.HalfParticles)
