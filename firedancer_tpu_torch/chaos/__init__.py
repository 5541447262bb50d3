"""chaos/: the scenario harness (the port's counterpart of
firedancer_tpu/chaos/): adversarial load, fault injection and invariant
checking over the port's stages and process topologies, each scenario
ending in an invariant suite (liveness, conservation of counts across
hops, no frag corruption, no /dev/shm residue) whose failure artifact is
the flight-recorder dump and its Chrome trace.

    faults.py       the declarative fault schedule and the supervisor hook
                    (kill, freeze and thaw stages) and the link-fault specs
                    (the tango/lossy.py shim)
    invariants.py   the checker: named checks -> a deterministic summary
    scenario.py     the named scenarios and the runner behind
                    `python -m firedancer_tpu_torch chaos run <name> --seed S`

Every random choice threads the run seed through utils/rng.Rng, so
`chaos run <scenario> --seed S` prints the same summary on every run.
"""

from .scenario import SCENARIOS, run_scenario  # noqa: F401
