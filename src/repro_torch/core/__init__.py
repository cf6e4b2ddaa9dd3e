# The paper's primary contribution: the Metronome scheduling mechanism.
#   geometry  — TDM circle abstraction (Eqs. 1-6, 9)
#   scoring   — per-candidate Eq. 18 evaluators (ranges, banks, Psi)
#   rotation  — fabric-wide joint rotation planner (single scheme producer)
#   framework — K8s-scheduling-framework analogue (extension points)
#   scheduler — Algorithm 1 (MetronomePlugin)
#   controller— stop-and-wait controller (global offset, recalc, regulation)
#   contention— unified job→link demand view (LinkView; Eq. 9 predicate)
#   events    — typed dynamic-environment events (reconfiguration inputs)
#   baselines — Default / Diktyo / Exclusive
#   simulator — event-driven fluid-flow cluster simulator
#   topology  — leaf–spine fabric model (star = paper's Eq. 14 default)
#   trace     — Gavel-style workload generator
#   experiment— declarative Scenario/Policy API + sweep grid runner
#   results   — typed, schema-versioned experiment results (JSON)
from . import (baselines, cluster, contention, controller, events, experiment,
               framework, geometry, results, rotation, scheduler,
               scoring, simulator, topology, trace, workload)

__all__ = [
    "baselines", "cluster", "contention", "controller", "events",
    "experiment", "framework", "geometry", "results", "rotation",
    "scheduler", "scoring", "simulator", "topology", "trace", "workload",
]
