"""PyTorch/CUDA port of the Metronome scheduling core (``repro`` is the
JAX reference it is held against).

  core     — the scheduling core: geometry, scoring, rotation planner,
             scheduler, controller, fluid engine, event loop, experiments
  kernels  — hand-written Hopper CUDA kernels with plain PyTorch versions
  configs  — the paper's testbed, snapshots and trace scenarios
"""
