"""Runtime of the port: Metronome's actuators in the loop (``comm_gate``),
the functions that build the train and serving steps (``steps``) and the
straggler monitor (``straggler``).  The JAX package's
``make_train_state_specs`` takes its sharding specs and comes with them
(ROADMAP A15, A16)."""
from .steps import (TrainState, auto_microbatches, build_serve_step,
                    build_train_step)
from .comm_gate import CommGate, IterationReporter

__all__ = ["TrainState", "auto_microbatches", "build_serve_step",
           "build_train_step", "CommGate", "IterationReporter"]
