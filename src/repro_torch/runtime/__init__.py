"""Runtime of the port: Metronome's actuators in the loop (``comm_gate``),
the functions that build the train and serving steps and the train state's
sharding specs (``steps``), the straggler monitor (``straggler``) and the
elastic re-mesh (``elastic``)."""
from .steps import (TrainState, auto_microbatches, build_serve_step,
                    build_train_step, make_train_state_specs)
from .comm_gate import CommGate, IterationReporter

__all__ = ["TrainState", "auto_microbatches", "build_serve_step",
           "build_train_step", "make_train_state_specs", "CommGate",
           "IterationReporter"]
