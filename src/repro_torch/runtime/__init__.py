"""Runtime of the port: Metronome's actuators in the loop (``comm_gate``),
the functions that build the train and serving steps (``steps``) and the
straggler monitor (``straggler``)."""
