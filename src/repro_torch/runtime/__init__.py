"""Runtime of the port: Metronome's actuators in the loop (``comm_gate``)
and the serving step builders (``steps``)."""
