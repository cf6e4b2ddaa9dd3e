"""Experiment configurations of the port (the Metronome testbed)."""
